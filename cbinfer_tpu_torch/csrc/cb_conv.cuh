// The tile convolution shared by the sparse delta conv (delta_conv.cu) and
// the fused delta conv + consumer detect (delta_conv_detect.cu): stage the
// haloed input window of one out tile in shared memory, run the kh*kw
// shifted GEMMs with float32 sums, add the bias, apply ReLU and store the
// tile into the output cache. With a non-null ``ytile`` the rounded tile is
// ALSO kept in shared memory (pixel-major, ``ys`` elements per pixel) for an
// epilogue that needs every channel of a pixel in one place.
//
//   bf16: the tile is a (64 pixels) x (cout) x (kh*kw*cin) GEMM on
//   mma.sync.m16n8k16 (bf16 in, float32 sums). Each of the 8 warps owns
//   cout/8 columns (up to 4 n-tiles of 8 per pass) and all 4 m-tiles of 16
//   pixels: A fragments come from the staged window (32-bit shared loads),
//   B fragments straight from the HWIO weights (L2-resident across tiles).
//   cin may be any multiple of 8: with kTail a last k-step of 8 channels
//   runs with the upper half of both fragments zero. The k-loop is written
//   out in the function body: passed through a helper function the same
//   code ran 36% slower (nvcc 12.8 then interleaves the weight loads with
//   the MMAs instead of batching them ahead).
//
//   float32 (the exact-reference mode): CUDA-core FMAs, each thread owning
//   4 consecutive output channels of 16 tile pixels.
//
// Storage addressing keeps the JAX package's layout: the window of tile
// (ti, tj) starts at storage row ti*th*sh and column tj*tw*sw + dx0 (the
// left margin is 8-aligned, the conv's own padding sits dx0 inside it).
#pragma once

#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;

struct ConvArgs {
  int cin, cout, kh, kw, sh, sw, dh, dw, th, tw, win_h, win_w, dx0;
  int tiles_w;
  int sp;             // staged elements per window pixel (cin + bank spread)
  long long s_row;    // storage row stride, elements
  long long out_row;  // out cache row stride, elements
  int relu, has_bias;
};

// Staged elements per window pixel: the channels plus 8 (16 for a cin off
// the 16-channel grid), so that the 8 pixels one MMA fragment row set reads
// fall in different bank groups (10x10x(256+8) bf16 = 52,800 B, above the
// 48 KB static limit, hence the opt-in attribute set by set_smem below).
inline int conv_pixel_stride(int cin) { return cin + (cin % 16 ? 16 : 8); }

// Stage the haloed window of tile (ti, tj) into shared memory, pixel-major,
// 16 bytes at a time (the wrapper checks that cin*sizeof(T) is a multiple
// of 16).
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ st,
                                             T* win, int ti, int tj,
                                             const ConvArgs& a) {
  const long long row0 = (long long)ti * a.th * a.sh;
  const long long col0 = (long long)tj * a.tw * a.sw + a.dx0;
  const int vec = 16 / (int)sizeof(T);
  const int pix_vecs = a.cin / vec;
  const int total = a.win_h * a.win_w * pix_vecs;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int q = e / pix_vecs;  // window pixel
    int v = e - q * pix_vecs;
    int r = q / a.win_w;
    int c = q - r * a.win_w;
    const T* src = st + (row0 + r) * a.s_row + (col0 + c) * a.cin + v * vec;
    *reinterpret_cast<uint4*>(win + q * a.sp + v * vec) =
        *reinterpret_cast<const uint4*>(src);
  }
}

__device__ __forceinline__ int tile_pixel_base(int p, int dy, int dx,
                                               const ConvArgs& a) {
  int py = p / a.tw, px = p - (p / a.tw) * a.tw;
  return ((py * a.sh + dy * a.dh) * a.win_w + (px * a.sw + dx * a.dw)) * a.sp;
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 weights of one output channel at consecutive input channels,
// packed low-first as an MMA B-fragment register.
__device__ __forceinline__ uint32_t load_w_pair(const __nv_bfloat16* p,
                                                int cout) {
  uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  uint32_t hi = *reinterpret_cast<const unsigned short*>(p + cout);
  return lo | (hi << 16);
}

constexpr int kMT = 4;  // m-tiles of 16 pixels (a 64-pixel tile)
constexpr int kNT = 4;  // n-tiles of 8 channels per warp per pass

// The bf16 tile conv from the staged window ``win`` (call after the
// barrier that follows stage_window). kTail: cin % 16 == 8.
template <bool kTail>
__device__ __forceinline__ void conv_tile_mma(
    const __nv_bfloat16* win, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* out, int ti, int tj,
    const ConvArgs& a, __nv_bfloat16* ytile, int ys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int P = a.th * a.tw;
  const int n_tiles = a.cout / 8;
  const int k_full = a.cin & ~15;
  // pixels of this thread's fragment rows: 16*mt + g and 16*mt + g + 8
  int prow[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int p = mt * 16 + g + 8 * h;
      prow[mt][h] = p < P ? p : 0;  // rows past the tile: junk, unstored
    }

  for (int nt0 = warp; nt0 < n_tiles; nt0 += 8 * kNT) {
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

    for (int dy = 0; dy < a.kh; ++dy) {
      for (int dx = 0; dx < a.kw; ++dx) {
        int base[kMT][2];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            base[mt][h] = tile_pixel_base(prow[mt][h], dy, dx, a) + 2 * q;
        const __nv_bfloat16* wt =
            w + (long long)((dy * a.kw + dx) * a.cin) * a.cout;
#pragma unroll 2
        for (int k0 = 0; k0 < k_full; k0 += 16) {
          uint32_t bf[kNT][2];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            int nt = nt0 + j * 8;
            int co = (nt < n_tiles ? nt : 0) * 8 + g;
            const __nv_bfloat16* wp =
                wt + (long long)(k0 + 2 * q) * a.cout + co;
            bf[j][0] = load_w_pair(wp, a.cout);
            bf[j][1] = load_w_pair(wp + 8LL * a.cout, a.cout);
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(win + base[mt][0] + k0);
            af[1] = *reinterpret_cast<const uint32_t*>(win + base[mt][1] + k0);
            af[2] =
                *reinterpret_cast<const uint32_t*>(win + base[mt][0] + k0 + 8);
            af[3] =
                *reinterpret_cast<const uint32_t*>(win + base[mt][1] + k0 + 8);
#pragma unroll
            for (int j = 0; j < kNT; ++j) mma_bf16_16816(acc[mt][j], af, bf[j]);
          }
        }
        if constexpr (kTail) {
          // the last 8 channels of a cin off the 16-channel grid: the
          // upper halves of the A and the B fragments are zero, and
          // nothing past cin is read
          uint32_t bf[kNT][2];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            int nt = nt0 + j * 8;
            int co = (nt < n_tiles ? nt : 0) * 8 + g;
            bf[j][0] = load_w_pair(
                wt + (long long)(k_full + 2 * q) * a.cout + co, a.cout);
            bf[j][1] = 0u;
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t af[4];
            af[0] = *reinterpret_cast<const uint32_t*>(win + base[mt][0] +
                                                       k_full);
            af[1] = *reinterpret_cast<const uint32_t*>(win + base[mt][1] +
                                                       k_full);
            af[2] = af[3] = 0u;
#pragma unroll
            for (int j = 0; j < kNT; ++j) mma_bf16_16816(acc[mt][j], af, bf[j]);
          }
        }
      }
    }

    // epilogue: bias, ReLU, bf16, scatter into the out cache
    const long long ty0 = (long long)ti * a.th;
    const long long tx0 = (long long)tj * a.tw;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      int nt = nt0 + j * 8;
      if (nt >= n_tiles) break;
      int co = nt * 8 + 2 * q;
      float b0 = a.has_bias ? bias[co] : 0.f;
      float b1 = a.has_bias ? bias[co + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int p = mt * 16 + g + 8 * h;
          if (p >= P) continue;
          int py = p / a.tw, px = p - (p / a.tw) * a.tw;
          float v0 = acc[mt][j][2 * h] + b0;
          float v1 = acc[mt][j][2 * h + 1] + b1;
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          cb_store2(out + (ty0 + py) * a.out_row + (tx0 + px) * a.cout + co,
                    make_float2(v0, v1));
          if (ytile) cb_store2(ytile + p * ys + co, make_float2(v0, v1));
        }
    }
  }
}

// float32: CUDA-core FMAs, 4 output channels x 16 pixels per thread.
constexpr int kCo = 4;
constexpr int kPix = 16;

__device__ __forceinline__ void conv_tile_f32(
    const float* win, const float* __restrict__ w,
    const float* __restrict__ bias, float* out, int ti, int tj,
    const ConvArgs& a, float* ytile, int ys) {
  const int P = a.th * a.tw;
  const int cg = threadIdx.x % 64;  // output-channel group
  const int pg = threadIdx.x / 64;  // pixel group
  for (int co_base = 0; co_base < a.cout; co_base += 64 * kCo) {
    const int co = co_base + cg * kCo;
    if (co >= a.cout) continue;  // no barrier below: idle threads may skip
    float acc[kPix][kCo];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int j = 0; j < kCo; ++j) acc[i][j] = 0.f;
    for (int dy = 0; dy < a.kh; ++dy) {
      for (int dx = 0; dx < a.kw; ++dx) {
        int base[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          int p = pg * kPix + i;
          base[i] = tile_pixel_base(p < P ? p : 0, dy, dx, a);
        }
        const float* wt = w + (long long)((dy * a.kw + dx) * a.cin) * a.cout + co;
        for (int ci = 0; ci < a.cin; ++ci) {
          float4 wv = *reinterpret_cast<const float4*>(wt + (long long)ci * a.cout);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float xv = win[base[i] + ci];
            acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
          }
        }
      }
    }
    const long long ty0 = (long long)ti * a.th;
    const long long tx0 = (long long)tj * a.tw;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      int p = pg * kPix + i;
      if (p >= P) break;
      int py = p / a.tw, px = p - (p / a.tw) * a.tw;
      float v[kCo];
#pragma unroll
      for (int j = 0; j < kCo; ++j) {
        v[j] = acc[i][j] + (a.has_bias ? bias[co + j] : 0.f);
        if (a.relu) v[j] = fmaxf(v[j], 0.f);
      }
      const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + (ty0 + py) * a.out_row +
                                 (tx0 + px) * a.cout + co) = v4;
      if (ytile) *reinterpret_cast<float4*>(ytile + p * ys + co) = v4;
    }
  }
}

// The opt-in above 48 KB of dynamic shared memory is a per-kernel
// attribute: one high-water mark per kernel; a launch it would still refuse
// is reported by cudaGetLastError after the launch.
template <typename K>
int set_smem(K kernel, size_t smem, int* high_water) {
  if ((int)smem <= *high_water) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *high_water = (int)smem;
  return 0;
}

}  // namespace
