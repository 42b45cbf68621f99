// Sparse delta convolution (C4+C5+C6 fused): gather -> tile GEMM -> scatter.
//
// Replaces cbinfer_tpu/ops/pallas/delta_conv.py::delta_conv_pallas
// (_delta_conv_kernel). For every changed out tile idx[i], i < *count:
// gather the tile's haloed input window from the padded input storage, run
// the kh*kw shifted GEMMs with float32 sums, add the bias, apply ReLU and
// store the tile into the output cache in place. Tiles not listed are never
// touched, so they stay bit-identical.
//
// Bound on the H100: operations. A tile does 2*th*tw*kh*kw*cin*cout FLOPs
// (75.5 MFLOP for 8x8 3x3 256->256) against ~0.2 MB of traffic, far above
// the card's ~295 FLOP/byte balance point, so the sums belong on the tensor
// cores. Design: one block of 256 threads per changed tile (the grid is
// sized to the tile grid; blocks at or past *count exit at once). The block
// stages the haloed window once in dynamic shared memory, each pixel's
// channels padded by 8 elements so that the 8 pixels one MMA fragment row
// set reads fall in 8 different bank groups (10x10x(256+8) bf16 = 52,800 B,
// above the 48 KB static limit, hence the attribute set below).
//
//   bf16: the tile is a (64 pixels) x (cout) x (kh*kw*cin) GEMM on
//   mma.sync.m16n8k16 (bf16 in, float32 sums). Each of the 8 warps owns
//   cout/8 columns (up to 4 n-tiles of 8) and all 4 m-tiles of 16 pixels:
//   A fragments come from the staged window (32-bit shared loads), B
//   fragments straight from the HWIO weights (L2-resident across tiles).
//   Not yet wgmma/TMA: those come with the kernel's tuning.
//
//   float32 (the exact-reference mode): CUDA-core FMAs, each thread owning
//   4 consecutive output channels of 16 tile pixels.
//
// Storage addressing keeps the JAX package's layout: the window of tile
// (ti, tj) starts at storage row ti*th*sh and column tj*tw*sw + dx0 (the
// left margin is 8-aligned, the conv's own padding sits dx0 inside it).
#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 8;  // extra elements per staged pixel (bank spread)

struct ConvArgs {
  int cin, cout, kh, kw, sh, sw, dh, dw, th, tw, win_h, win_w, dx0;
  int tiles_w;
  long long s_row;    // storage row stride, elements
  long long out_row;  // out cache row stride, elements
  int relu, has_bias;
};

// Stage the haloed window of tile (ti, tj) into shared memory, pixel-major
// with a per-pixel stride of cin + kPad elements, 16 bytes at a time (the
// wrapper checks that cin*sizeof(T) is a multiple of 16).
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ st,
                                             T* win, int ti, int tj,
                                             const ConvArgs& a) {
  const long long row0 = (long long)ti * a.th * a.sh;
  const long long col0 = (long long)tj * a.tw * a.sw + a.dx0;
  const int vec = 16 / (int)sizeof(T);
  const int pix_vecs = a.cin / vec;
  const int sp = a.cin + kPad;
  const int total = a.win_h * a.win_w * pix_vecs;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int q = e / pix_vecs;  // window pixel
    int v = e - q * pix_vecs;
    int r = q / a.win_w;
    int c = q - r * a.win_w;
    const T* src = st + (row0 + r) * a.s_row + (col0 + c) * a.cin + v * vec;
    *reinterpret_cast<uint4*>(win + q * sp + v * vec) =
        *reinterpret_cast<const uint4*>(src);
  }
}

__device__ __forceinline__ int tile_pixel_base(int p, int dy, int dx,
                                               const ConvArgs& a) {
  int py = p / a.tw, px = p - (p / a.tw) * a.tw;
  return ((py * a.sh + dy * a.dh) * a.win_w + (px * a.sw + dx * a.dw)) *
         (a.cin + kPad);
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

__global__ void __launch_bounds__(kThreads)
delta_conv_mma_kernel(const __nv_bfloat16* __restrict__ st,
                      const int* __restrict__ idx,
                      const int* __restrict__ count,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, ConvArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int t = idx[blockIdx.x];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  stage_window(st, win, ti, tj, a);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int P = a.th * a.tw;
  const int n_tiles = a.cout / 8;
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
        for (int k0 = 0; k0 < a.cin; k0 += 16) {
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
        }
    }
  }
}

// float32: CUDA-core FMAs, 4 output channels x 16 pixels per thread.
constexpr int kCo = 4;
constexpr int kPix = 16;

__global__ void __launch_bounds__(kThreads)
delta_conv_f32_kernel(const float* __restrict__ st,
                      const int* __restrict__ idx,
                      const int* __restrict__ count,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      ConvArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* win = reinterpret_cast<float*>(smem_raw);
  const int t = idx[blockIdx.x];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  stage_window(st, win, ti, tj, a);
  __syncthreads();

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
      *reinterpret_cast<float4*>(out + (ty0 + py) * a.out_row +
                                 (tx0 + px) * a.cout + co) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The opt-in above 48 KB of dynamic shared memory is a per-kernel
// attribute: one high-water mark per kernel; a launch it would still refuse
// is reported by cudaGetLastError below.
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

extern "C" int cb_delta_conv(
    const void* storage, const int* idx, const int* count, const void* w,
    const float* bias, void* out, int n_blocks, int dtype, int cin, int cout,
    int kh, int kw, int sh, int sw, int dh, int dw, int th, int tw,
    int win_h, int win_w, int dx0, int tiles_w, long long s_row,
    long long out_row, int relu, int has_bias, void* stream) {
  static int hw_mma = 48 * 1024, hw_f32 = 48 * 1024;
  ConvArgs a{cin, cout, kh,    kw,      sh,    sw,      dh,       dw,
             th,  tw,   win_h, win_w,   dx0,   tiles_w, s_row,    out_row,
             relu, has_bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  size_t pix = (size_t)win_h * win_w * (cin + kPad);
  int err;
  if (dtype == CB_BF16) {
    size_t smem = pix * sizeof(__nv_bfloat16);
    if ((err = set_smem(delta_conv_mma_kernel, smem, &hw_mma))) return err;
    delta_conv_mma_kernel<<<n_blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(storage), idx, count,
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<__nv_bfloat16*>(out), a);
  } else if (dtype == CB_F32) {
    size_t smem = pix * sizeof(float);
    if ((err = set_smem(delta_conv_f32_kernel, smem, &hw_f32))) return err;
    delta_conv_f32_kernel<<<n_blocks, kThreads, smem, s>>>(
        static_cast<const float*>(storage), idx, count,
        static_cast<const float*>(w), bias, static_cast<float*>(out), a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
