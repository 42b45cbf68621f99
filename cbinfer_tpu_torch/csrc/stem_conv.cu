// Sparse 3x3 stem convolution (cin <= 3) over the changed (8, 32) stem
// tiles: gather, conv, bias, ReLU, scatter (C4-C6 for the small-cin stem).
//
// Replaces cbinfer_tpu/ops/pallas/patch_stem.py::patch_stem_conv
// (_patch_stem_kernel, pack_patch_weights). For every stem tile idx[i],
// i < *count: the 3x3 stride-1 SAME conv of the accepted stem cache (the
// padded HWC storage; its zero margins are the padding), K = 9 * cin taps
// in (dy, dx, c) order, products of compute-type values summed in float32,
// the bias rounded through the compute type first (as the weights are),
// ReLU, and the (8, 32, cout) tile written into the out cache in place.
// Tiles not listed are never touched.
//
// Overflow without a host branch: when *count > capacity the list is cut
// short, and the reference switches to a dense conv of the whole map under
// lax.cond. Here block i then computes tile i for every i of the grid
// (which is sized to the tile grid). The reference's dense branch is
// bit-identical to its kernel, so this changes no value.
//
// Bound on the H100: bytes at the stem density of a static-camera clip (a
// tile reads a 10 x 34 x cin window, 2 KB, and writes 8*32*cout values,
// 64 KB at cout 128 in bf16, for 0.9 MFLOP), on the CUDA cores: K <= 27 is
// too shallow for the tensor cores to pay. Design: one block per tile; the
// window is staged in shared memory as float32 (scalar loads: a 6-byte
// pixel has no aligned vector form, and the window is small); a thread owns
// two adjacent output channels, keeps their 2*K weights in registers, and
// walks the tile's pixels, so a warp reads one window value by broadcast
// and writes 128 contiguous bytes per pixel. The TPU kernel's selection
// matmuls and block-diagonal weights are Mosaic devices and are not kept.
#include "cb_common.cuh"

namespace {

constexpr int TH = 8, TW = 32;            // stem tile, output pixels
constexpr int WH = TH + 2, WW = TW + 2;   // its input window
constexpr int THREADS = 256;

struct StemConvArgs {
  int cout, tiles_w, capacity, dx0, relu;
  long long s_row, out_row;  // row strides, elements
};

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
stem_conv_kernel(const T* __restrict__ st, const int* __restrict__ idx,
                 const int* __restrict__ count, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 StemConvArgs a) {
  constexpr int K = 9 * C;
  const int n = __ldg(count);
  int t = blockIdx.x;
  if (n <= a.capacity) {  // else overflow: every tile, block i takes tile i
    if (t >= n) return;
    t = idx[t];
  }
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;

  __shared__ float s_win[WH * WW * C];
  const T* src = st + (long long)(ti * TH) * a.s_row +
                 (long long)(tj * TW + a.dx0) * C;
  for (int e = threadIdx.x; e < WH * WW * C; e += THREADS) {
    const int row = e / (WW * C);
    s_win[e] = cb_to_float(src[row * a.s_row + (e - row * (WW * C))]);
  }

  const int cpairs = a.cout / 2;  // divides THREADS (checked by the caller)
  const int c0 = 2 * (threadIdx.x % cpairs);
  const int pg = threadIdx.x / cpairs;
  const int npg = THREADS / cpairs;
  float2 wr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wr[k] = cb_load2(w + k * a.cout + c0);
  float2 bv = make_float2(0.f, 0.f);
  if (bias != nullptr) {
    bv.x = cb_to_float(cb_round<T>(bias[c0]));
    bv.y = cb_to_float(cb_round<T>(bias[c0 + 1]));
  }
  __syncthreads();

  T* dst = out + (long long)(ti * TH) * a.out_row +
           (long long)(tj * TW) * a.cout + c0;
  for (int p = pg; p < TH * TW; p += npg) {
    const int py = p / TW;
    const int px = p - py * TW;
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = s_win + ((py + dy) * WW + px) * C;
#pragma unroll
      for (int q = 0; q < 3 * C; ++q) {  // (dx, c) are contiguous in a row
        const float v = row[q];
        ax = fmaf(v, wr[dy * 3 * C + q].x, ax);
        ay = fmaf(v, wr[dy * 3 * C + q].y, ay);
      }
    }
    ax += bv.x;
    ay += bv.y;
    if (a.relu) {
      ax = fmaxf(ax, 0.f);
      ay = fmaxf(ay, 0.f);
    }
    cb_store2(dst + (long long)py * a.out_row + px * a.cout,
              make_float2(ax, ay));
  }
}

template <typename T>
int launch(const void* st, const int* idx, const int* count, const void* w,
           const float* bias, void* out, int n_blocks, int cin,
           StemConvArgs a, cudaStream_t s) {
  const T* st_ = static_cast<const T*>(st);
  const T* w_ = static_cast<const T*>(w);
  T* out_ = static_cast<T*>(out);
  switch (cin) {
    case 1:
      stem_conv_kernel<T, 1><<<n_blocks, THREADS, 0, s>>>(st_, idx, count, w_,
                                                          bias, out_, a);
      break;
    case 2:
      stem_conv_kernel<T, 2><<<n_blocks, THREADS, 0, s>>>(st_, idx, count, w_,
                                                          bias, out_, a);
      break;
    case 3:
      stem_conv_kernel<T, 3><<<n_blocks, THREADS, 0, s>>>(st_, idx, count, w_,
                                                          bias, out_, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cb_stem_conv(const void* storage, const int* idx,
                            const int* count, const void* w,
                            const float* bias, void* out, int n_blocks,
                            int dtype, int cin, int cout, int tiles_w,
                            int capacity, int dx0, int relu, long long s_row,
                            long long out_row, void* stream) {
  StemConvArgs a{cout, tiles_w, capacity, dx0, relu, s_row, out_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (cout < 2 || cout % 2 || THREADS % (cout / 2))
    return (int)cudaErrorInvalidValue;
  if (dtype == CB_BF16)
    return launch<__nv_bfloat16>(storage, idx, count, w, bias, out, n_blocks,
                                 cin, a, s);
  if (dtype == CB_F32)
    return launch<float>(storage, idx, count, w, bias, out, n_blocks, cin, a,
                         s);
  return (int)cudaErrorInvalidValue;
}
