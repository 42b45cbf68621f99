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
// cores. But a launch lists tens to hundreds of tiles, so what holds a
// block back is latency: one block per tile would fill 23-29 of the 132
// SMs on a 90-row map. Design (cb_conv.cuh): the tile's cout is split over
// a thread-block cluster, one block per slice of n_blk channels, so a
// launch runs tiles x csize blocks; each block stages the window with bulk
// copies, streams its weight slice through a shared-memory ring (packed
// once per weight tensor by ops/conv_plan.py) and runs wgmma with A from
// registers. The grid is sized to the listed capacity; clusters at or past
// *count exit at once.
//
// Split plan at 720p (ops/conv_plan.py; n_blk x csize):
//   scene w128: 3x3 128->256 (360 rows) and 256->256 (x2, 180 rows) 64 x 4
//   pose w64: 64->64 (720 rows) 64 x 1; 64->128, 128->128 (360) 32 x 4;
//     128->256, 256->256 (180) 64 x 4; 256->512 (90) 64 x 8; 512->256,
//     256->256, 56->256 and the 1x1 256->256 (90) 64 x 4; 256->128,
//     128->128 and the 1x1 128->128 (90) 32 x 4; the 1x1 ->56 (90) 64 x 1
//     (8 zero channels, not stored).
#include "cb_conv.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(kWgThreads)
delta_conv_wg_kernel(const __nv_bfloat16* __restrict__ st,
                     const int* __restrict__ idx,
                     const int* __restrict__ count,
                     const __nv_bfloat16* __restrict__ wp,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, ConvArgs a, WgPlan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WgShared& sh = *reinterpret_cast<WgShared*>(smem_raw);
  int rank;
  const int i = wg_begin(count, pl, sh, &rank);
  if (i < 0) return;
  const int t = idx[i];
  const int ti = t / a.tiles_w;
  conv_tile_wg<N, false>(st, wp, bias, out, ti, t - ti * a.tiles_w, rank, a,
                         pl, sh, nullptr, NextArgs{});
}

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
  conv_tile_f32(win, w, bias, out, ti, tj, a, nullptr, 0);
}

}  // namespace

// bf16: ``w`` is the packed weights and (n_blk, csize, slices, steps,
// stages, smem) the wrapper's plan (ops/conv_plan.py); float32: ``w`` is
// HWIO and the plan is not read.
extern "C" int cb_delta_conv(
    const void* storage, const int* idx, const int* count, const void* w,
    const float* bias, void* out, int n_blocks, int dtype, int cin, int cout,
    int kh, int kw, int sh, int sw, int dh, int dw, int th, int tw,
    int win_h, int win_w, int dx0, int tiles_w, long long s_row,
    long long out_row, int relu, int has_bias, int n_blk, int csize,
    int slices, int steps, int stages, int smem, void* stream) {
  static SmemMarks hw_f32;
  ConvArgs a{cin, cout,  kh,    kw,  sh,      sw,
             dh,  dw,    th,    tw,  win_h,   win_w,
             dx0, tiles_w, conv_pixel_stride(cin), s_row, out_row,
             relu, has_bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    static SmemMarks hw[3];
    const WgPlan pl{slices, csize, steps, stages};
    const auto* st = static_cast<const __nv_bfloat16*>(storage);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    auto* o = static_cast<__nv_bfloat16*>(out);
    switch (n_blk) {
      case 16:
        return launch_wg(delta_conv_wg_kernel<16>, n_blocks, pl, smem, &hw[0],
                         s, st, idx, count, wp, bias, o, a, pl);
      case 32:
        return launch_wg(delta_conv_wg_kernel<32>, n_blocks, pl, smem, &hw[1],
                         s, st, idx, count, wp, bias, o, a, pl);
      case 64:
        return launch_wg(delta_conv_wg_kernel<64>, n_blocks, pl, smem, &hw[2],
                         s, st, idx, count, wp, bias, o, a, pl);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != CB_F32) return (int)cudaErrorInvalidValue;
  size_t bytes = (size_t)win_h * win_w * a.sp * sizeof(float);
  int err;
  if ((err = set_smem(delta_conv_f32_kernel, bytes, &hw_f32))) return err;
  delta_conv_f32_kernel<<<n_blocks, kThreads, bytes, s>>>(
      static_cast<const float*>(storage), idx, count,
      static_cast<const float*>(w), bias, static_cast<float*>(out), a);
  return (int)cudaGetLastError();
}
