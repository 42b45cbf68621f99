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
// The tile body (staging, mma.sync GEMM for bf16, FMAs for float32, the
// epilogue) is cb_conv.cuh, shared with the fused conv + consumer detect.
// Not yet wgmma/TMA: those come with the kernel's tuning.
#include "cb_conv.cuh"

namespace {

template <bool kTail>
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
  conv_tile_mma<kTail>(win, w, bias, out, ti, tj, a, nullptr, 0);
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

extern "C" int cb_delta_conv(
    const void* storage, const int* idx, const int* count, const void* w,
    const float* bias, void* out, int n_blocks, int dtype, int cin, int cout,
    int kh, int kw, int sh, int sw, int dh, int dw, int th, int tw,
    int win_h, int win_w, int dx0, int tiles_w, long long s_row,
    long long out_row, int relu, int has_bias, void* stream) {
  static int hw_mma = 48 * 1024, hw_tail = 48 * 1024, hw_f32 = 48 * 1024;
  ConvArgs a{cin, cout,  kh,    kw,  sh,      sw,
             dh,  dw,    th,    tw,  win_h,   win_w,
             dx0, tiles_w, conv_pixel_stride(cin), s_row, out_row,
             relu, has_bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  size_t pix = (size_t)win_h * win_w * a.sp;
  int err;
  if (dtype == CB_BF16) {
    size_t smem = pix * sizeof(__nv_bfloat16);
    // a cin off the MMA's 16-channel k-step has its own instantiation,
    // so the common one carries no tail code
    auto kernel = cin % 16 ? delta_conv_mma_kernel<true>
                           : delta_conv_mma_kernel<false>;
    if ((err = set_smem(kernel, smem, cin % 16 ? &hw_tail : &hw_mma)))
      return err;
    kernel<<<n_blocks, kThreads, smem, s>>>(
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
