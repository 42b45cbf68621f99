// Full-map change detection of the small-cin stem (C1+C2 fused): detect,
// accept, count and the dilated 8x8 cell mask in one pass.
//
// Replaces cbinfer_tpu/ops/pallas/flat4_detect.py::
// detect_accept_flat4_pallas (_kernel). Per pixel of the (H, W, C <= 4)
// float32 frame: changed iff max_c |x - cache| > tau, with x UNROUNDED
// against float32(cache) (rounding x to the cache type first flips
// borderline pixels); changed pixels are stored into the padded HWC stem
// cache rounded to its type; their exact count goes to npix; every 8x8 cell
// whose input window (the layer's 3x3 SAME window: rows [8i - 1, 8i + 9))
// holds a changed pixel is marked. tau < 0 marks every pixel: the sweep
// covers the logical map only, so no margin has to be gated out.
//
// Bound on the H100: bytes, the frame read once (12 bytes a pixel) and the
// cache read once and written where changed (6 bytes a pixel in bf16).
// Design: the TPU kernel needs the 4-lane flat4 layout, masked lane rolls
// and an indicator matmul to dilate; none of that is needed here. One
// thread per pixel, a block per 8 rows x 32 pixels so a warp reads one
// contiguous run of a row; the count is one __syncthreads_count and one
// atomic per block, the dilation a few same-value stores per changed pixel.
#include "cb_common.cuh"

namespace {

struct StemDetectArgs {
  int H, W, C;
  long long s_row;   // elements between rows of the storage
  int slo_h, slo_w;  // interior origin inside the storage
  CbTileGrid grid;   // the 8x8 cell grid and its input window
};

template <typename T>
__global__ void __launch_bounds__(256)
stem_detect_kernel(const float* __restrict__ x, T* __restrict__ st,
                   float* __restrict__ mask, int* __restrict__ npix,
                   float tau, StemDetectArgs a) {
  const int c = blockIdx.x * 32 + (threadIdx.x & 31);
  const int r = blockIdx.y * 8 + (threadIdx.x >> 5);
  bool changed = false;
  if (r < a.H && c < a.W) {
    const float* xp = x + ((long long)r * a.W + c) * a.C;
    T* sp = st + (long long)(r + a.slo_h) * a.s_row +
            (long long)(c + a.slo_w) * a.C;
    float m = 0.f;
    for (int ch = 0; ch < a.C; ++ch)
      m = fmaxf(m, fabsf(xp[ch] - cb_to_float(sp[ch])));
    changed = m > tau;
    if (changed) {
      for (int ch = 0; ch < a.C; ++ch) sp[ch] = cb_round<T>(xp[ch]);
      cb_mark_tiles(mask, a.grid, r, c);
    }
  }
  const int n = __syncthreads_count(changed);
  if (threadIdx.x == 0 && n) atomicAdd(npix, n);
}

}  // namespace

extern "C" int cb_stem_detect(const float* x, void* storage, float* mask,
                              int* npix, float tau, int dtype, int H, int W,
                              int C, long long s_row, int slo_h, int slo_w,
                              int cells_h, int cells_w, int step_h,
                              int step_w, int pad_lo_h, int pad_lo_w,
                              int win_h, int win_w, void* stream) {
  StemDetectArgs a{H,     W,     C,
                   s_row, slo_h, slo_w,
                   {cells_h, cells_w, step_h, step_w, pad_lo_h, pad_lo_w,
                    win_h, win_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  if (dtype == CB_BF16) {
    stem_detect_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        x, static_cast<__nv_bfloat16*>(storage), mask, npix, tau, a);
  } else if (dtype == CB_F32) {
    stem_detect_kernel<float><<<grid, 256, 0, s>>>(
        x, static_cast<float*>(storage), mask, npix, tau, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
