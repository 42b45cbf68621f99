// Sparse change detection (C1+C2 fused) over a producer's dirty 8x8 hint
// tiles.
//
// Replaces cbinfer_tpu/ops/pallas/detect.py::detect_sparse (_sparse_kernel).
// For every hint tile idx[i], i < *count: per pixel, changed iff
// max_c |x - cache| > tau (float32); accept changed pixels into the padded
// storage in place; count them; mark every out tile of THIS layer whose
// receptive field holds a changed pixel. The layer may be a conv or a pool:
// the dilation takes the layer's stride, padding and window as given.
//
// Bound on the H100: bytes. Each visited tile reads x and the cache once
// and writes at most its changed pixels (3 * 8*8*C * 2 bytes in bf16 at
// most), against no arithmetic to speak of. Design: one block per hint
// tile (the grid is sized to the hint grid; blocks at or past *count, read
// from device memory, exit at once, so the host never learns the count),
// one warp per tile row, lanes walking the channels two at a time so a
// warp reads 128 contiguous bytes per step (cb_detect.cuh).
//
// Clamped bottom edge: the last hint row starts at H - 8 when H % 8 != 0,
// so it overlaps the row above, which another block may be updating at the
// same time. Each block therefore touches only the rows it owns
// (y >= 8 * hint_row): cache writes, mask cells and npix. That is exact: a
// pixel outside every dirty tile was not recomputed by the producer, so its
// diff is <= tau and it is never accepted or marked.
#include "cb_detect.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
detect_sparse_kernel(const T* __restrict__ x, T* __restrict__ st,
                     const int* __restrict__ idx,
                     const int* __restrict__ count, float* __restrict__ mask,
                     int* __restrict__ npix, float tau, int hint_tiles_w,
                     CbDetectArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();

  const int t = idx[blockIdx.x];
  const int hi = t / hint_tiles_w;
  const int hj = t - hi * hint_tiles_w;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int y = min(hi * 8, a.H - 8) + warp;  // one tile row per warp
  int local = 0;
  if (y >= hi * 8)  // own rows only (see the note at the top)
    local = cb_detect_row(x, st, mask, tau, a, y, hj * 8, 8, lane);
  if (lane == 0 && local) atomicAdd(&s_n, local);
  __syncthreads();
  if (threadIdx.x == 0 && s_n) atomicAdd(npix, s_n);
}

}  // namespace

extern "C" int cb_detect_sparse(
    const void* x, void* storage, const int* idx, const int* count,
    float* mask, int* npix, int n_blocks, float tau, int dtype, int H, int C,
    int hint_tiles_w, long long x_row, long long s_row, int slo_h, int slo_w,
    int tiles_h, int tiles_w, int step_h, int step_w, int pad_lo_h,
    int pad_lo_w, int win_h, int win_w, void* stream) {
  CbDetectArgs a{H,     C,     x_row,
                 s_row, slo_h, slo_w,
                 {tiles_h, tiles_w, step_h, step_w, pad_lo_h, pad_lo_w, win_h,
                  win_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    detect_sparse_kernel<__nv_bfloat16><<<n_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(storage), idx, count, mask, npix, tau,
        hint_tiles_w, a);
  } else if (dtype == CB_F32) {
    detect_sparse_kernel<float><<<n_blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(storage), idx,
        count, mask, npix, tau, hint_tiles_w, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
