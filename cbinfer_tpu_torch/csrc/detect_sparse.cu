// Sparse change detection (C1+C2 fused) over a producer's dirty 8x8 hint
// tiles.
//
// Replaces cbinfer_tpu/ops/pallas/detect.py::detect_sparse (_sparse_kernel).
// For every hint tile idx[i], i < *count: per pixel, changed iff
// max_c |x - cache| > tau (float32); accept changed pixels into the padded
// storage in place; count them; mark every out tile of THIS layer whose
// receptive field holds a changed pixel.
//
// Bound on the H100: bytes. Each visited tile reads x and the cache once
// and writes at most its changed pixels (3 * 8*8*C * 2 bytes in bf16 at
// most), against no arithmetic to speak of. Design: one block per hint
// tile (the grid is sized to the hint grid; blocks at or past *count, read
// from device memory, exit at once, so the host never learns the count),
// one warp per tile row, lanes walking the channels two at a time so a
// warp reads 128 contiguous bytes per step.
//
// Clamped bottom edge: the last hint row starts at H - 8 when H % 8 != 0,
// so it overlaps the row above, which another block may be updating at the
// same time. Each block therefore touches only the rows it owns
// (y >= 8 * hint_row): cache writes, mask cells and npix. That is exact: a
// pixel outside every dirty tile was not recomputed by the producer, so its
// diff is <= tau and it is never accepted or marked.
#include "cb_common.cuh"

namespace {

struct DetectArgs {
  int H, C, hint_tiles_w;
  long long x_row, s_row;  // elements between rows of x / of the storage
  int slo_h, slo_w;        // interior origin inside the storage
  int tiles_h, tiles_w;    // this layer's out-tile grid
  int step_h, step_w;      // th*sh, tw*sw
  int pad_lo_h, pad_lo_w, win_h, win_w;
};

template <typename T>
__global__ void __launch_bounds__(256)
detect_sparse_kernel(const T* __restrict__ x, T* __restrict__ st,
                     const int* __restrict__ idx,
                     const int* __restrict__ count, float* __restrict__ mask,
                     int* __restrict__ npix, float tau, DetectArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();

  const int t = idx[blockIdx.x];
  const int hi = t / a.hint_tiles_w;
  const int hj = t - hi * a.hint_tiles_w;
  const int oy = min(hi * 8, a.H - 8);
  const int ox = hj * 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int y = oy + warp;  // one tile row per warp
  int local = 0;
  if (y >= hi * 8) {  // own rows only (see the note at the top)
    const T* xr = x + (long long)y * a.x_row + (long long)ox * a.C;
    T* sr = st + (long long)(y + a.slo_h) * a.s_row +
            (long long)(a.slo_w + ox) * a.C;
    for (int px = 0; px < 8; ++px) {
      const T* xp = xr + px * a.C;
      T* sp = sr + px * a.C;
      float m = 0.f;
      for (int c = 2 * lane; c < a.C; c += 64) {
        float2 xv = cb_load2(xp + c);
        float2 cv = cb_load2(sp + c);
        m = fmaxf(m, fmaxf(fabsf(xv.x - cv.x), fabsf(xv.y - cv.y)));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (m > tau) {
        for (int c = 2 * lane; c < a.C; c += 64) cb_copy2(sp + c, xp + c);
        if (lane == 0) {
          ++local;
          int a0, a1, b0, b1;
          cb_window_range(y, a.step_h, a.pad_lo_h, a.win_h, a.tiles_h, &a0,
                          &a1);
          cb_window_range(ox + px, a.step_w, a.pad_lo_w, a.win_w, a.tiles_w,
                          &b0, &b1);
          for (int ta = a0; ta <= a1; ++ta)
            for (int tb = b0; tb <= b1; ++tb)
              mask[ta * a.tiles_w + tb] = 1.f;  // same-value stores
        }
      }
    }
  }
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
  DetectArgs a{H,     C,       hint_tiles_w, x_row,   s_row,
               slo_h, slo_w,   tiles_h,      tiles_w, step_h,
               step_w, pad_lo_h, pad_lo_w,   win_h,   win_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    detect_sparse_kernel<__nv_bfloat16><<<n_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(storage), idx, count, mask, npix, tau, a);
  } else if (dtype == CB_F32) {
    detect_sparse_kernel<float><<<n_blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(storage), idx,
        count, mask, npix, tau, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
