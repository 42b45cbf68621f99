// The per-pixel detect + accept + dilate step over an HWC map, shared by the
// full-map detect kernel and by the fused conv + consumer detect, whose x is
// its own out tile in shared memory. The sparse detect kernel keeps its own
// row routine (detect_sparse.cu) and shares CbDetectArgs.
#pragma once

#include "cb_common.cuh"

struct CbDetectArgs {
  int H, C;
  long long x_row, s_row;  // elements between rows of x / of the storage
  int slo_h, slo_w;        // interior origin inside the storage
  CbTileGrid grid;         // this layer's out-tile grid
};

// One warp walks n pixels of one map row, lanes over the C channels two at
// a time (a warp reads 128 contiguous bytes per step): xr points at the
// first pixel of x (x_pix elements between pixels), sr at the first pixel
// of the storage (C elements between pixels), (y, x0) are the first pixel's
// map coordinates. A pixel changed iff max_c |x - cache| > tau in float32;
// it is then accepted into the storage in place and the out tiles of
// ``grid`` whose window holds it are marked. Returns the number of changed
// pixels (the same value on every lane).
template <typename T>
__device__ __forceinline__ int cb_detect_pixels(const T* xr, int x_pix,
                                                T* __restrict__ sr, int C,
                                                float* __restrict__ mask,
                                                float tau,
                                                const CbTileGrid& grid, int y,
                                                int x0, int n, int lane) {
  int local = 0;
  for (int px = 0; px < n; ++px) {
    const T* xp = xr + px * x_pix;
    T* sp = sr + px * C;
    float m = 0.f;
    for (int c = 2 * lane; c < C; c += 64) {
      float2 xv = cb_load2(xp + c);
      float2 cv = cb_load2(sp + c);
      m = fmaxf(m, fmaxf(fabsf(xv.x - cv.x), fabsf(xv.y - cv.y)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (m > tau) {
      for (int c = 2 * lane; c < C; c += 64) cb_copy2(sp + c, xp + c);
      ++local;
      if (lane == 0) cb_mark_tiles(mask, grid, y, x0 + px);
    }
  }
  return local;
}

// Pixels [x0, x0 + n) of row y of an HWC map x against the interior of the
// padded storage st.
template <typename T>
__device__ __forceinline__ int cb_detect_row(const T* __restrict__ x,
                                             T* __restrict__ st,
                                             float* __restrict__ mask,
                                             float tau, const CbDetectArgs& a,
                                             int y, int x0, int n, int lane) {
  const T* xr = x + (long long)y * a.x_row + (long long)x0 * a.C;
  T* sr = st + (long long)(y + a.slo_h) * a.s_row +
          (long long)(a.slo_w + x0) * a.C;
  return cb_detect_pixels(xr, a.C, sr, a.C, mask, tau, a.grid, y, x0, n, lane);
}
