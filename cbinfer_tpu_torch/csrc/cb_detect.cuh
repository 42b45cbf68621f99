// The per-pixel detect + accept + dilate step over an HWC map of the fused
// conv + consumer detect, whose x is its own out tile in shared memory; the
// arguments of the detect kernels (CbDetectArgs); and the comparison of one
// 4- or 16-byte load unit, shared by the sparse and the full-map detect
// kernels (detect_sparse.cu, detect_full.cu), which keep their own row
// routines.
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

// max |a - b| over the elements of one 4-byte word, in float32
template <typename T>
__device__ __forceinline__ float cb_word_absdiff(unsigned a, unsigned b);
template <>
__device__ __forceinline__ float cb_word_absdiff<float>(unsigned a,
                                                        unsigned b) {
  return fabsf(__uint_as_float(a) - __uint_as_float(b));
}
template <>
__device__ __forceinline__ float cb_word_absdiff<__nv_bfloat16>(unsigned a,
                                                                unsigned b) {
  const float2 fa = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&b));
  return fmaxf(fabsf(fa.x - fb.x), fabsf(fa.y - fb.y));
}

// ... and over one load unit (4 or 16 bytes)
template <typename T>
__device__ __forceinline__ float cb_unit_absdiff(unsigned a, unsigned b) {
  return cb_word_absdiff<T>(a, b);
}
template <typename T>
__device__ __forceinline__ float cb_unit_absdiff(uint4 a, uint4 b) {
  return fmaxf(
      fmaxf(cb_word_absdiff<T>(a.x, b.x), cb_word_absdiff<T>(a.y, b.y)),
      fmaxf(cb_word_absdiff<T>(a.z, b.z), cb_word_absdiff<T>(a.w, b.w)));
}
