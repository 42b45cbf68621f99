// Shared helpers of the port's CUDA kernels (built with nvcc into one
// shared library per .cu file, bound to Python through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
#define CB_F32 0
#define CB_BF16 1

// Programmatic dependent launch (sm_90). A kernel launched by
// cb_launch_after_fill may start while the kernel just before it in the
// stream (its wrapper's zero-fill of the outputs) is still finishing, so
// its launch and first loads overlap the fill. It may read anything and
// write what the fill does not touch at once, but calls cb_wait_prior_grid
// before it writes into the filled buffer, and once before it exits so
// that its completion implies the fill's. Everything earlier in the stream
// is complete: the fill itself started only after it.
__device__ __forceinline__ void cb_wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... KArgs, typename... Args>
cudaError_t cb_launch_after_fill(void (*kernel)(KArgs...), int grid,
                                 int block, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Two adjacent channels as float2, whatever the storage type.
__device__ __forceinline__ float2 cb_load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 cb_load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void cb_store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void cb_store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// One element as float, and a float rounded to the storage type (round to
// nearest even, as PyTorch's and XLA's casts do).
__device__ __forceinline__ float cb_to_float(float v) { return v; }
__device__ __forceinline__ float cb_to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T cb_round(float v);
template <>
__device__ __forceinline__ float cb_round<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cb_round<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Raw copy of two adjacent elements (no rounding).
template <typename T>
__device__ __forceinline__ void cb_copy2(T* dst, const T* src) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "2- or 4-byte types");
  if (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

// First index a in [0, n) of the out-tile interval whose input window
// [a*step - pad_lo, a*step - pad_lo + win) contains coordinate r, and the
// last one; empty when lo > hi.
__device__ __forceinline__ void cb_window_range(int r, int step, int pad_lo,
                                                int win, int n, int* lo,
                                                int* hi) {
  int v = r + pad_lo - win + 1;
  *lo = v <= 0 ? 0 : (v + step - 1) / step;
  int h = (r + pad_lo) / step;
  *hi = h < n - 1 ? h : n - 1;
}

// Geometry of a layer's out-tile grid as the detect kernels need it: out
// tile (a, b) reads input rows [a*step_h - pad_lo_h, +win_h) and columns
// [b*step_w - pad_lo_w, +win_w).
struct CbTileGrid {
  int tiles_h, tiles_w;
  int step_h, step_w;  // th*sh, tw*sw
  int pad_lo_h, pad_lo_w, win_h, win_w;
};

// Mark every out tile whose input window holds pixel (r, c). Plain
// same-value stores: blocks race only to write the same 1.0.
__device__ __forceinline__ void cb_mark_tiles(float* __restrict__ mask,
                                              const CbTileGrid& t, int r,
                                              int c) {
  int a0, a1, b0, b1;
  cb_window_range(r, t.step_h, t.pad_lo_h, t.win_h, t.tiles_h, &a0, &a1);
  cb_window_range(c, t.step_w, t.pad_lo_w, t.win_w, t.tiles_w, &b0, &b1);
  for (int a = a0; a <= a1; ++a)
    for (int b = b0; b <= b1; ++b) mask[a * t.tiles_w + b] = 1.f;
}
