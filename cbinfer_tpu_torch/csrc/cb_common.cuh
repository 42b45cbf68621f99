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
