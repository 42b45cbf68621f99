// Max-pool units shared by the pool kernels (B3 pool_fused.cu, B8
// delta_pool.cu): a thread reduces whole units of a pixel's channels, 16
// bytes (8 bf16 or 4 f32 channels) where every pixel starts 16-byte
// aligned, else 4 bytes.
#pragma once

#include "cb_common.cuh"

// Elementwise max of two 4-byte words. The max of T values is a T value:
// nothing is rounded.
template <typename T>
__device__ __forceinline__ unsigned word_max(unsigned a, unsigned b);
template <>
__device__ __forceinline__ unsigned word_max<float>(unsigned a, unsigned b) {
  return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
}
template <>
__device__ __forceinline__ unsigned word_max<__nv_bfloat16>(unsigned a,
                                                            unsigned b) {
  __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<unsigned*>(&m);
}

template <typename T>
__device__ __forceinline__ unsigned unit_max(unsigned a, unsigned b) {
  return word_max<T>(a, b);
}
template <typename T>
__device__ __forceinline__ uint4 unit_max(uint4 a, uint4 b) {
  return make_uint4(word_max<T>(a.x, b.x), word_max<T>(a.y, b.y),
                    word_max<T>(a.z, b.z), word_max<T>(a.w, b.w));
}

// Whether a pool over pixels of `pixel_bytes` between buffers `x` and
// `out` takes 16-byte units: every pixel (all offsets are multiples of a
// pixel) then starts 16-byte aligned. Else it takes 4-byte units.
inline bool cb_pool_units16(int pixel_bytes, const void* x, const void* out) {
  return pixel_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// Items (pixel, unit) a thread of a 256-thread block loads before it
// reduces: enough for `items` in one batch, at most 4.
inline int cb_pool_upt(int items) {
  const int per_thread = (items + 255) / 256;
  return per_thread <= 1 ? 1 : per_thread <= 2 ? 2 : 4;
}
