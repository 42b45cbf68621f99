// Stream compaction of a tile mask ("compact").
//
// Replaces the sort of cbinfer_tpu/ops/compact.py::compact_mask. The JAX
// package sorts because XLA's scatter serialises on a TPU; the original
// CBinfer compacts with a prefix sum, and so does this kernel. Its result
// is the sort's, bit for bit: the flat (row-major) ids of the set flags in
// ascending order, the first `cap` of them, then the sentinel n to the end
// of idx, and the true number of set flags in *count (which may exceed
// cap).
//
// Bound on the H100: latency. A mask of the paths holds 920-7,200 flags
// (about 32,400 at a 1080p stem): a few KB in, up to 29 KB of ids out. What
// a call costs is its launch, one round trip for the flags and one block's
// scan. Design:
// - one block of 1,024 threads and one launch; no look-back across blocks,
//   no atomics, no scratch in device memory;
// - a thread takes 16 consecutive flags, as one 16-byte load where the
//   mask is contiguous and 16-byte aligned (the wrapper says so), else one
//   byte at a time through the view's strides (a ragged tail, a strided
//   view), and packs them into a 16-bit map whose __popc is its count;
// - a warp scans its counts with __shfl_up_sync; warp 0 scans the 32 warp
//   totals from shared memory; a thread then writes its ids at base +
//   offset, where the position is below cap;
// - masks beyond 16,384 flags take further passes with a running base;
// - then the block fills [min(count, cap), cap) with n and writes *count.
// Every entry of idx is written exactly once, so the wrapper makes no fill.
// A plain launch: launched programmatically (cb_launch_after_fill, waiting
// before its first load) the scene net's graphs ran 1.2-1.6% slower on the
// H100.
#include "cb_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kFlags = 16;                 // flags of a thread in a pass
constexpr int kPass = kThreads * kFlags;   // flags of a pass

struct CompactArgs {
  int n;                    // flags (tiles); the sentinel
  int cols;                 // of the mask's 2-D view
  long long s_row, s_col;   // the view's strides, in bytes (= elements)
  int cap;                  // entries of idx
  int vec16;                // contiguous and 16-byte aligned
};

// 1 byte per nonzero byte of w, in bits 0..3 (byte k -> bit k): the four
// 0x01 bits at 0, 8, 16, 24 land at 24..27 of the product, with no carry
// from the lower partial products (all at distinct bits below 24).
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned load_flags(const unsigned char* m,
                                               int f0, const CompactArgs& a) {
  if (a.vec16 && f0 + kFlags <= a.n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(m + f0));
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
           nibble(v.w) << 12;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kFlags; ++k) {
    const int f = f0 + k;
    if (f < a.n) {
      const int r = f / a.cols;
      const long long off = r * a.s_row + (long long)(f - r * a.cols) *
                                              a.s_col;
      if (__ldg(m + off)) bits |= 1u << k;
    }
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
compact_tiles_kernel(const unsigned char* __restrict__ mask,
                     int* __restrict__ idx, int* __restrict__ count,
                     CompactArgs a) {
  __shared__ int warp_base[kWarps];
  __shared__ int pass_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;
  for (int p0 = 0; p0 < a.n; p0 += kPass) {
    const int f0 = p0 + threadIdx.x * kFlags;
    unsigned bits = f0 < a.n ? load_flags(mask, f0, a) : 0u;
    const int c = __popc(bits);
    int incl = c;  // inclusive prefix over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_base[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = warp_base[lane];
      int s = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += v;
      }
      warp_base[lane] = s - t;  // exclusive
      if (lane == 31) pass_total = s;
    }
    __syncthreads();
    int pos = base + warp_base[warp] + incl - c;
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      if (pos < a.cap) idx[pos] = f0 + k;
      ++pos;
    }
    base += pass_total;
    __syncthreads();  // the next pass rewrites warp_base and pass_total
  }
  for (int i = min(base, a.cap) + threadIdx.x; i < a.cap; i += kThreads)
    idx[i] = a.n;
  if (threadIdx.x == 0) *count = base;
}

}  // namespace

// mask: n one-byte flags (a bool tensor), read as a 2-D view of `cols`
// columns with strides s_row, s_col (bytes); flat id f is row f / cols,
// column f % cols. vec16: the view is contiguous (s_row == cols, s_col ==
// 1) and mask is 16-byte aligned. idx: cap int32 (0 <= cap <= n: the
// wrapper cuts a larger capacity to n, as the sort's slice); count:
// one int32.
extern "C" int cb_compact_tiles(const void* mask, int* idx, int* count, int n,
                                int cols, long long s_row, long long s_col,
                                int cap, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || cols < 1 || cap < 0 || cap > n ||
      (vec16 && (s_col != 1 || s_row != cols ||
                 reinterpret_cast<uintptr_t>(mask) % 16)))
    return (int)cudaErrorInvalidValue;
  CompactArgs a{n, cols, s_row, s_col, cap, vec16};
  compact_tiles_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(mask), idx, count, a);
  return (int)cudaGetLastError();
}
