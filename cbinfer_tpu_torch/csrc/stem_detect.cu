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
// covers the logical map only, so no margin has to be gated out. tau is
// read from device memory, once per thread, so a captured graph takes a
// new value.
//
// Bound on the H100: bytes, the frame read once (12 bytes a pixel) and the
// cache read once and written where changed (6 bytes a pixel in bf16).
// Design: the TPU kernel needs the 4-lane flat4 layout, masked lane rolls
// and an indicator matmul to dilate; none of that is needed here.
// - A block of 8 warps owns one row of cells (8 map rows) and 32 cells of
//   it: warp w takes map row 8a + w, lane l the 8 pixels of cell b0 + l in
//   that row. A thread issues all its loads before its first compare: the
//   frame's 8*C floats (2C 16-byte loads) and the cache's 8*C elements (C
//   16-byte loads in bf16), 16 bytes wide where the wrapper found the
//   frame, the cache's row starts and its interior origin 16-byte aligned,
//   else one element a load.
// - A changed group is written back whole (unchanged pixels with the value
//   just read: the kernel is the storage's only writer).
// - Marking: three warp ballots give each warp its row's cells and the
//   cells left and right of the block; one __syncthreads, then the OR over
//   the block's rows, and at most one same-value store per cell the block
//   marks, in its own cell row and the rows above and below (a pixel of
//   the first and last map row of a cell reaches the next cell row).
// - npix: one atomic per block after a block sum.
// - A finer cell (FINE: a cell of 4, 2 or 1 pixels, for a configured tile
//   that is not whole 8x8 cells): each changed pixel marks the cells whose
//   window (rows [cell*i - 1, cell*i + cell + 1)) holds it, by plain
//   same-value stores after the wait. The loads, the accept and the count
//   are the 8x8 path's; that path is unchanged.
// - Launched to overlap the wrapper's one fill of mask and npix
//   (cb_launch_after_fill): the loads and the accept need nothing of it;
//   the marks and the atomic come after cb_wait_prior_grid.
#include "cb_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPix = 8;  // pixels a thread: one cell's row

// A storage element as raw bits (a union member), cb_to_float and
// cb_round on them.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using raw = float;
  __device__ static float value(float v) { return v; }
  __device__ static float round(float v) { return cb_round<float>(v); }
};
template <>
struct Elem<__nv_bfloat16> {
  using raw = unsigned short;
  __device__ static float value(unsigned short v) {
    return cb_to_float(__ushort_as_bfloat16(v));
  }
  __device__ static unsigned short round(float v) {
    return __bfloat16_as_ushort(cb_round<__nv_bfloat16>(v));
  }
};

// N elements of type R held as 16-byte units too (N * sizeof(R) is a
// multiple of 16 for every C: 8 pixels of 2- or 4-byte elements)
template <typename R, int N>
union Group {
  uint4 u[N * sizeof(R) / 16];
  R e[N];
};

template <bool VEC, typename R, int N>
__device__ __forceinline__ void load_group(Group<R, N>& g, const R* p) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < N * (int)sizeof(R) / 16; ++k)
      g.u[k] = __ldg(reinterpret_cast<const uint4*>(p) + k);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) g.e[k] = __ldg(p + k);
  }
}

struct StemDetectArgs {
  int W;
  long long s_row;   // elements between rows of the storage
  int slo_h, slo_w;  // interior origin inside the storage
  int cells_h, cells_w, bw;  // the 8x8 cell grid; blocks over a cell row
  CbTileGrid fine;   // the mask's grid of FINE cells (3x3 SAME windows)
};

template <typename T, int C, bool VEC, bool FINE>
__global__ void __launch_bounds__(256)
stem_detect_kernel(const float* __restrict__ x, T* __restrict__ st,
                   float* __restrict__ mask, int* __restrict__ npix,
                   const float* __restrict__ tau_p, StemDetectArgs a) {
  using E = Elem<T>;
  using R = typename E::raw;
  __shared__ unsigned long long s_mark[8];
  __shared__ int s_n[8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ca = blockIdx.x / a.bw;                  // cell row
  const int cb0 = (blockIdx.x - ca * a.bw) * 32;     // first cell column
  const int cb = cb0 + lane;
  const int r = ca * 8 + warp;
  unsigned bits = 0;  // bit p: pixel 8*cb + p of row r changed
  if (cb < a.cells_w) {
    const float tau = __ldg(tau_p);  // once per thread, not per pixel
    Group<float, kPix * C> xv;
    Group<R, kPix * C> cv;
    R* sp = reinterpret_cast<R*>(st) + (long long)(r + a.slo_h) * a.s_row +
            (long long)(a.slo_w + cb * kPix) * C;
    // read-only loads of the cache too: a thread writes only the pixels
    // it has read
    load_group<VEC>(xv, x + ((long long)r * a.W + cb * kPix) * C);
    load_group<VEC>(cv, sp);
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        m = fmaxf(m, fabsf(xv.e[p * C + c] - E::value(cv.e[p * C + c])));
      bits |= (unsigned)(m > tau) << p;
    }
    if (bits) {
#pragma unroll
      for (int p = 0; p < kPix; ++p)
        if (bits >> p & 1) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            cv.e[p * C + c] = E::round(xv.e[p * C + c]);
        }
      if constexpr (VEC) {
#pragma unroll
        for (int k = 0; k < kPix * C * (int)sizeof(R) / 16; ++k)
          reinterpret_cast<uint4*>(sp)[k] = cv.u[k];
      } else {
#pragma unroll
        for (int p = 0; p < kPix; ++p)
          if (bits >> p & 1) {
#pragma unroll
            for (int c = 0; c < C; ++c) sp[p * C + c] = cv.e[p * C + c];
          }
      }
    }
  }
  if constexpr (FINE) {
    const int n = __reduce_add_sync(kFull, __popc(bits));
    if (lane == 0) s_n[warp] = n;
    __syncthreads();
    cb_wait_prior_grid();  // mask and npix are the fill's
#pragma unroll
    for (int p = 0; p < kPix; ++p)
      if (bits >> p & 1) cb_mark_tiles(mask, a.fine, r, cb * kPix + p);
    if (threadIdx.x == 0) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += s_n[w];
      if (s) atomicAdd(npix, s);
    }
    return;
  }
  // this row's marks on cells cb0 - 1 .. cb0 + 32 (bit j: cell cb0 - 1 + j):
  // a changed pixel marks its own cell, its first column the cell to the
  // left, its last column the cell to the right
  const unsigned own = __ballot_sync(kFull, bits != 0);
  const unsigned left = __ballot_sync(kFull, bits & 1u);
  const unsigned right = __ballot_sync(kFull, bits >> (kPix - 1) & 1u);
  const int n = __reduce_add_sync(kFull, __popc(bits));
  if (lane == 0) {
    s_mark[warp] = (unsigned long long)own << 1 | left |
                   (unsigned long long)right << 2;
    s_n[warp] = n;
  }
  __syncthreads();
  cb_wait_prior_grid();  // mask and npix are the fill's
  // threads 0..101: cell row ca - 1 (from map row 8ca), ca, ca + 1 (from
  // map row 8ca + 7), 34 cells each
  if (threadIdx.x < 3 * 34) {
    const int dr = threadIdx.x / 34;  // 0, 1, 2: cell rows ca - 1, ca, ca + 1
    const int j = threadIdx.x - dr * 34;
    unsigned long long m = 0;
    if (dr == 1) {
#pragma unroll
      for (int w = 0; w < 8; ++w) m |= s_mark[w];
    } else {
      m = s_mark[dr == 0 ? 0 : 7];
    }
    const int row = ca - 1 + dr;
    const int col = cb0 - 1 + j;
    if ((m >> j & 1) && row >= 0 && row < a.cells_h && col >= 0 &&
        col < a.cells_w)
      mask[(long long)row * a.cells_w + col] = 1.f;
  }
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += s_n[w];
    if (s) atomicAdd(npix, s);
  }
}

template <typename T, int C>
int launch_c(const float* x, void* st, float* mask, int* npix,
             const float* tau, bool vec, int grid, const StemDetectArgs& a,
             cudaStream_t s) {
  // launched to overlap the wrapper's fill of mask and npix
  const bool fine = a.fine.step_h != 8;
  auto kernel = vec ? (fine ? &stem_detect_kernel<T, C, true, true>
                            : &stem_detect_kernel<T, C, true, false>)
                    : (fine ? &stem_detect_kernel<T, C, false, true>
                            : &stem_detect_kernel<T, C, false, false>);
  const cudaError_t err = cb_launch_after_fill(
      kernel, grid, 256, s, x, static_cast<T*>(st), mask, npix, tau, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_type(const float* x, void* st, float* mask, int* npix,
                const float* tau, int C, bool vec, int grid,
                const StemDetectArgs& a, cudaStream_t s) {
  switch (C) {
    case 1: return launch_c<T, 1>(x, st, mask, npix, tau, vec, grid, a, s);
    case 2: return launch_c<T, 2>(x, st, mask, npix, tau, vec, grid, a, s);
    case 3: return launch_c<T, 3>(x, st, mask, npix, tau, vec, grid, a, s);
    case 4: return launch_c<T, 4>(x, st, mask, npix, tau, vec, grid, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The stem's 3x3 SAME window on the grid of cells of `cell` (8, 4, 2 or 1)
// pixels: H and W multiples of 8; mask is (H / cell, W / cell). vec16: the
// frame, the storage's row starts and its interior origin are 16-byte
// aligned (16-byte loads). bw: blocks over a row of 8x8 cells (the
// wrapper's block_plan, cdiv(W / 8, 32)); the grid is bw * H / 8.
extern "C" int cb_stem_detect(const float* x, void* storage, float* mask,
                              int* npix, const float* tau, int dtype, int H,
                              int W, int C, long long s_row, int slo_h,
                              int slo_w, int vec16, int bw, int cell,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  const int cells_w = W / 8;
  if (H % 8 || W % 8 || bw <= 0 || bw * 32 < cells_w ||
      (bw - 1) * 32 >= cells_w || cell <= 0 || 8 % cell)
    return (int)cudaErrorInvalidValue;
  StemDetectArgs a{W,       s_row, slo_h, slo_w, H / 8, cells_w, bw,
                   {H / cell, W / cell, cell, cell, 1, 1, cell + 2,
                    cell + 2}};
  const int grid = bw * (H / 8);
  if (dtype == CB_BF16)
    return launch_type<__nv_bfloat16>(x, storage, mask, npix, tau, C, vec16,
                                      grid, a, s);
  if (dtype == CB_F32)
    return launch_type<float>(x, storage, mask, npix, tau, C, vec16, grid,
                              a, s);
  return (int)cudaErrorInvalidValue;
}
