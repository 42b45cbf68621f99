// Full-map change detection (C1+C2 fused) for a layer that gets no dirty
// hint from its producer (the layer after a dense stem).
//
// Replaces cbinfer_tpu/ops/pallas/detect.py::detect_full_pallas
// (_band_kernel). Over the whole (H, W) map: per pixel, changed iff
// max over x's channels of |x - cache| > tau (float32, x already in the
// cache's type); accept changed pixels into the padded storage interior in
// place (the storage's channels past x's keep their values); count them;
// mark every out tile of this layer (conv or pool: its own stride, padding
// and window) whose input window holds a changed pixel. Any H and W. tau is
// read from device memory, once per thread, so a captured graph takes a new
// value.
//
// Bound on the H100: bytes. The sweep reads x and the cache once each and
// writes the changed pixels; there is no arithmetic to speak of (720x1280
// at C = 128 in bf16: 472 MB read, 0.141 ms at 3.35 TB/s). What held the
// first kernel back was bytes in flight: a warp walked its 32 pixels one at
// a time with 4-byte loads, about 256 bytes in flight a warp. Design:
//
// Wide path (x holds the storage's C channels, C even):
// - a grid sized to the card (the wrapper's walk_grid) walks the map's
//   8x8-pixel tiles, cdiv(H, 8) x cdiv(W, 8) of them, i = blockIdx.x,
//   i += gridDim.x (a block's 8 rows of one tile beat 64 pixels of one
//   row: 0.180 against 0.196 ms at 720p). Plain loads were chosen over TMA
//   bulk copies into a shared ring: a tile row's 8 pixels are 2 KB of x
//   and 2 KB of the cache at C = 128, which the loads of one warp already
//   keep in flight with no barriers, no producer warp and no shared
//   memory, and the sweep runs at the card's read rate;
// - one warp per tile row, four lanes a pixel (the sparse detect's row
//   routine, detect_sparse.cu): every lane issues all its loads of x and of
//   the cache, 16 bytes each where a pixel is whole 16-byte units, else 4,
//   before its first comparison (4 KB in flight a warp at C = 128 in bf16),
//   reduces over its registers and two shuffles, and on a change stores the
//   x it holds. Pixels wider than 32 units (float32 C > 128, bf16 C > 256)
//   run in batches and reload x for the accept.
//
// Narrow path (x holds cx < C channels, or an odd count: the 3-channel
// stem of a "cuda" conv, whose input cache is stored at the tile convs'
// channel grid, 8 in bf16 and 4 in float32): a block of 8 warps takes 8
// map rows and 128 pixels of them, warp w row w, lane l the pixels
// 32k + l, k < 4, so that a warp's loads of one step are contiguous.
// - Where the storage's pixel is one 16-byte unit, a lane loads each of
//   its cache pixels in one 16-byte access (512 contiguous bytes a warp)
//   and its x pixels one element at a time, all before its first compare,
//   and stores a changed pixel's unit back whole, its channels past cx as
//   they were read. Runs of 8 pixels a lane took 0.0227 ms at 720p, runs of
//   4 0.0174: the marks after the last load are the kernel's tail, and a
//   run's marks are serial.
// - Else (a wider or odd storage) the same layout one element at a time,
//   writing x's channels only.
//
// Marks, both paths: a lane holds a run of a map row (the wide path: its
// pixel; the narrow path: 4 pixels, from the warp's ballots) and marks the
// out tiles whose window holds one of the run's changed pixels, testing
// the columns between its first changed pixel's first and its last one's
// last against the run's bits (two divisions a run, not two a pixel). It
// skips the columns up to the last one a lane below reaches (an exclusive
// max-scan over the lanes): a window holding a pixel of a lane below and
// one of this lane holds every pixel between, so that lane marked it. A
// warp step stores each mark once, so tau = -1 or a pan costs one to three
// stores a step, not one a pixel.
//
// Both: npix summed per block, one atomic a block; launched to overlap the
// wrapper's one fill of mask and npix, two views of one buffer
// (cb_launch_after_fill): the loads and the accept need nothing of it, the
// marks and the atomic come after cb_wait_prior_grid.
#include "cb_detect.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPix = 4;          // narrow path: pixels a lane
constexpr int kSpan = 32 * kPix;  // narrow path: pixels of a block's row

// The max of v over the lanes below this one; -1 on lane 0.
__device__ __forceinline__ int max_below(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = max(v, t);
  }
  const int below = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? -1 : below;
}

// The first and the last out-tile column whose window holds map column c
// (the first may lie past the grid: then none does).
__device__ __forceinline__ int first_col(const CbTileGrid& t, int c) {
  const int v = c + t.pad_lo_w - t.win_w + 1;
  return v <= 0 ? 0 : (v + t.step_w - 1) / t.step_w;
}
__device__ __forceinline__ int last_col(const CbTileGrid& t, int c) {
  return min((c + t.pad_lo_w) / t.step_w, t.tiles_w - 1);
}

// Called by the whole warp. A lane holds a run of map row y from column x0,
// bit p of `bits` set where pixel x0 + p changed (bits < 2^31). Marks every
// out tile whose window holds a changed pixel, each once over the warp: a
// lane tests the columns from its first changed pixel's first to its last
// one's last against its bits, and skips those up to the last column a
// lane below reaches (a window that holds a pixel of a lane below and one
// of this lane holds every pixel between, so that lane marked it).
__device__ __forceinline__ void mark_run(float* __restrict__ mask,
                                         const CbTileGrid& t, int y, int x0,
                                         unsigned bits, int lane) {
  if (!__any_sync(kFull, bits)) return;
  int lo = 0, hi = -1;
  if (bits) {
    lo = first_col(t, x0 + __ffs(bits) - 1);
    hi = last_col(t, x0 + 31 - __clz(bits));
  }
  const int done = max_below(hi, lane);
  if (!bits) return;
  int a0, a1;
  cb_window_range(y, t.step_h, t.pad_lo_h, t.win_h, t.tiles_h, &a0, &a1);
  cb_wait_prior_grid();  // the mask is the fill's
  for (int b = max(lo, done + 1); b <= hi; ++b) {
    // the run's pixels inside column b's window: bits [s, e)
    const int start = b * t.step_w - t.pad_lo_w - x0;
    const int s = max(start, 0);
    const int e = min(start + t.win_w, 31);
    if (s < e && (bits >> s & ((1u << (e - s)) - 1)))
      for (int a = a0; a <= a1; ++a) mask[a * t.tiles_w + b] = 1.f;
  }
}

// One tile row of 8 pixels, the first `npx` of them inside the map: x at
// xr, the storage at sr, each pixel `up` load units of type U long. Lane =
// 4 * pixel + j; lane j of a pixel takes its units j, j + 4, ... NV of them
// per batch. Returns 1 on the first lane of each changed pixel, else 0.
template <typename T, typename U, int NV>
__device__ __forceinline__ int wide_row(const T* __restrict__ xr,
                                        T* __restrict__ sr, int up, int npx,
                                        float* __restrict__ mask, float tau,
                                        const CbTileGrid& grid, int y,
                                        int x0, int lane) {
  const int p = lane >> 2;
  const int j = lane & 3;
  const bool inside = p < npx;
  const U* __restrict__ xu = reinterpret_cast<const U*>(xr) + p * up;
  U* __restrict__ su = reinterpret_cast<U*>(sr) + p * up;
  U xv[NV], cv[NV];
  float m = 0.f;
  for (int b = j; b < (inside ? up : 0); b += 4 * NV) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int u = b + 4 * k;
      if (u < up) {
        xv[k] = __ldg(xu + u);
        cv[k] = su[u];
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (b + 4 * k < up) m = fmaxf(m, cb_unit_absdiff<T>(xv[k], cv[k]));
  }
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
  const bool changed = inside && m > tau;
  if (changed) {
    if (up <= 4 * NV) {  // one batch: the x of every unit is in registers
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (j + 4 * k < up) su[j + 4 * k] = xv[k];
    } else {
      for (int u = j; u < up; u += 4) su[u] = __ldg(xu + u);
    }
  }
  const bool lead = changed && j == 0;
  mark_run(mask, grid, y, x0 + p, lead, lane);
  return lead;
}

// The block's count into npix: one atomic a block.
__device__ __forceinline__ void add_count(int local, int* __restrict__ npix,
                                          int* s_n) {
  const int warp = threadIdx.x >> 5;
  local = __reduce_add_sync(kFull, local);
  if ((threadIdx.x & 31) == 0) s_n[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += s_n[w];
    cb_wait_prior_grid();  // npix is the fill's
    if (s) atomicAdd(npix, s);
  }
}

template <typename T, typename U, int NV>
__global__ void __launch_bounds__(256)
detect_full_wide_kernel(const T* __restrict__ x, T* __restrict__ st,
                        float* __restrict__ mask, int* __restrict__ npix,
                        const float* __restrict__ tau_p, int W, int up,
                        CbDetectArgs a) {
  __shared__ int s_n[8];
  const float tau = __ldg(tau_p);  // once per thread, not per pixel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles_w = (W + 7) / 8;
  const int n = (a.H + 7) / 8 * tiles_w;
  int local = 0;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int ti = i / tiles_w;
    const int x0 = (i - ti * tiles_w) * 8;
    const int y = ti * 8 + warp;  // one tile row per warp
    if (y < a.H) {  // the last tile row may be partial
      const T* xr = x + (long long)y * a.x_row + (long long)x0 * a.C;
      T* sr = st + (long long)(y + a.slo_h) * a.s_row +
              (long long)(a.slo_w + x0) * a.C;
      local += wide_row<T, U, NV>(xr, sr, up, min(8, W - x0), mask, tau,
                                  a.grid, y, x0, lane);
    }
  }
  add_count(local, npix, s_n);
}

// A storage element as raw bits (a union member) and its value.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float;
  __device__ static float value(float v) { return v; }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  __device__ static float value(unsigned short v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
};

// Narrow path. Block b takes map rows [8 * (b / bw), +8) and columns
// [kSpan * (b % bw), +kSpan): warp w row w, lane l the pixels 32k + l of
// the span, k < kPix. CX > 0: the storage's pixel is one 16-byte unit and
// x holds CX channels, fewer than it; CX == 0: any cx and C, one element
// at a time.
template <typename T, int CX>
__global__ void __launch_bounds__(256)
detect_full_narrow_kernel(const T* __restrict__ x, T* __restrict__ st,
                          float* __restrict__ mask, int* __restrict__ npix,
                          const float* __restrict__ tau_p, int W, int cx,
                          int bw, CbDetectArgs a) {
  using R = typename Raw<T>::type;
  __shared__ int s_n[8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int by = blockIdx.x / bw;
  const int xs = (blockIdx.x - by * bw) * kSpan;  // the span's first column
  const int y = by * 8 + warp;
  unsigned hits[kPix] = {};  // bit l of hits[k]: pixel xs + 32k + l changed
  if (y < a.H) {
    const float tau = __ldg(tau_p);  // once per thread, not per pixel
    T* sr = st + (long long)(y + a.slo_h) * a.s_row +
            (long long)a.slo_w * a.C;
    if constexpr (CX > 0) {
      constexpr int CS = 16 / sizeof(T);  // the storage's channels
      const R* xr = reinterpret_cast<const R*>(x) + (long long)y * a.x_row;
      uint4* su = reinterpret_cast<uint4*>(sr);
      R xv[kPix][CX];
      union {
        uint4 u;
        R e[CS];
      } cv[kPix];
      // every load in flight before the first compare; a warp's loads of
      // the cache are 512 contiguous bytes
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int c = xs + 32 * k + lane;
        if (c < W) {
#pragma unroll
          for (int e = 0; e < CX; ++e) xv[k][e] = __ldg(xr + c * CX + e);
          // read-only loads of the cache too: a lane writes only the
          // pixels it has read
          cv[k].u = __ldg(su + c);
        }
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int c = xs + 32 * k + lane;
        bool hit = false;
        if (c < W) {
          float m = 0.f;
#pragma unroll
          for (int e = 0; e < CX; ++e)
            m = fmaxf(m, fabsf(Raw<T>::value(xv[k][e]) -
                               Raw<T>::value(cv[k].e[e])));
          hit = m > tau;
          if (hit) {  // the unit whole, its channels past CX as read
#pragma unroll
            for (int e = 0; e < CX; ++e) cv[k].e[e] = xv[k][e];
            su[c] = cv[k].u;
          }
        }
        hits[k] = __ballot_sync(kFull, hit);
      }
    } else {
      const T* xr = x + (long long)y * a.x_row;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int c = xs + 32 * k + lane;
        bool hit = false;
        if (c < W) {
          const T* xp = xr + c * cx;
          T* sp = sr + c * a.C;
          float m = 0.f;
          for (int e = 0; e < cx; ++e)
            m = fmaxf(m, fabsf(cb_to_float(xp[e]) - cb_to_float(sp[e])));
          hit = m > tau;
          if (hit)
            for (int e = 0; e < cx; ++e) sp[e] = xp[e];
        }
        hits[k] = __ballot_sync(kFull, hit);
      }
    }
  }
  // marks and count: lane l takes the span's pixels [kPix * l, +kPix)
  const int first = lane * kPix;
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    if (k == first >> 5) word = hits[k];
  const unsigned bits = word >> (first & 31) & ((1u << kPix) - 1);
  const int x0 = xs + first;
  mark_run(mask, a.grid, y, x0, bits, lane);
  add_count(__popc(bits), npix, s_n);
}

template <typename T, typename U>
int launch_wide(const T* x, T* st, float* mask, int* npix, const float* tau,
                int W, int up, int grid, const CbDetectArgs& a,
                cudaStream_t s) {
  const int per_lane = (up + 3) / 4;  // units of a lane in one batch
  auto kernel = per_lane <= 1   ? &detect_full_wide_kernel<T, U, 1>
                : per_lane <= 2 ? &detect_full_wide_kernel<T, U, 2>
                : per_lane <= 4 ? &detect_full_wide_kernel<T, U, 4>
                                : &detect_full_wide_kernel<T, U, 8>;
  return (int)cb_launch_after_fill(kernel, grid, 256, s, x, st, mask, npix,
                                   tau, W, up, a);
}

template <typename T, int CX>
int launch_narrow(const T* x, T* st, float* mask, int* npix,
                  const float* tau, int W, int cx, const CbDetectArgs& a,
                  cudaStream_t s) {
  const int bw = (W + kSpan - 1) / kSpan;
  return (int)cb_launch_after_fill(&detect_full_narrow_kernel<T, CX>,
                                   bw * ((a.H + 7) / 8), 256, s, x, st, mask,
                                   npix, tau, W, cx, bw, a);
}

// The vector form for x's channel count, cx < the 16-byte unit's channels
template <typename T, int CX = 1>
int launch_narrow_vec(const T* x, T* st, float* mask, int* npix,
                      const float* tau, int W, int cx, const CbDetectArgs& a,
                      cudaStream_t s) {
  if constexpr (CX < 16 / (int)sizeof(T)) {
    if (cx == CX)
      return launch_narrow<T, CX>(x, st, mask, npix, tau, W, cx, a, s);
    return launch_narrow_vec<T, CX + 1>(x, st, mask, npix, tau, W, cx, a,
                                        s);
  } else {
    return launch_narrow<T, 0>(x, st, mask, npix, tau, W, cx, a, s);
  }
}

template <typename T>
int launch_type(const void* xv, void* stv, float* mask, int* npix,
                const float* tau, int W, int cx, int grid,
                const CbDetectArgs& a, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* st = static_cast<T*>(stv);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xv);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(stv);
  const int es = (int)sizeof(T);
  if (cx == a.C && cx % 2 == 0 && xa % 4 == 0 && sa % 4 == 0) {
    // 16-byte units where every pixel starts 16-byte aligned (all offsets
    // are multiples of C elements), else 4-byte units
    const int bytes = a.C * es;
    if (bytes % 16 == 0 && xa % 16 == 0 && sa % 16 == 0)
      return launch_wide<T, uint4>(x, st, mask, npix, tau, W, bytes / 16,
                                   grid, a, s);
    return launch_wide<T, unsigned>(x, st, mask, npix, tau, W, bytes / 4,
                                    grid, a, s);
  }
  if (a.C * es == 16 && sa % 16 == 0)
    return launch_narrow_vec<T>(x, st, mask, npix, tau, W, cx, a, s);
  return launch_narrow<T, 0>(x, st, mask, npix, tau, W, cx, a, s);
}

}  // namespace

// C: channels of the storage; cx <= C: channels of x (x_row counts them),
// the ones compared and accepted. grid: blocks of the wide path's walk over
// the cdiv(H, 8) x cdiv(W, 8) pixel tiles (1 <= grid <= their number; the
// wrapper's walk_grid); the narrow path launches a block per 8 rows x 256
// pixels.
extern "C" int cb_detect_full(
    const void* x, void* storage, float* mask, int* npix, const float* tau,
    int dtype, int H, int W, int C, int cx, int grid, long long x_row,
    long long s_row, int slo_h, int slo_w, int tiles_h, int tiles_w,
    int step_h, int step_w, int pad_lo_h, int pad_lo_w, int win_h, int win_w,
    void* stream) {
  CbDetectArgs a{H,     C,     x_row,
                 s_row, slo_h, slo_w,
                 {tiles_h, tiles_w, step_h, step_w, pad_lo_h, pad_lo_w, win_h,
                  win_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  if (cx <= 0 || cx > C || grid <= 0 ||
      grid > ((H + 7) / 8) * ((W + 7) / 8))
    return (int)cudaErrorInvalidValue;
  int err;
  if (dtype == CB_BF16)
    err = launch_type<__nv_bfloat16>(x, storage, mask, npix, tau, W, cx,
                                     grid, a, s);
  else if (dtype == CB_F32)
    err = launch_type<float>(x, storage, mask, npix, tau, W, cx, grid, a, s);
  else
    return (int)cudaErrorInvalidValue;
  return err ? err : (int)cudaGetLastError();
}
