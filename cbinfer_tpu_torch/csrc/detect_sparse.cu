// Sparse change detection (C1+C2 fused) over a producer's dirty 8x8 hint
// tiles.
//
// Replaces cbinfer_tpu/ops/pallas/detect.py::detect_sparse (_sparse_kernel).
// For every hint tile idx[i], i < *count: per pixel, changed iff
// max_c |x - cache| > tau (float32); accept changed pixels into the padded
// storage in place; count them; mark every out tile of THIS layer whose
// receptive field holds a changed pixel. The layer may be a conv or a pool:
// the dilation takes the layer's stride, padding and window as given. tau
// is read from device memory, once per thread, so a captured graph takes a
// new value.
//
// Bound on the H100: bytes. Each visited tile reads x and the cache once
// and writes at most its changed pixels (3 * 8*8*C * 2 bytes in bf16 at
// most), against no arithmetic to speak of. At the clips' densities a
// launch lists tens to a thousand tiles, so what it costs is latency:
// launch, the count, the index, one round trip for the pixels. Design:
// - a grid sized to the card (the wrapper's walk_grid), each block walking
//   the list i = blockIdx.x, i += gridDim.x while i < *count; the count
//   stays on the device and the next entry's index is loaded while the
//   current one is worked on;
// - one warp per tile row, four lanes per pixel: every lane issues all its
//   loads of x and of the cache (16 bytes each where a pixel's channels are
//   16-byte aligned, else 4) before the first comparison, reduces over its
//   own registers and two shuffles, and on a change stores the x it holds.
//   Rows wider than 32 units per pixel (bf16 C > 256) run in batches and
//   reload x for the accept;
// - npix summed per block, one atomic per block;
// - launched to overlap the wrapper's one fill of mask and npix
//   (cb_launch_after_fill): the loads and the accept need nothing of it,
//   the mask marks and the atomic wait for it.
//
// Ragged edges: the hint grid is cdiv(H, 8) x cdiv(W, 8), so the last hint
// row and column may hold fewer than 8 rows or pixels of the map (any H and
// W, fewer than 8 rows too). A warp skips a row at or past H, and the lanes
// of a pixel at or past W load, compare and write nothing (they still take
// part in the shuffles). Nothing past the logical map is read or written,
// and each block touches only its own tile's pixels.
#include "cb_detect.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// One tile row of 8 pixels, the first `npx` of them inside the map: x at
// xr, the storage at sr, each pixel `up` load units of type U long. Lane =
// 4 * pixel + j; lane j of a pixel takes its units j, j + 4, ... NV of them
// per batch. Returns 1 on the first lane of each changed pixel, else 0.
template <typename T, typename U, int NV>
__device__ __forceinline__ int detect_row(const T* __restrict__ xr,
                                          T* __restrict__ sr, int up,
                                          int npx, float* __restrict__ mask,
                                          float tau, const CbTileGrid& grid,
                                          int y, int x0, int lane) {
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
  if (!inside || !(m > tau)) return 0;
  if (up <= 4 * NV) {  // one batch: the x of every unit is in registers
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (j + 4 * k < up) su[j + 4 * k] = xv[k];
  } else {
    for (int u = j; u < up; u += 4) su[u] = __ldg(xu + u);
  }
  if (j == 0) {
    cb_wait_prior_grid();  // the mask is the fill's
    cb_mark_tiles(mask, grid, y, x0 + p);
  }
  return j == 0;
}

template <typename T, typename U, int NV>
__global__ void __launch_bounds__(256)
detect_sparse_kernel(const T* __restrict__ x, T* __restrict__ st,
                     const int* __restrict__ idx,
                     const int* __restrict__ count, float* __restrict__ mask,
                     int* __restrict__ npix, int cap,
                     const float* __restrict__ tau_p, int W, int up,
                     CbDetectArgs a) {
  __shared__ int s_n[8];
  const float tau = __ldg(tau_p);  // once per thread, not per pixel
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hint_tiles_w = (W + 7) / 8;
  // blockIdx.x < gridDim.x <= cap: the first index loads beside the count
  int i = blockIdx.x;
  int t = __ldg(idx + i);
  const int n = __ldg(count);
  int local = 0;
  while (i < n) {
    const int next = i + gridDim.x;
    const int t_next = next < cap ? __ldg(idx + next) : 0;
    const int hi = t / hint_tiles_w;
    const int hj = t - hi * hint_tiles_w;
    const int y = hi * 8 + warp;  // one tile row per warp
    if (y < a.H) {  // the last hint row may be partial
      const T* xr = x + (long long)y * a.x_row + (long long)hj * 8 * a.C;
      T* sr = st + (long long)(y + a.slo_h) * a.s_row +
              (long long)(a.slo_w + hj * 8) * a.C;
      local += detect_row<T, U, NV>(xr, sr, up, min(8, W - hj * 8), mask,
                                    tau, a.grid, y, hj * 8, lane);
    }
    i = next;
    t = t_next;
  }
  local = __reduce_add_sync(kFull, local);
  if (lane == 0) s_n[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += s_n[w];
    cb_wait_prior_grid();  // npix is the fill's
    if (s) atomicAdd(npix, s);
  }
}

template <typename T, typename U>
int launch(const void* x, void* st, const int* idx, const int* count,
           float* mask, int* npix, int cap, int grid, const float* tau,
           int W, int up, const CbDetectArgs& a, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* stt = static_cast<T*>(st);
  const int per_lane = (up + 3) / 4;  // units of a lane in one batch
  // launched to overlap the wrapper's fill of mask and npix
  auto kernel = per_lane <= 1   ? &detect_sparse_kernel<T, U, 1>
                : per_lane <= 2 ? &detect_sparse_kernel<T, U, 2>
                : per_lane <= 4 ? &detect_sparse_kernel<T, U, 4>
                                : &detect_sparse_kernel<T, U, 8>;
  const cudaError_t err =
      cb_launch_after_fill(kernel, grid, 256, s, xt, stt, idx, count, mask,
                           npix, cap, tau, W, up, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_type(const void* x, void* st, const int* idx, const int* count,
                float* mask, int* npix, int cap, int grid, const float* tau,
                int W, const CbDetectArgs& a, cudaStream_t s) {
  // 16-byte units where every pixel starts 16-byte aligned (all offsets
  // are multiples of C elements), else 4-byte units
  const int bytes = a.C * (int)sizeof(T);
  const bool vec = bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(st) % 16 == 0;
  if (vec)
    return launch<T, uint4>(x, st, idx, count, mask, npix, cap, grid, tau,
                            W, bytes / 16, a, s);
  return launch<T, unsigned>(x, st, idx, count, mask, npix, cap, grid, tau,
                             W, bytes / 4, a, s);
}

}  // namespace

// cap: entries of idx; grid: blocks to launch (1 <= grid <= cap). idx holds
// ids on the cdiv(H, 8) x cdiv(W, 8) hint grid.
extern "C" int cb_detect_sparse(
    const void* x, void* storage, const int* idx, const int* count,
    float* mask, int* npix, int cap, int grid, const float* tau, int dtype,
    int H, int C, int W, long long x_row, long long s_row,
    int slo_h, int slo_w, int tiles_h, int tiles_w, int step_h, int step_w,
    int pad_lo_h, int pad_lo_w, int win_h, int win_w, void* stream) {
  CbDetectArgs a{H,     C,     x_row,
                 s_row, slo_h, slo_w,
                 {tiles_h, tiles_w, step_h, step_w, pad_lo_h, pad_lo_w, win_h,
                  win_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 0) return 0;
  if (grid < 0 || grid > cap) return (int)cudaErrorInvalidValue;
  if (dtype == CB_BF16)
    return launch_type<__nv_bfloat16>(x, storage, idx, count, mask, npix, cap,
                                      grid, tau, W, a, s);
  if (dtype == CB_F32)
    return launch_type<float>(x, storage, idx, count, mask, npix, cap, grid,
                              tau, W, a, s);
  return (int)cudaErrorInvalidValue;
}
