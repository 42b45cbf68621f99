// Hint-forwarded max pool over a producer's dirty blocks (CB17 mask
// forwarding at the pool layer).
//
// Replaces cbinfer_tpu/ops/pallas/delta_pool.py::detect_pool_fused
// (_fused_pool_kernel). For every dirty block idx[i], i < *count, of the
// (H/hint_h, W/hint_w) block grid (two 8x8 hint tiles paired in W): take
// the aligned pool x pool max, write the pooled block into the output cache
// in place, and mark the one 8x8 out tile that holds it. No detection and
// no input cache.
//
// Bound on the H100: bytes — a block reads hint_h*hint_w*C values and
// writes a quarter of that; the max is one instruction per input value. At
// the clips' densities a launch lists tens to a thousand blocks, so
// latency is what it costs. Design:
// - a grid sized to the card (the wrapper's walk_grid), each block walking
//   the list i = blockIdx.x, i += gridDim.x while i < *count, the next
//   entry's index loaded while the current one is pooled;
// - a thread owns (pooled pixel, channel unit) items, a unit being 16
//   bytes (8 bf16 or 4 f32 channels) where a pixel's channels are 16-byte
//   aligned, else 4 bytes; channels fastest, so a warp reads and writes
//   contiguous runs. The pool x pool loads of all of a thread's items (at
//   most UPT of them per batch) are in flight before the first max; the
//   pool and UPT are template constants for the 2x2 pool of every
//   forwarding pool the gate admits (other pools: a runtime loop);
// - launched to overlap the wrapper's fill of the mask
//   (cb_launch_after_fill): only the mask writes wait for it.
#include "cb_pool.cuh"

namespace {

struct PoolArgs {
  int cap;     // entries of idx
  int units;   // load units per pixel
  int blocks_w, hint_h, hint_w, pool, tiles_w;
  long long x_row, out_row;  // row strides, in units
};

// POOL: the pool size, or 0 for a runtime a.pool. UPT: items a thread
// loads before it reduces.
template <typename T, typename U, int POOL, int UPT>
__global__ void __launch_bounds__(256)
pool_fused_kernel(const U* __restrict__ x, U* __restrict__ out,
                  const int* __restrict__ idx, const int* __restrict__ count,
                  float* __restrict__ mask, PoolArgs a) {
  const int pool = POOL ? POOL : a.pool;
  const int oh = a.hint_h / pool;
  const int ow = a.hint_w / pool;
  const int total = oh * ow * a.units;  // items of one block
  int i = blockIdx.x;  // < gridDim.x <= cap
  int t = __ldg(idx + i);
  const int n = __ldg(count);
  while (i < n) {
    const int next = i + gridDim.x;
    const int t_next = next < a.cap ? __ldg(idx + next) : 0;
    const int hi = t / a.blocks_w;
    const int hj = t - hi * a.blocks_w;
    for (int b = threadIdx.x; b < total; b += 256 * UPT) {
      const U* src[UPT];
      long long dst[UPT];
#pragma unroll
      for (int k = 0; k < UPT; ++k) {
        const int e = min(b + 256 * k, total - 1);
        const int g = e % a.units;
        const int q = e / a.units;
        const int oyl = q / ow;
        const int oxl = q - oyl * ow;
        src[k] = x + ((long long)hi * a.hint_h + oyl * pool) * a.x_row +
                 ((long long)hj * a.hint_w + oxl * pool) * a.units + g;
        dst[k] = ((long long)hi * oh + oyl) * a.out_row +
                 ((long long)hj * ow + oxl) * a.units + g;
      }
      if constexpr (POOL > 0) {
        U v[UPT][POOL * POOL];
#pragma unroll
        for (int k = 0; k < UPT; ++k)
#pragma unroll
          for (int py = 0; py < POOL; ++py)
#pragma unroll
            for (int px = 0; px < POOL; ++px)
              v[k][py * POOL + px] =
                  __ldg(src[k] + py * a.x_row + px * a.units);
#pragma unroll
        for (int k = 0; k < UPT; ++k) {
          U m = v[k][0];
#pragma unroll
          for (int r = 1; r < POOL * POOL; ++r) m = unit_max<T>(m, v[k][r]);
          if (b + 256 * k < total) out[dst[k]] = m;
        }
      } else {
#pragma unroll
        for (int k = 0; k < UPT; ++k) {
          U m = __ldg(src[k]);
          for (int py = 0; py < pool; ++py)
            for (int px = 0; px < pool; ++px)
              m = unit_max<T>(m, __ldg(src[k] + py * a.x_row + px * a.units));
          if (b + 256 * k < total) out[dst[k]] = m;
        }
      }
    }
    if (threadIdx.x == 0) {
      cb_wait_prior_grid();  // the mask is the fill's
      mask[((hi * oh) / 8) * a.tiles_w + (hj * ow) / 8] = 1.f;
    }
    i = next;
    t = t_next;
  }
  if (threadIdx.x == 0) cb_wait_prior_grid();  // done only after the fill
}

template <typename T, typename U>
int launch(const void* x, void* out, const int* idx, const int* count,
           float* mask, int grid, const PoolArgs& a, cudaStream_t s) {
  const U* xu = static_cast<const U*>(x);
  U* ou = static_cast<U*>(out);
  const int upt = cb_pool_upt((a.hint_h / 2) * (a.hint_w / 2) * a.units);
  // launched to overlap the wrapper's fill of the mask
  auto kernel = a.pool != 2 ? &pool_fused_kernel<T, U, 0, 1>
                : upt == 1  ? &pool_fused_kernel<T, U, 2, 1>
                : upt == 2  ? &pool_fused_kernel<T, U, 2, 2>
                            : &pool_fused_kernel<T, U, 2, 4>;
  const cudaError_t err =
      cb_launch_after_fill(kernel, grid, 256, s, xu, ou, idx, count, mask, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_type(const void* x, void* out, const int* idx, const int* count,
                float* mask, int grid, int cap, int C, int blocks_w,
                int hint_h, int hint_w, int pool, int tiles_w,
                long long x_row, long long out_row, cudaStream_t s) {
  const int bytes = C * (int)sizeof(T);
  const bool vec = cb_pool_units16(bytes, x, out);
  const int ub = vec ? 16 : 4;  // bytes of a unit
  const int per = ub / (int)sizeof(T);  // elements of a unit
  PoolArgs a{cap,  bytes / ub, blocks_w,      hint_h,       hint_w,
             pool, tiles_w,    x_row / per,   out_row / per};
  if (vec) return launch<T, uint4>(x, out, idx, count, mask, grid, a, s);
  return launch<T, unsigned>(x, out, idx, count, mask, grid, a, s);
}

}  // namespace

// cap: entries of idx; grid: blocks to launch (1 <= grid <= cap).
extern "C" int cb_pool_fused(const void* x, void* out, const int* idx,
                             const int* count, float* mask, int cap,
                             int grid, int dtype, int C, int blocks_w,
                             int hint_h, int hint_w, int pool, int tiles_w,
                             long long x_row, long long out_row,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 0) return 0;
  if (grid < 0 || grid > cap) return (int)cudaErrorInvalidValue;
  if (dtype == CB_BF16)
    return launch_type<__nv_bfloat16>(x, out, idx, count, mask, grid, cap, C,
                                      blocks_w, hint_h, hint_w, pool, tiles_w,
                                      x_row, out_row, s);
  if (dtype == CB_F32)
    return launch_type<float>(x, out, idx, count, mask, grid, cap, C,
                              blocks_w, hint_h, hint_w, pool, tiles_w, x_row,
                              out_row, s);
  return (int)cudaErrorInvalidValue;
}
