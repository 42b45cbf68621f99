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
// writes a quarter of that; the max is one instruction per input value.
// Design: one block per dirty block (grid sized to the block grid, blocks
// at or past *count exit at once); threads walk (pooled pixel, channel
// pair) with channels fastest, so each warp reads and writes contiguous
// runs of 128 bytes; the max stays in registers.
#include "cb_common.cuh"

namespace {

struct PoolArgs {
  int C, blocks_w, hint_h, hint_w, pool, tiles_w;
  long long x_row, out_row;  // row strides, elements
};

template <typename T>
__global__ void __launch_bounds__(256)
pool_fused_kernel(const T* __restrict__ x, T* __restrict__ out,
                  const int* __restrict__ idx, const int* __restrict__ count,
                  float* __restrict__ mask, PoolArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  const int t = idx[blockIdx.x];
  const int hi = t / a.blocks_w;
  const int hj = t - hi * a.blocks_w;
  const int oh = a.hint_h / a.pool;
  const int ow = a.hint_w / a.pool;
  const int c2n = a.C / 2;
  const int total = oh * ow * c2n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = 2 * (e % c2n);
    const int q = e / c2n;
    const int oxl = q % ow;
    const int oyl = q / ow;
    const long long iy0 = (long long)hi * a.hint_h + oyl * a.pool;
    const long long ix0 = (long long)hj * a.hint_w + oxl * a.pool;
    float2 m = make_float2(-INFINITY, -INFINITY);
    for (int py = 0; py < a.pool; ++py)
      for (int px = 0; px < a.pool; ++px) {
        float2 v = cb_load2(x + (iy0 + py) * a.x_row + (ix0 + px) * a.C + c);
        m.x = fmaxf(m.x, v.x);
        m.y = fmaxf(m.y, v.y);
      }
    // the max of T values is a T value: the store rounds nothing
    cb_store2(out + ((long long)hi * oh + oyl) * a.out_row +
                  ((long long)hj * ow + oxl) * a.C + c,
              m);
  }
  if (threadIdx.x == 0)
    mask[((hi * oh) / 8) * a.tiles_w + (hj * ow) / 8] = 1.f;
}

}  // namespace

extern "C" int cb_pool_fused(const void* x, void* out, const int* idx,
                             const int* count, float* mask, int n_blocks,
                             int dtype, int C, int blocks_w, int hint_h,
                             int hint_w, int pool, int tiles_w,
                             long long x_row, long long out_row,
                             void* stream) {
  PoolArgs a{C, blocks_w, hint_h, hint_w, pool, tiles_w, x_row, out_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    pool_fused_kernel<__nv_bfloat16><<<n_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), idx, count, mask, a);
  } else if (dtype == CB_F32) {
    pool_fused_kernel<float><<<n_blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), idx, count,
        mask, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
