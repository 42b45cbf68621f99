// Change-based max pool over the changed out tiles: gather, windowed max,
// scatter (C7), for pools that re-detect instead of forwarding the hint.
//
// Replaces cbinfer_tpu/ops/pallas/delta_pool.py::delta_pool_pallas
// (_delta_pool_kernel). For every out tile idx[i], i < *count: each of its
// th x tw output pixels is the max over the kh x kw window read straight
// from the padded input storage (whose margins hold the finite "-inf"
// fill) at row (ti*th + oy)*sh + dy, column (tj*tw + ox)*sw + dx0 + dx; the
// tile is written into the out cache in place. Tiles not listed are never
// touched.
//
// Bound on the H100: bytes, a tile reads its window once and writes a
// 1/(sh*sw) of it; the max is one operation per value read. Design: one
// block per changed tile (the grid is sized to the tile grid, blocks at or
// past *count exit at once); threads walk (output pixel, channel pair)
// with channels fastest, so a warp reads and writes contiguous runs of 128
// bytes and the max stays in registers. The TPU kernel's DMA extents
// (win_h_dma, win_w_dma) and phase slices have no counterpart.
#include "cb_common.cuh"

namespace {

struct DeltaPoolArgs {
  int C, tiles_w, th, tw, kh, kw, sh, sw, dx0;
  long long s_row, out_row;  // row strides, elements
};

template <typename T>
__global__ void __launch_bounds__(256)
delta_pool_kernel(const T* __restrict__ st, const int* __restrict__ idx,
                  const int* __restrict__ count, T* __restrict__ out,
                  DeltaPoolArgs a) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  const int t = idx[blockIdx.x];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  const int c2n = a.C / 2;
  const int total = a.th * a.tw * c2n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = 2 * (e % c2n);
    const int q = e / c2n;
    const int ox = q % a.tw;
    const int oy = q / a.tw;
    const long long oyg = (long long)ti * a.th + oy;
    const long long oxg = (long long)tj * a.tw + ox;
    const T* win = st + oyg * a.sh * a.s_row + (oxg * a.sw + a.dx0) * a.C + c;
    float2 m = make_float2(-INFINITY, -INFINITY);
    for (int dy = 0; dy < a.kh; ++dy)
      for (int dx = 0; dx < a.kw; ++dx) {
        float2 v = cb_load2(win + dy * a.s_row + dx * a.C);
        m.x = fmaxf(m.x, v.x);
        m.y = fmaxf(m.y, v.y);
      }
    // the max of T values is a T value: the store rounds nothing
    cb_store2(out + oyg * a.out_row + oxg * a.C + c, m);
  }
}

}  // namespace

extern "C" int cb_delta_pool(const void* storage, const int* idx,
                             const int* count, void* out, int n_blocks,
                             int dtype, int C, int tiles_w, int th, int tw,
                             int kh, int kw, int sh, int sw, int dx0,
                             long long s_row, long long out_row,
                             void* stream) {
  DeltaPoolArgs a{C, tiles_w, th, tw, kh, kw, sh, sw, dx0, s_row, out_row};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    delta_pool_kernel<__nv_bfloat16><<<n_blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(storage), idx, count,
        static_cast<__nv_bfloat16*>(out), a);
  } else if (dtype == CB_F32) {
    delta_pool_kernel<float><<<n_blocks, 256, 0, s>>>(
        static_cast<const float*>(storage), idx, count,
        static_cast<float*>(out), a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
