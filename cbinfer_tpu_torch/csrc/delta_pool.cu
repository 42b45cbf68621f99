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
// 1/(sh*sw) of it; the max is one instruction per value read. At the
// clips' densities a launch lists tens to a few hundred tiles, so latency
// is what it costs. Design (B3's, pool_fused.cu, whose units it shares
// through cb_pool.cuh):
// - a grid sized to the card (the wrapper's walk_grid), each block walking
//   (list entry, part) pairs i = blockIdx.x, i += gridDim.x while
//   i < *count * parts, the next pair's tile id loaded while the current
//   part is pooled. A part is a run of the tile's rows holding at most 512
//   items, two a thread (the whole tile at C 64 in bf16, half at 128, a
//   quarter at 256), so a short list spreads over more SMs and a thread's
//   loads are one round trip; whole tiles a block were 12-47% slower in
//   the same-call A/B (PERF.md);
// - a thread owns (out pixel, channel unit) items, a unit being 16 bytes
//   where a pixel's channels are 16-byte aligned, else 4 bytes; channels
//   fastest, so a warp reads and writes contiguous runs. The kh x kw loads
//   of all of a thread's items (at most UPT of them per batch) are in
//   flight before the first max. The 2x2 stride-2 window of every pool on
//   the paths is a template constant; any other window, stride or dx0 the
//   geometry admits takes a runtime loop in the same kernel.
// B8 writes only the out cache, which the wrapper does not fill, so there
// is no fill to overlap. The TPU kernel's DMA extents (win_h_dma,
// win_w_dma) and phase slices have no counterpart.
#include "cb_pool.cuh"

namespace {

struct DeltaPoolArgs {
  int cap;    // entries of idx
  int units;  // load units per pixel
  int tiles_w, th, tw, kh, kw, sh, sw, dx0;
  int rows, parts;  // rows of a part of a tile, parts of a tile
  long long s_row, out_row;  // row strides, in units
};

// K: 2 for the 2x2 stride-2 window, or 0 for the runtime a.kh x a.kw
// window at stride (a.sh, a.sw). UPT: items a thread loads before it
// reduces.
template <typename T, typename U, int K, int UPT>
__global__ void __launch_bounds__(256)
delta_pool_kernel(const U* __restrict__ st, const int* __restrict__ idx,
                  const int* __restrict__ count, U* __restrict__ out,
                  DeltaPoolArgs a) {
  const int sh = K ? K : a.sh;
  const int sw = K ? K : a.sw;
  const int total = a.rows * a.tw * a.units;  // items of one part
  int i = blockIdx.x;  // pairs i = (list entry i / parts, part i % parts)
  int t = __ldg(idx + min(i / a.parts, a.cap - 1));
  const int n = __ldg(count) * a.parts;
  while (i < n) {
    const int next = i + gridDim.x;
    const int t_next = next < a.cap * a.parts ? __ldg(idx + next / a.parts)
                                              : 0;
    const int ti = t / a.tiles_w;
    const int tj = t - ti * a.tiles_w;
    const int r0 = (i % a.parts) * a.rows;
    for (int b = threadIdx.x; b < total; b += 256 * UPT) {
      const U* src[UPT];
      long long dst[UPT];
#pragma unroll
      for (int k = 0; k < UPT; ++k) {
        const int e = min(b + 256 * k, total - 1);
        const int g = e % a.units;
        const int q = e / a.units;
        const int oy = q / a.tw;
        const long long oyg = (long long)ti * a.th + r0 + oy;
        const long long oxg = (long long)tj * a.tw + (q - oy * a.tw);
        src[k] = st + oyg * sh * a.s_row + (oxg * sw + a.dx0) * a.units + g;
        dst[k] = oyg * a.out_row + oxg * a.units + g;
      }
      if constexpr (K > 0) {
        U v[UPT][K * K];
#pragma unroll
        for (int k = 0; k < UPT; ++k)
#pragma unroll
          for (int dy = 0; dy < K; ++dy)
#pragma unroll
            for (int dx = 0; dx < K; ++dx)
              v[k][dy * K + dx] = __ldg(src[k] + dy * a.s_row + dx * a.units);
#pragma unroll
        for (int k = 0; k < UPT; ++k) {
          U m = v[k][0];
#pragma unroll
          for (int r = 1; r < K * K; ++r) m = unit_max<T>(m, v[k][r]);
          if (b + 256 * k < total) out[dst[k]] = m;
        }
      } else {
#pragma unroll
        for (int k = 0; k < UPT; ++k) {
          U m = __ldg(src[k]);
          for (int dy = 0; dy < a.kh; ++dy)
            for (int dx = 0; dx < a.kw; ++dx)
              m = unit_max<T>(m, __ldg(src[k] + dy * a.s_row + dx * a.units));
          if (b + 256 * k < total) out[dst[k]] = m;
        }
      }
    }
    i = next;
    t = t_next;
  }
}

template <typename T, typename U>
int launch(const void* st, const int* idx, const int* count, void* out,
           int grid, const DeltaPoolArgs& a, cudaStream_t s) {
  const U* su = static_cast<const U*>(st);
  U* ou = static_cast<U*>(out);
  const bool k2 = a.kh == 2 && a.kw == 2 && a.sh == 2 && a.sw == 2;
  const int upt = cb_pool_upt(a.rows * a.tw * a.units);
  auto kernel = !k2        ? &delta_pool_kernel<T, U, 0, 1>
                : upt == 1 ? &delta_pool_kernel<T, U, 2, 1>
                : upt == 2 ? &delta_pool_kernel<T, U, 2, 2>
                           : &delta_pool_kernel<T, U, 2, 4>;
  kernel<<<grid, 256, 0, s>>>(su, idx, count, ou, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* st, const int* idx, const int* count, void* out,
                int grid, int cap, int C, int tiles_w, int th, int tw, int kh,
                int kw, int sh, int sw, int dx0, long long s_row,
                long long out_row, cudaStream_t s) {
  const int bytes = C * (int)sizeof(T);
  const bool vec = cb_pool_units16(bytes, st, out);
  const int per = (vec ? 16 : 4) / (int)sizeof(T);  // elements of a unit
  int rows = th;  // rows of a part: at most 512 items, two a thread
  while (rows % 2 == 0 && rows * tw * (C / per) > 512) rows /= 2;
  DeltaPoolArgs a{cap, C / per, tiles_w, th, tw, kh, kw, sh, sw, dx0,
                  rows, th / rows, s_row / per, out_row / per};
  if (vec) return launch<T, uint4>(st, idx, count, out, grid, a, s);
  return launch<T, unsigned>(st, idx, count, out, grid, a, s);
}

}  // namespace

// cap: entries of idx; grid: blocks to launch (1 <= grid <= cap).
extern "C" int cb_delta_pool(const void* storage, const int* idx,
                             const int* count, void* out, int cap, int grid,
                             int dtype, int C, int tiles_w, int th, int tw,
                             int kh, int kw, int sh, int sw, int dx0,
                             long long s_row, long long out_row,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 0) return 0;
  if (grid < 0 || grid > cap) return (int)cudaErrorInvalidValue;
  if (dtype == CB_BF16)
    return launch_type<__nv_bfloat16>(storage, idx, count, out, grid, cap, C,
                                      tiles_w, th, tw, kh, kw, sh, sw, dx0,
                                      s_row, out_row, s);
  if (dtype == CB_F32)
    return launch_type<float>(storage, idx, count, out, grid, cap, C, tiles_w,
                              th, tw, kh, kw, sh, sw, dx0, s_row, out_row, s);
  return (int)cudaErrorInvalidValue;
}
