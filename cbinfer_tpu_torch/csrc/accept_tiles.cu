// Hinted tile copy ("accept") of a forward-hint conv layer.
//
// Replaces cbinfer_tpu/ops/pallas/accept.py::accept_tiles (_accept_kernel).
// A forwarding layer does not detect: its input cache simply tracks the
// producer's output over the dirty region. For every hint tile idx[i],
// i < *count, the 8x8xC tile of x (the producer's out cache, read at
// logical coordinates) is copied into the interior of the layer's padded
// input storage. No diff, no threshold, no mask.
//
// Bound on the H100: bytes (each visited tile is read once and written
// once, 2 * 8*8*C elements; no arithmetic). At the paths' densities a call
// lists about 30 of 240 tiles, half a megabyte, so what it costs is
// latency: launch, the count and the index, one round trip for the data.
// The TPU kernel keeps a ring of four tile DMAs in flight; here every
// thread's loads are in flight at once. Design (B8's, delta_pool.cu):
// - a grid sized to the card (the wrapper's walk_grid over the pairs),
//   each block walking (list entry, part) pairs i = blockIdx.x,
//   i += gridDim.x while i < *count * parts, the next pair's tile id loaded
//   while the current part is copied;
// - a tile is 8 rows of 8*C contiguous elements in x and in the storage,
//   cut into units: 16 bytes where the wrapper found every row start
//   16-byte aligned, else 4 bytes. A part is a run of `per` consecutive
//   units of the tile's (row, unit) order, at most UPT a thread of the
//   256 (the wrapper's part_split; this file only checks it), so a short
//   list spreads over many SMs. Every thread issues all its loads before
//   its first store: a copy costs one round trip.
// The kernel writes nothing that a fill would have to clear, and the
// wrapper makes none.
//
// Clamped bottom edge: on a map of at least 8 rows the last hint row starts
// at H - 8 when H % 8 != 0 and overlaps the row above, as in the JAX
// package. Two blocks may then write the same bytes, but both write the
// same values (a pure copy of x), so the overlap needs no ownership rule,
// unlike the sparse detect's. On a map of fewer than 8 rows the tile
// starts at row 0 and its rows past H are skipped. The hint grid is
// cdiv(W, 8) wide: the units of the last column's pixels at or past W are
// skipped (a unit never straddles two pixels: the wrapper takes 16-byte
// units only where a pixel is whole units). Nothing past the logical map
// is read or written.
#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;

struct AcceptArgs {
  int cap;          // entries of idx
  int H, W;
  int row_units;    // units of one tile row (8 * C elements)
  int parts, per;   // parts of a tile, units of a part
  long long x_row, s_row, s_origin;  // in units
};

template <typename U, int UPT>
__global__ void __launch_bounds__(kThreads)
accept_tiles_kernel(const U* __restrict__ x, U* __restrict__ st,
                    const int* __restrict__ idx,
                    const int* __restrict__ count, AcceptArgs a) {
  const int items = 8 * a.row_units;
  const int pixel_units = a.row_units / 8;
  const int hint_tiles_w = (a.W + 7) / 8;
  int i = blockIdx.x;  // pairs i = (list entry i / parts, part i % parts)
  int t = __ldg(idx + min(i / a.parts, a.cap - 1));
  const int n = __ldg(count) * a.parts;
  while (i < n) {
    const int next = i + gridDim.x;
    const int t_next = next < a.cap * a.parts ? __ldg(idx + next / a.parts)
                                              : 0;
    const int hi = t / hint_tiles_w;
    const int hj = t - hi * hint_tiles_w;
    const long long oy = max(min(hi * 8, a.H - 8), 0);
    const int rows = min(8, a.H - (int)oy);
    const int cols = min(8, a.W - hj * 8) * pixel_units;  // units inside
    const int e0 = (i % a.parts) * a.per + threadIdx.x;
    const int e1 = min((i % a.parts + 1) * a.per, items);
    bool in[UPT];
    U v[UPT];
    long long dst[UPT];
#pragma unroll
    for (int k = 0; k < UPT; ++k) {
      const int e = e0 + kThreads * k;
      const int r = e / a.row_units;
      const int u = e - r * a.row_units;
      const long long col = (long long)hj * a.row_units + u;
      in[k] = e < e1 && r < rows && u < cols;
      if (in[k]) {
        v[k] = __ldg(x + (oy + r) * a.x_row + col);
        dst[k] = a.s_origin + (oy + r) * a.s_row + col;
      }
    }
#pragma unroll
    for (int k = 0; k < UPT; ++k)
      if (in[k]) st[dst[k]] = v[k];
    i = next;
    t = t_next;
  }
}

template <typename U>
int launch(const void* x, void* st, const int* idx, const int* count,
           int grid, int upt, const AcceptArgs& a, cudaStream_t s) {
  auto kernel = upt == 1 ? &accept_tiles_kernel<U, 1>
                : upt == 2 ? &accept_tiles_kernel<U, 2>
                           : &accept_tiles_kernel<U, 4>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const U*>(x),
                                   static_cast<U*>(st), idx, count, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x_row, s_row: bytes between rows; s_origin: byte offset of the interior's
// first pixel inside the storage; tile_row_bytes: 8 * C * element size, a
// multiple of 8 units (a pixel is whole units). idx holds ids on the
// cdiv(H, 8) x cdiv(W, 8) hint grid. cap: entries of idx; grid: blocks
// (1 <= grid <= cap * parts); parts, per, upt: the split of a tile's units
// (16 bytes with vec16, else 4) into parts of per <= 256 * upt units, upt
// 1, 2 or 4.
extern "C" int cb_accept_tiles(const void* x, void* storage, const int* idx,
                               const int* count, int cap, int grid, int H,
                               int W, long long x_row,
                               long long s_row, long long s_origin,
                               int tile_row_bytes, int vec16, int parts,
                               int per, int upt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 0) return 0;
  const int ub = vec16 ? 16 : 4;
  const int row_units = tile_row_bytes / ub;
  if (grid < 0 || grid > cap * parts || tile_row_bytes % (8 * ub) ||
      x_row % ub ||
      s_row % ub || s_origin % ub || (upt != 1 && upt != 2 && upt != 4) ||
      per <= 0 || per > kThreads * upt || parts <= 0 ||
      (long long)parts * per < 8LL * row_units ||
      (long long)(parts - 1) * per >= 8LL * row_units)
    return (int)cudaErrorInvalidValue;
  AcceptArgs a{cap,   H,         W,             row_units,    parts,
               per,   x_row / ub, s_row / ub,   s_origin / ub};
  if (vec16) return launch<uint4>(x, storage, idx, count, grid, upt, a, s);
  return launch<unsigned>(x, storage, idx, count, grid, upt, a, s);
}
