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
// once, 2 * 8*8*C elements; no arithmetic). Design: one block of 128
// threads per hint tile (the grid is sized to the hint grid; blocks at or
// past *count, read from device memory, exit at once). A tile row is 8*C
// contiguous elements in x and in the storage, so the block copies 8 such
// rows, 16 bytes per thread and step where the wrapper found every row
// start 16-byte aligned, else 4 bytes.
//
// Clamped bottom edge: the last hint row starts at H - 8 when H % 8 != 0
// and overlaps the row above, as in the JAX package. Two blocks may then
// write the same bytes, but both write the same values (a pure copy of x),
// so the overlap needs no ownership rule, unlike the sparse detect's.
#include "cb_common.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(128)
accept_tiles_kernel(const unsigned char* __restrict__ x,
                    unsigned char* __restrict__ st,
                    const int* __restrict__ idx,
                    const int* __restrict__ count, int H, int hint_tiles_w,
                    long long x_row, long long s_row, long long s_origin,
                    int tile_row_bytes) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  const int t = idx[blockIdx.x];
  const int hi = t / hint_tiles_w;
  const int hj = t - hi * hint_tiles_w;
  const int oy = min(hi * 8, H - 8);
  const int row_vecs = tile_row_bytes / (int)sizeof(V);
  for (int e = threadIdx.x; e < 8 * row_vecs; e += 128) {
    const int r = e / row_vecs;
    const int v = e - r * row_vecs;
    const long long col = (long long)hj * tile_row_bytes + (long long)v * sizeof(V);
    *reinterpret_cast<V*>(st + s_origin + (oy + r) * s_row + col) =
        *reinterpret_cast<const V*>(x + (oy + r) * x_row + col);
  }
}

}  // namespace

// x_row, s_row: bytes between rows; s_origin: byte offset of the interior's
// first pixel inside the storage; tile_row_bytes: 8 * C * element size.
extern "C" int cb_accept_tiles(const void* x, void* storage, const int* idx,
                               const int* count, int n_blocks, int H,
                               int hint_tiles_w, long long x_row,
                               long long s_row, long long s_origin,
                               int tile_row_bytes, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  const unsigned char* xb = static_cast<const unsigned char*>(x);
  unsigned char* sb = static_cast<unsigned char*>(storage);
  if (vec16) {
    accept_tiles_kernel<uint4><<<n_blocks, 128, 0, s>>>(
        xb, sb, idx, count, H, hint_tiles_w, x_row, s_row, s_origin,
        tile_row_bytes);
  } else {
    accept_tiles_kernel<uint32_t><<<n_blocks, 128, 0, s>>>(
        xb, sb, idx, count, H, hint_tiles_w, x_row, s_row, s_origin,
        tile_row_bytes);
  }
  return (int)cudaGetLastError();
}
