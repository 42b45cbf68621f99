// Fused delta convolution + the NEXT layer's change detection
// (C4+C5+C6 of the producer, then C1+C2 of its consumer, in one launch).
//
// Replaces cbinfer_tpu/ops/pallas/delta_conv_detect.py::
// delta_conv_detect_pallas (_kernel). For every changed out tile idx[i],
// i < *count, of the producer conv: compute the tile exactly as
// delta_conv.cu does and store it into the producer's out cache; then, on
// the tile just computed, run the consumer's detect: a pixel changed iff
// max_c |y - cache| > tau2 in float32, where y is the value ROUNDED to the
// cache type (what the unfused consumer would read back from the out cache)
// and cache is the consumer's accepted-input storage; changed pixels are
// accepted into that storage in place, counted, and every out tile of the
// CONSUMER whose receptive field holds one is marked. Bit-identical to
// delta_conv followed by detect_sparse over the same tile list; it saves
// the consumer's re-read of the tiles, one launch and one compaction of the
// hint per fused pair.
//
// Bound on the H100: operations, as delta_conv (the detect adds one read
// and at most one write of a 64 x cout tile to ~38-604 MFLOP of GEMM).
// Design: delta_conv's block (one per changed tile, 256 threads, the
// window staged in dynamic shared memory) keeps a second shared buffer, the
// rounded 64 x cout out tile. After the GEMM a pixel's channels are spread
// over the 8 warps (and over a warp's passes when cout > 256), so the
// epilogue writes each value to the out cache AND to that buffer; after one
// barrier warp r owns tile row r and walks its 8 pixels with the lanes over
// the channels two at a time, a shuffle reduction giving the pixel's
// max-abs-diff. The buffer's pixels are 8 elements apart from a multiple of
// 128 bytes, so the epilogue's stores and the detect's loads spread over
// the banks. Window + tile: 104 KB + 32 KB for 3x3 512->256, 52 KB + 65 KB
// for 3x3 256->512, inside the 227 KB a block may have.
//
// Blocks run in any order: mask and npix are zeroed by the wrapper before
// the launch, npix gets one atomic per block, the mask same-value stores.
// Tile origins are NOT clamped: on a map whose height is no multiple of 8
// the last tile row overhangs, and rows >= out_h (the producer's pad rows)
// are neither detected nor accepted. That equals the unfused detect, whose
// blocks touch only the rows their tile owns.
#include "cb_conv.cuh"
#include "cb_detect.cuh"

namespace {

constexpr int kYPad = 8;  // extra elements per pixel of the staged out tile

struct NextArgs {
  int out_h;         // logical rows of the producer's output
  long long nc_row;  // consumer storage row stride, elements
  int slo_h, slo_w;  // interior origin inside the consumer storage
  CbTileGrid grid;   // the CONSUMER's out-tile grid
};

template <typename T, bool kMma, bool kTail>
__global__ void __launch_bounds__(kThreads)
delta_conv_detect_kernel(const T* __restrict__ st,
                         const int* __restrict__ idx,
                         const int* __restrict__ count,
                         const T* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ out,
                         T* __restrict__ nc, float* __restrict__ mask,
                         int* __restrict__ npix, float tau, ConvArgs a,
                         NextArgs n, int win_elems) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_n;
  T* win = reinterpret_cast<T*>(smem_raw);
  T* ytile = win + win_elems;
  const int ys = a.cout + kYPad;
  if (threadIdx.x == 0) s_n = 0;
  const int t = idx[blockIdx.x];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  stage_window(st, win, ti, tj, a);
  __syncthreads();
  if constexpr (kMma) {
    conv_tile_mma<kTail>(win, w, bias, out, ti, tj, a, ytile, ys);
  } else {
    conv_tile_f32(win, w, bias, out, ti, tj, a, ytile, ys);
  }
  __syncthreads();
  // the consumer's detect on the tile in shared memory: one row per warp,
  // rows past the map's height skipped
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = ti * 8 + warp;
  int local = 0;
  if (y < n.out_h)
    local = cb_detect_pixels(
        ytile + warp * 8 * ys, ys,
        nc + (long long)(y + n.slo_h) * n.nc_row +
            (long long)(n.slo_w + tj * 8) * a.cout,
        a.cout, mask, tau, n.grid, y, tj * 8, 8, lane);
  if (lane == 0 && local) atomicAdd(&s_n, local);
  __syncthreads();
  if (threadIdx.x == 0 && s_n) atomicAdd(npix, s_n);
}

}  // namespace

// The producer's tiles must be 8x8 (th == tw == 8) and its out cache as
// wide as its logical output; the wrapper checks both (fuse_gate).
extern "C" int cb_delta_conv_detect(
    const void* storage, const int* idx, const int* count, const void* w,
    const float* bias, void* out, void* next_cache, float* mask, int* npix,
    int n_blocks, int dtype, int cin, int cout, int kh, int kw, int sh,
    int sw, int dh, int dw, int win_h, int win_w, int dx0, int tiles_w,
    long long s_row, long long out_row, int relu, int has_bias, float tau2,
    int out_h, long long nc_row, int nc_lo_h, int nc_lo_w, int tiles_h2,
    int tiles_w2, int step_h2, int step_w2, int pad_lo_h2, int pad_lo_w2,
    int win_h2, int win_w2, void* stream) {
  static int hw_mma = 48 * 1024, hw_tail = 48 * 1024, hw_f32 = 48 * 1024;
  ConvArgs a{cin, cout,  kh,    kw,  sh,      sw,
             dh,  dw,    8,     8,   win_h,   win_w,
             dx0, tiles_w, conv_pixel_stride(cin), s_row, out_row,
             relu, has_bias};
  NextArgs n{out_h, nc_row, nc_lo_h, nc_lo_w,
             {tiles_h2, tiles_w2, step_h2, step_w2, pad_lo_h2, pad_lo_w2,
              win_h2, win_w2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  // both buffers hold whole 16-byte groups: sp and cout + kYPad are
  // multiples of 8 (bf16) or 4 (float32) elements
  const int win_elems = win_h * win_w * a.sp;
  const size_t elems = (size_t)win_elems + (size_t)64 * (cout + kYPad);
  int err;
  if (dtype == CB_BF16) {
    // a cin off the MMA's 16-channel k-step has its own instantiation,
    // so the common one carries no tail code
    auto kernel = cin % 16
                      ? delta_conv_detect_kernel<__nv_bfloat16, true, true>
                      : delta_conv_detect_kernel<__nv_bfloat16, true, false>;
    size_t smem = elems * sizeof(__nv_bfloat16);
    if ((err = set_smem(kernel, smem, cin % 16 ? &hw_tail : &hw_mma)))
      return err;
    kernel<<<n_blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(storage), idx, count,
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(next_cache), mask, npix, tau2, a, n,
        win_elems);
  } else if (dtype == CB_F32) {
    auto kernel = delta_conv_detect_kernel<float, false, false>;
    size_t smem = elems * sizeof(float);
    if ((err = set_smem(kernel, smem, &hw_f32))) return err;
    kernel<<<n_blocks, kThreads, smem, s>>>(
        static_cast<const float*>(storage), idx, count,
        static_cast<const float*>(w), bias, static_cast<float*>(out),
        static_cast<float*>(next_cache), mask, npix, tau2, a, n, win_elems);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
