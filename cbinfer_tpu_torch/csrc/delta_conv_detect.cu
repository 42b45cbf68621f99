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
// Design (bf16): delta_conv's cluster (cb_conv.cuh: one block per slice
// of n_blk output channels, the same split plan, so the same sums in the
// same order). A pixel's channels are spread over the cluster, so the
// detect runs across it: in the epilogue each block takes, per pixel, the
// max |y - cache| over its own channels into shared memory; after a
// cluster barrier every block reads the csize partial maxima through
// distributed shared memory (mapa + ld.shared::cluster) and takes their
// max, which is order-free, so every block holds the same changed flags;
// each block accepts its own channels of the changed pixels (the bits it
// just stored into the out cache); rank 0 counts them with one atomic per
// cluster and marks the consumer's tiles with same-value stores. A second
// cluster barrier, split around the accept, keeps every block's shared
// memory alive until the others have read it.
//
// float32 (the exact-reference mode): one 256-thread block per tile keeps
// the rounded 64 x cout out tile in shared memory beside the window; after
// one barrier warp r walks tile row r (cb_detect_pixels).
//
// mask and npix are zeroed by the wrapper before the launch. Tile origins
// are NOT clamped: on a map whose height is no multiple of 8 the last tile
// row overhangs, and rows >= out_h (the producer's pad rows) are neither
// detected nor accepted. That equals the unfused detect, whose blocks touch
// only the rows their tile owns.
//
// Split plan: as delta_conv.cu (pose w64 at 720p, n_blk x csize: 64->128
// (360 rows) 32 x 4; 128->256, 256->256 (180) 64 x 4; 256->512 (90)
// 64 x 8; 512->256, 56->256, 256->256 and 1x1 256->256 (90) 64 x 4;
// 256->128, 128->128, 1x1 128->128 (90) 32 x 4; 1x1 128->56 (90) 64 x 1).
// Shared memory at 3x3 512->256: window 104,000 B + ring 32 KB + 1 KB.
#include "cb_conv.cuh"
#include "cb_detect.cuh"

namespace {

constexpr int kYPad = 8;  // extra elements per pixel of the f32 out tile

template <int N>
__global__ void __launch_bounds__(kWgThreads)
delta_conv_detect_wg_kernel(const __nv_bfloat16* __restrict__ st,
                            const int* __restrict__ idx,
                            const int* __restrict__ count,
                            const __nv_bfloat16* __restrict__ wp,
                            const float* __restrict__ bias,
                            __nv_bfloat16* __restrict__ out,
                            __nv_bfloat16* __restrict__ nc,
                            float* __restrict__ mask, int* __restrict__ npix,
                            const float* __restrict__ tau_p, ConvArgs a,
                            WgPlan pl, NextArgs n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WgShared& sh = *reinterpret_cast<WgShared*>(smem_raw);
  int rank;
  const int i = wg_begin(count, pl, sh, &rank);
  if (i < 0) return;
  const int t = idx[i];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  conv_tile_wg<N, true>(st, wp, bias, out, ti, tj, rank, a, pl, sh, nc, n);
  const bool cluster = pl.csize > 1;
  if (cluster) {
    cluster_arrive();  // this block's partial maxima are written
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (threadIdx.x < 64) {
    const int p = threadIdx.x;
    const float tau = __ldg(tau_p);  // once per thread, after the conv
    float m = sh.part[p];
    for (int r = 0; r < pl.csize; ++r)
      if (r != rank) m = fmaxf(m, dsmem_load(&sh.part[p], r));
    sh.flag[p] = ti * 8 + (p >> 3) < n.out_h && m > tau;
  }
  if (cluster) cluster_arrive();  // done with the other blocks' maxima
  __syncthreads();
  // accept this block's channels of the changed pixels: the bits its
  // epilogue just stored into the out cache
  for (int s = rank; s < pl.slices; s += pl.csize) {
    const int co0 = s * N;
    const int vecs = min(N, a.cout - co0) / 8;
    for (int e = threadIdx.x; e < 64 * vecs; e += kWgThreads) {
      const int p = e / vecs, v = e - p * vecs;
      if (!sh.flag[p]) continue;
      const long long y = ti * 8 + (p >> 3), x = tj * 8 + (p & 7);
      const int co = co0 + v * 8;
      *reinterpret_cast<uint4*>(nc + (y + n.slo_h) * n.nc_row +
                                (n.slo_w + x) * a.cout + co) =
          *reinterpret_cast<const uint4*>(out + y * a.out_row + x * a.cout +
                                          co);
    }
  }
  if (rank == 0) {
    const int p = threadIdx.x;
    const bool changed = p < 64 && sh.flag[p];
    if (changed)
      cb_mark_tiles(mask, n.grid, ti * 8 + (p >> 3), tj * 8 + (p & 7));
    const int cnt = __syncthreads_count(changed);
    if (threadIdx.x == 0 && cnt) atomicAdd(npix, cnt);
  }
  if (cluster) cluster_wait();
}

__global__ void __launch_bounds__(kThreads)
delta_conv_detect_f32_kernel(const float* __restrict__ st,
                             const int* __restrict__ idx,
                             const int* __restrict__ count,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             float* __restrict__ out, float* __restrict__ nc,
                             float* __restrict__ mask, int* __restrict__ npix,
                             const float* __restrict__ tau_p, ConvArgs a,
                             NextArgs n, int win_elems) {
  if ((int)blockIdx.x >= __ldg(count)) return;
  const float tau = __ldg(tau_p);  // once per thread, not per pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_n;
  float* win = reinterpret_cast<float*>(smem_raw);
  float* ytile = win + win_elems;
  const int ys = a.cout + kYPad;
  if (threadIdx.x == 0) s_n = 0;
  const int t = idx[blockIdx.x];
  const int ti = t / a.tiles_w;
  const int tj = t - ti * a.tiles_w;
  stage_window(st, win, ti, tj, a);
  __syncthreads();
  conv_tile_f32(win, w, bias, out, ti, tj, a, ytile, ys);
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
// wide as its logical output; the wrapper checks both (fuse_gate). bf16:
// ``w`` is the packed weights and (n_blk, ..., smem) the wrapper's plan
// (ops/conv_plan.py); float32: ``w`` is HWIO and the plan is not read.
extern "C" int cb_delta_conv_detect(
    const void* storage, const int* idx, const int* count, const void* w,
    const float* bias, void* out, void* next_cache, float* mask, int* npix,
    int n_blocks, int dtype, int cin, int cout, int kh, int kw, int sh,
    int sw, int dh, int dw, int win_h, int win_w, int dx0, int tiles_w,
    long long s_row, long long out_row, int relu, int has_bias,
    const float* tau2,
    int out_h, long long nc_row, int nc_lo_h, int nc_lo_w, int tiles_h2,
    int tiles_w2, int step_h2, int step_w2, int pad_lo_h2, int pad_lo_w2,
    int win_h2, int win_w2, int n_blk, int csize, int slices, int steps,
    int stages, int smem, void* stream) {
  static SmemMarks hw_f32;
  ConvArgs a{cin, cout,  kh,    kw,  sh,      sw,
             dh,  dw,    8,     8,   win_h,   win_w,
             dx0, tiles_w, conv_pixel_stride(cin), s_row, out_row,
             relu, has_bias};
  NextArgs n{out_h, nc_row, nc_lo_h, nc_lo_w,
             {tiles_h2, tiles_w2, step_h2, step_w2, pad_lo_h2, pad_lo_w2,
              win_h2, win_w2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks <= 0) return 0;
  if (dtype == CB_BF16) {
    static SmemMarks hw[3];
    const WgPlan pl{slices, csize, steps, stages};
    const auto* st = static_cast<const __nv_bfloat16*>(storage);
    const auto* wp = static_cast<const __nv_bfloat16*>(w);
    auto* o = static_cast<__nv_bfloat16*>(out);
    auto* nc = static_cast<__nv_bfloat16*>(next_cache);
    switch (n_blk) {
      case 16:
        return launch_wg(delta_conv_detect_wg_kernel<16>, n_blocks, pl, smem,
                         &hw[0], s, st, idx, count, wp, bias, o, nc, mask,
                         npix, tau2, a, pl, n);
      case 32:
        return launch_wg(delta_conv_detect_wg_kernel<32>, n_blocks, pl, smem,
                         &hw[1], s, st, idx, count, wp, bias, o, nc, mask,
                         npix, tau2, a, pl, n);
      case 64:
        return launch_wg(delta_conv_detect_wg_kernel<64>, n_blocks, pl, smem,
                         &hw[2], s, st, idx, count, wp, bias, o, nc, mask,
                         npix, tau2, a, pl, n);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != CB_F32) return (int)cudaErrorInvalidValue;
  // both buffers hold whole 16-byte groups: sp and cout + kYPad are
  // multiples of 4 float32 elements
  const int win_elems = win_h * win_w * a.sp;
  const size_t bytes =
      ((size_t)win_elems + (size_t)64 * (cout + kYPad)) * sizeof(float);
  int err;
  if ((err = set_smem(delta_conv_detect_f32_kernel, bytes, &hw_f32)))
    return err;
  delta_conv_detect_f32_kernel<<<n_blocks, kThreads, bytes, s>>>(
      static_cast<const float*>(storage), idx, count,
      static_cast<const float*>(w), bias, static_cast<float*>(out),
      static_cast<float*>(next_cache), mask, npix, tau2, a, n, win_elems);
  return (int)cudaGetLastError();
}
