// Full-map change detection (C1+C2 fused) for a layer that gets no dirty
// hint from its producer (the layer after a dense stem).
//
// Replaces cbinfer_tpu/ops/pallas/detect.py::detect_full_pallas
// (_band_kernel). Over the whole (H, W, C) map: per pixel, changed iff
// max_c |x - cache| > tau (float32, x already in the cache's type); accept
// changed pixels into the padded storage interior in place; count them;
// mark every out tile of this layer (conv or pool: its own stride, padding
// and window) whose input window holds a changed pixel. tau is read from
// device memory, once per thread, so a captured graph takes a new value.
//
// Bound on the H100: bytes. The sweep reads x and the cache once each
// (2 * H*W*C elements) and writes the changed pixels; there is no
// arithmetic to speak of. Design: the TPU kernel sweeps 8-row bands in
// order on one core and carries the mask in scratch memory; here the map
// is cut into 8-row x 32-pixel blocks that run in any order, one warp per
// row, the per-pixel step shared with the sparse kernel (cb_detect.cuh),
// the mask marked by same-value stores and the count reduced per block and
// added with one atomic.
//
// A narrow x (NARROW): x holds cx channels, fewer than the storage's C or
// an odd count (the 3-channel stem of a "cuda" conv, whose input cache is
// stored at the tile convs' channel grid with zero channels past cx). Each
// lane then takes one pixel of its warp's 32, loads its cx channels one
// element at a time (a pixel of an odd count is not 4-byte aligned), and
// on a change copies them; the storage's channels past cx are never read
// or written, so they stay zero. The wide path is unchanged.
#include "cb_detect.cuh"

namespace {

constexpr int SEG = 32;  // pixels of one row per warp

// Lane `lane` takes pixel x0 + lane of row y (if it is inside the map).
// Returns the warp's number of changed pixels, on every lane.
template <typename T>
__device__ __forceinline__ int detect_narrow(const T* __restrict__ x,
                                             T* __restrict__ st,
                                             float* __restrict__ mask,
                                             float tau, const CbDetectArgs& a,
                                             int cx, int y, int x0, int n,
                                             int lane) {
  int changed = 0;
  if (lane < n) {
    const T* xp = x + (long long)y * a.x_row + (long long)(x0 + lane) * cx;
    T* sp = st + (long long)(y + a.slo_h) * a.s_row +
            (long long)(a.slo_w + x0 + lane) * a.C;
    float m = 0.f;
    for (int c = 0; c < cx; ++c)
      m = fmaxf(m, fabsf(cb_to_float(xp[c]) - cb_to_float(sp[c])));
    if (m > tau) {
      for (int c = 0; c < cx; ++c) sp[c] = xp[c];
      cb_mark_tiles(mask, a.grid, y, x0 + lane);
      changed = 1;
    }
  }
  return __reduce_add_sync(0xffffffffu, changed);
}

template <typename T, bool NARROW>
__global__ void __launch_bounds__(256)
detect_full_kernel(const T* __restrict__ x, T* __restrict__ st,
                   float* __restrict__ mask, int* __restrict__ npix,
                   const float* __restrict__ tau_p, int W, int cx,
                   CbDetectArgs a) {
  __shared__ int s_n;
  const float tau = __ldg(tau_p);  // once per thread, not per pixel
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.y * 8 + warp;
  const int x0 = blockIdx.x * SEG;
  int local = 0;
  if (y < a.H) {
    if constexpr (NARROW)
      local = detect_narrow(x, st, mask, tau, a, cx, y, x0, min(SEG, W - x0),
                            lane);
    else
      local = cb_detect_row(x, st, mask, tau, a, y, x0, min(SEG, W - x0),
                            lane);
  }
  if (lane == 0 && local) atomicAdd(&s_n, local);
  __syncthreads();
  if (threadIdx.x == 0 && s_n) atomicAdd(npix, s_n);
}

template <typename T>
void launch(const void* x, void* st, float* mask, int* npix,
            const float* tau, int W, int cx, const CbDetectArgs& a, dim3 grid,
            cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* stt = static_cast<T*>(st);
  if (cx != a.C || cx % 2)
    detect_full_kernel<T, true>
        <<<grid, 256, 0, s>>>(xt, stt, mask, npix, tau, W, cx, a);
  else
    detect_full_kernel<T, false>
        <<<grid, 256, 0, s>>>(xt, stt, mask, npix, tau, W, cx, a);
}

}  // namespace

// C: channels of the storage; cx <= C: channels of x (x_row counts them),
// the ones compared and accepted.
extern "C" int cb_detect_full(
    const void* x, void* storage, float* mask, int* npix, const float* tau,
    int dtype, int H, int W, int C, int cx, long long x_row, long long s_row,
    int slo_h, int slo_w, int tiles_h, int tiles_w, int step_h, int step_w,
    int pad_lo_h, int pad_lo_w, int win_h, int win_w, void* stream) {
  CbDetectArgs a{H,     C,     x_row,
                 s_row, slo_h, slo_w,
                 {tiles_h, tiles_w, step_h, step_w, pad_lo_h, pad_lo_w, win_h,
                  win_w}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0) return 0;
  if (cx <= 0 || cx > C) return (int)cudaErrorInvalidValue;
  dim3 grid((W + SEG - 1) / SEG, (H + 7) / 8);
  if (dtype == CB_BF16)
    launch<__nv_bfloat16>(x, storage, mask, npix, tau, W, cx, a, grid, s);
  else if (dtype == CB_F32)
    launch<float>(x, storage, mask, npix, tau, W, cx, a, grid, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
