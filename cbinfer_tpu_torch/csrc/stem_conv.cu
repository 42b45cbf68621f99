// Sparse 3x3 stem convolution (cin <= 3) over the changed (8, 32) stem
// tiles: gather, conv, bias, ReLU, scatter (C4-C6 for the small-cin stem).
//
// Replaces cbinfer_tpu/ops/pallas/patch_stem.py::patch_stem_conv
// (_patch_stem_kernel, pack_patch_weights). For every stem tile idx[i],
// i < *count: the 3x3 stride-1 SAME conv of the accepted stem cache (the
// padded HWC storage; its zero margins are the padding), K = 9 * cin taps
// in (dy, dx, c) order, products of compute-type values summed in float32,
// the bias rounded through the compute type first (as the weights are),
// ReLU, and the (8, 32, cout) tile written into the out cache in place.
// Tiles not listed are never touched.
//
// Overflow without a host branch: when *count > capacity the list is cut
// short, and the reference switches to a dense conv of the whole map under
// lax.cond. Here the walk then covers every tile id 0..n_tiles-1 instead of
// the list. The reference's dense branch is bit-identical to its kernel,
// so this changes no value.
//
// Bound on the H100: bytes at the stem density of a static-camera clip (a
// tile reads a 10 x 34 x cin window, 2 KB, and writes 8*32*cout values, 64
// KB at cout 128 in bf16, for 0.9 MFLOP); float32 FMAs on the CUDA cores
// when many tiles are listed. Design:
// - work items are (tile, tile row, 16-pixel half, channel chunk), one
//   warp each: the 69 tiles of a flagship frame are 1104 items, about one
//   for every warp of the card. A grid sized to the card (the wrapper's
//   walk_grid) walks them, item j to warp j mod (warps of the grid), the
//   warps of one tile on different blocks; a warp keeps one chunk. The
//   chunks are a power of two, so an item's fields are bits of j: the walk
//   has no integer division (removing them saved 6-18%);
// - a lane owns CC = 4 channels, their 27*CC weights in registers for the
//   whole walk (one vector load a tap), and 8-pixel blocks of the item:
//   L lanes (cout/CC rounded up to a power of two, at most 32, so that
//   the blocks split the warp evenly) cover a chunk of L*CC channels of a
//   block, so at cout 128 a lane takes both blocks, at cout 64 each
//   half-warp one; a warp stages its item's 3 x 18 x cin input window in shared
//   memory in float32, planar, and the lanes of a block read the same
//   values (broadcast loads): per (dy, c) ten values, reused by the three
//   dx taps, feed 3 * 8 * CC FMAs. The taps are summed in (dy, dx, c)
//   order with one rounding each, as the plain version's sum; products of
//   bf16 values are exact in float32, so in bf16 this is the plain
//   version's arithmetic bit for bit;
// - a lane loads the tile ids of 32 of its warp's items at once, before
//   the count is known, and the next item's window is loaded into
//   registers, at offsets computed once, while the current one is
//   computed;
// - L lanes store a pixel's L*CC channels as one contiguous run (256
//   bytes at cout 128 in bf16), CC channels a lane.
// The FMAs take about 60% of the time when every tile is listed (0.095 ms
// of them at the card's float32 rate); the rest is the work around them,
// with two warps a scheduler (a lane holds ~210 registers).
// Dropped after the same-call A/B (PERF.md): a lane owning 8 pixels x 8
// channels of an im2col tile row, weights in shared memory: two 16-byte
// shared loads a tap for 64 FMAs, slower in every case. The tensor cores
// were not taken: their order of summation is not this one, and a bf16
// result next to zero would then differ from the plain version's by more
// than an ulp. The TPU kernel's selection matmuls and block-diagonal
// weights are Mosaic devices and are not kept.
#include "cb_common.cuh"

namespace {

constexpr int TH = 8, TW = 32;  // stem tile, output pixels
constexpr int PX = 16;          // pixels of an item: half a tile row
constexpr int PB = 8;           // pixels of a lane's block
constexpr int WC = PX + 2;      // window columns of an item
constexpr int WP = 20;          // floats of a staged window row
constexpr int THREADS = 256, WARPS = THREADS / 32;

struct StemConvArgs {
  int cout, lanes, cs;  // lanes of a block, chunks = 1 << cs (1, 2, 4)
  int tiles_w, n_tiles, capacity, dx0, relu;
  long long s_row, out_row;  // row strides, elements
};

// CC values of a lane: one store of CC * sizeof(T) bytes
template <typename T, int CC>
__device__ __forceinline__ void store_cc(T* dst, const float* v) {
  if constexpr (sizeof(T) == 2 && CC == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  } else if constexpr (sizeof(T) == 4 && CC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < CC; ++q) dst[q] = cb_round<T>(v[q]);
  }
}

// C: input channels (cin); CC: output channels of a lane (4, or 1 for a
// cout that is no multiple of 4)
template <typename T, int C, int CC>
__global__ void __launch_bounds__(THREADS, 1)
stem_conv_kernel(const T* __restrict__ st, const int* __restrict__ idx,
                 const int* __restrict__ count, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out,
                 StemConvArgs a) {
  constexpr int K = 9 * C;
  constexpr int WIN = 3 * WC * C;         // values of an item's window
  constexpr int NLOAD = (WIN + 31) / 32;  // of them a lane loads
  __shared__ __align__(16) float s_win_all[WARPS][C * 3 * WP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_win = s_win_all[warp];

  const int stride = WARPS * gridDim.x;  // a multiple of chunks (<= 4)
  // warp w of block b takes items j = w * gridDim.x + b, + stride; item j
  // is tile entry j >> (4 + cs), and its low bits are (row, half, chunk)
  int j = warp * gridDim.x + blockIdx.x;
  const int chunk = j & ((1 << a.cs) - 1);  // fixed for the warp
  // this lane's first channel and pixel blocks [pb0, pb1) of an item
  const int n0 = (chunk * a.lanes + lane % a.lanes) * CC;
  const int pb0 = a.lanes == 32 ? 0 : lane / a.lanes;
  const int pb1 = a.lanes == 32 ? PX / PB : min(pb0 + 1, PX / PB);
  const bool active = n0 < a.cout && pb0 < PX / PB;  // cout % CC == 0

  // this lane's weights and bias, rounded through T as the plain
  // version's (zero for a lane past cout)
  float wr[K][CC];
  float bv[CC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* wk = w + k * a.cout + n0;
    if constexpr (CC == 4 && sizeof(T) == 2) {  // one 8-byte load
      uint2 u = active ? __ldg(reinterpret_cast<const uint2*>(wk))
                       : make_uint2(0, 0);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
      wr[k][0] = lo.x; wr[k][1] = lo.y; wr[k][2] = hi.x; wr[k][3] = hi.y;
    } else if constexpr (CC == 4) {  // one 16-byte load
      const float4 f = active ? __ldg(reinterpret_cast<const float4*>(wk))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      wr[k][0] = f.x; wr[k][1] = f.y; wr[k][2] = f.z; wr[k][3] = f.w;
    } else {
#pragma unroll
      for (int q = 0; q < CC; ++q)
        wr[k][q] = active ? cb_to_float(wk[q]) : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < CC; ++q)
    bv[q] = active && bias != nullptr
                ? cb_to_float(cb_round<T>(bias[n0 + q]))
                : 0.f;

  const int n = __ldg(count);
  const int tile_shift = 4 + a.cs;  // items of a tile: 8 rows x 2 x chunks
  // tiles (ti << 16 | tj) of this warp's items j0 + l*stride, l < 32: lane
  // l holds one, loaded from the list before the count is known (an entry
  // past the count is never used; on overflow the id is the item's
  // position)
  auto tile_batch = [&](int j0) {
    const int pos = (j0 + lane * stride) >> tile_shift;
    int t = pos < a.capacity ? __ldg(idx + pos) : 0;
    t = n > a.capacity ? pos : t;
    const int ti = t / a.tiles_w;
    return ti << 16 | (t - ti * a.tiles_w);
  };
  int batch = tile_batch(j);
  const int n_items = (n > a.capacity ? a.n_tiles : n) << tile_shift;

  // an item's window: storage rows ti*8 + py + 0..2, columns tj*32 +
  // 16*half + dx0 + 0..17, all channels; lane l loads values l, l + 32, ..
  // window value e = lane + 32q, (dy, col, c): its offset from the
  // window's first element in the storage, and its staged place
  int src_off[NLOAD], dst_off[NLOAD];
#pragma unroll
  for (int q = 0; q < NLOAD; ++q) {
    const int e = min(lane + 32 * q, WIN - 1);
    const int dy = e / (WC * C);
    const int rem = e - dy * (WC * C);
    const int col = rem / C;
    src_off[q] = dy * (int)a.s_row + rem;
    dst_off[q] = ((rem - col * C) * 3 + dy) * WP + col;
  }
  T pre[NLOAD];
  auto load_window = [&](int t, int jj) {
    const int py = (jj >> (a.cs + 1)) & (TH - 1);
    const int half = (jj >> a.cs) & 1;
    const int ti = t >> 16, tj = t & 0xffff;
    const T* src = st + (long long)(ti * TH + py) * a.s_row +
                   (long long)(tj * TW + half * PX + a.dx0) * C;
#pragma unroll
    for (int q = 0; q < NLOAD; ++q)
      if (lane + 32 * q < WIN) pre[q] = src[src_off[q]];
  };
  int slot = 0;  // this item's lane in the batch
  int t_cur = __shfl_sync(0xffffffffu, batch, 0);
  if (j < n_items) load_window(t_cur, j);

  while (j < n_items) {
    const int py = (j >> (a.cs + 1)) & (TH - 1);
    const int half = (j >> a.cs) & 1;
    const int ti = t_cur >> 16, tj = t_cur & 0xffff;

    // stage the window planar: value (dy, col, c) at (c*3 + dy)*WP + col
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NLOAD; ++q)
      if (lane + 32 * q < WIN) s_win[dst_off[q]] = cb_to_float(pre[q]);
    __syncwarp();

    // the next item: its tile id (a new batch every 32 items) and window
    const int jn = j + stride;
    int t_next = 0;
    if (jn < n_items) {
      if (++slot == 32) {
        batch = tile_batch(jn);
        slot = 0;
      }
      t_next = __shfl_sync(0xffffffffu, batch, slot);
      load_window(t_next, jn);
    }

    T* dst = out + (long long)(ti * TH + py) * a.out_row +
             (long long)(tj * TW + half * PX) * a.cout + n0;
    for (int pb = pb0; pb < pb1; ++pb) {
      float acc[PB][CC];
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int q = 0; q < CC; ++q) acc[p][q] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float v[C][PB + 2];  // the same for every lane: broadcast loads
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* row = s_win + (c * 3 + dy) * WP + pb * PB;
          const float4 v0 = *reinterpret_cast<const float4*>(row);
          const float4 v1 = *reinterpret_cast<const float4*>(row + 4);
          const float2 v2 = *reinterpret_cast<const float2*>(row + 8);
          v[c][0] = v0.x; v[c][1] = v0.y; v[c][2] = v0.z; v[c][3] = v0.w;
          v[c][4] = v1.x; v[c][5] = v1.y; v[c][6] = v1.z; v[c][7] = v1.w;
          v[c][8] = v2.x; v[c][9] = v2.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int p = 0; p < PB; ++p)
#pragma unroll
              for (int q = 0; q < CC; ++q)
                acc[p][q] = fmaf(v[c][p + dx], wr[(dy * 3 + dx) * C + c][q],
                                 acc[p][q]);
      }
      if (active) {
#pragma unroll
        for (int p = 0; p < PB; ++p) {
          float o[CC];
#pragma unroll
          for (int q = 0; q < CC; ++q) {
            o[q] = acc[p][q] + bv[q];
            if (a.relu) o[q] = fmaxf(o[q], 0.f);
          }
          store_cc<T, CC>(dst + (long long)(pb * PB + p) * a.cout, o);
        }
      }
    }
    j = jn;
    t_cur = t_next;
  }
}

template <typename T, int C>
int launch(const void* st, const int* idx, const int* count, const void* w,
           const float* bias, void* out, int grid, const StemConvArgs& a,
           int cc, cudaStream_t s) {
  const T* st_ = static_cast<const T*>(st);
  const T* w_ = static_cast<const T*>(w);
  T* out_ = static_cast<T*>(out);
  if (cc == 4)
    stem_conv_kernel<T, C, 4><<<grid, THREADS, 0, s>>>(st_, idx, count, w_,
                                                       bias, out_, a);
  else
    stem_conv_kernel<T, C, 1><<<grid, THREADS, 0, s>>>(st_, idx, count, w_,
                                                       bias, out_, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cin(const void* st, const int* idx, const int* count,
               const void* w, const float* bias, void* out, int grid, int cin,
               const StemConvArgs& a, int cc, cudaStream_t s) {
  switch (cin) {
    case 1:
      return launch<T, 1>(st, idx, count, w, bias, out, grid, a, cc, s);
    case 2:
      return launch<T, 2>(st, idx, count, w, bias, out, grid, a, cc, s);
    case 3:
      return launch<T, 3>(st, idx, count, w, bias, out, grid, a, cc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// grid: blocks to launch (>= 1), walking the items of the listed tiles, or
// of all n_tiles tiles when *count > capacity. The channel split is the
// wrapper's (lane_split): a lane takes cc channels (4 of a cout that is a
// multiple of 4, else 1), an 8-pixel block takes `lanes` lanes, a power of
// two up to 32 so that the blocks of an item split the warp evenly, and
// cout takes 1 << cs chunks of lanes * cc channels (1, 2 or 4: a warp
// keeps one chunk, as the grid's warps, 8 a block, are a multiple of
// chunks). Lanes and chunks past cout idle.
extern "C" int cb_stem_conv(const void* storage, const int* idx,
                            const int* count, const void* w,
                            const float* bias, void* out, int grid,
                            int dtype, int cin, int cout, int cc, int lanes,
                            int cs, int tiles_w, int n_tiles, int capacity,
                            int dx0, int relu, long long s_row,
                            long long out_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid <= 0) return 0;
  if (cout < 1 || !(cc == 1 || (cc == 4 && cout % 4 == 0)) || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)) || cs < 0 || cs > 2 ||
      (lanes * cc << cs) < cout || tiles_w > 0xffff)
    return (int)cudaErrorInvalidValue;
  const StemConvArgs a{cout,     lanes, cs,   tiles_w, n_tiles,
                       capacity, dx0,   relu, s_row,   out_row};
  if (dtype == CB_BF16)
    return launch_cin<__nv_bfloat16>(storage, idx, count, w, bias, out, grid,
                                     cin, a, cc, s);
  if (dtype == CB_F32)
    return launch_cin<float>(storage, idx, count, w, bias, out, grid, cin, a,
                             cc, s);
  return (int)cudaErrorInvalidValue;
}
