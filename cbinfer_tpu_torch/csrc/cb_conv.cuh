// The tile convolution shared by the sparse delta conv (delta_conv.cu, B2)
// and the fused delta conv + consumer detect (delta_conv_detect.cu, B6).
//
//   bf16 (the main path): a changed out tile of up to 64 pixels is one
//   CLUSTER of ``csize`` blocks; each block computes slices of n_blk output
//   channels (ops/conv_plan.py holds the plan, from cout alone, and packs
//   the weights). A block has 160 threads:
//     warp 4, the producer: lane 0 streams the block's packed weight slices
//     through a ring of ``stages`` stages of 4 k-steps (16 input channels
//     each) in shared memory, one 1-D bulk copy (cp.async.bulk) per stage,
//     a full and an empty mbarrier per stage, ahead of the MMAs;
//     warps 0-3, one consumer warpgroup: 16-byte cp.async stage the tile's
//     haloed input window (each pixel's channels padded for the bank
//     spread) and, for B6 with one slice a block, the consumer cache's
//     values at the block's channels; then per stage ldmatrix.x4 loads the
//     A fragments of 4 k-steps from the window (16 pixels x 16 channels per
//     warp; a tap's last half step of a cin off the 16-channel grid has its
//     upper half zeroed, and the packed weights there are zero too) and 4
//     wgmma.mma_async m64n{n_blk}k16 (A from registers, B from the ring by
//     descriptor in the 128-byte swizzle, float32 sums) form one commit
//     group; wgmma.wait_group 1 then hands the previous stage back to the
//     producer. The A registers an issued wgmma may still read come in two
//     sets used in turn, each fenced until the wait that retires it. Rows
//     past the tile (th*tw < 64) are computed on pixel 0 and not stored.
//   The epilogue adds the bias, applies ReLU, rounds to bf16 and stores the
//   block's channels into the output cache.
//
//   float32 (the exact-reference mode): one block of 256 threads per tile,
//   the window staged by plain 16-byte loads, CUDA-core FMAs, each thread
//   owning 4 consecutive output channels of 16 tile pixels.
//
// Storage addressing keeps the JAX package's layout: the window of tile
// (ti, tj) starts at storage row ti*th*sh and column tj*tw*sw + dx0 (the
// left margin is 8-aligned, the conv's own padding sits dx0 inside it).
#pragma once

#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;  // float32 blocks

struct ConvArgs {
  int cin, cout, kh, kw, sh, sw, dh, dw, th, tw, win_h, win_w, dx0;
  int tiles_w;
  int sp;             // staged elements per window pixel (cin + bank spread)
  long long s_row;    // storage row stride, elements
  long long out_row;  // out cache row stride, elements
  int relu, has_bias;
};

// The consumer of a fused conv + detect (B6).
struct NextArgs {
  int out_h;         // logical rows of the producer's output
  long long nc_row;  // consumer storage row stride, elements
  int slo_h, slo_w;  // interior origin inside the consumer storage
  CbTileGrid grid;   // the CONSUMER's out-tile grid
};

// Staged elements per window pixel: the channels plus 8 (16 for a cin off
// the 16-channel grid), so that the 8 pixels one ldmatrix phase (or one
// float32 row set) reads fall in different bank groups.
inline int conv_pixel_stride(int cin) { return cin + (cin % 16 ? 16 : 8); }

__device__ __forceinline__ int tile_pixel_base(int p, int dy, int dx,
                                               const ConvArgs& a) {
  int py = p / a.tw, px = p - (p / a.tw) * a.tw;
  return ((py * a.sh + dy * a.dh) * a.win_w + (px * a.sw + dx * a.dw)) * a.sp;
}

// ------------------------------- bf16 ---------------------------------------

constexpr int kWgThreads = 160;    // one consumer warpgroup + a producer warp
constexpr int kStageSteps = 4;     // k-steps per ring stage (STAGE_STEPS)
constexpr int kMaxStages = 4;      // (MAX_STAGES)
constexpr int kSmemHeader = 1024;  // (SMEM_HEADER; 1 KB more aligns the ring)

// ops/conv_plan.py's ConvPlan, less what the kernel does not read.
struct WgPlan {
  int slices, csize, steps, stages;
};

// The header of the dynamic shared memory; the ring (1024-byte aligned),
// the window and (B6) the consumer cache's tile follow it.
struct WgShared {
  unsigned long long full[kMaxStages];
  unsigned long long empty[kMaxStages];
  float part[64];  // B6: per pixel, max |y - cache| over this block's slices
  int flag[64];    // B6: the pixel changed (max over the cluster > tau)
};
static_assert(sizeof(WgShared) <= kSmemHeader, "shared header");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared (16-byte aligned, a multiple of 16 bytes),
// completing on the mbarrier's transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Barrier 1 (0 is __syncthreads) of the consumer warpgroup alone.
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Keep registers an asynchronous wgmma reads untouched up to this point.
__device__ __forceinline__ void fence_operand(uint32_t (&r)[kStageSteps][4]) {
#pragma unroll
  for (int j = 0; j < kStageSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Descriptor of a K-major B operand in the 128-byte swizzle that
// pack_weights lays out: each output channel's 64 input channels of a
// stage are one 128-byte row, 8 rows make a 1024-byte atom in which the
// 16-byte chunk c of row r sits at chunk c ^ r; atoms of 8 output
// channels are 1024 bytes apart (stride byte offset); a k-step of 16
// channels starts 32 bytes into the rows. The ring is 1024-byte aligned.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, float32, the m16n8 accumulator layout per warp) += A (64 x 16,
// bf16, the m16n8k16 A fragment per warp) * B (16 x N by descriptor).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Cluster barrier halves and a float from another block's shared memory
// (distributed shared memory, the same offset in block ``rank``).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float dsmem_load(const float* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// The block's setup: exit with the whole cluster when its tile is past
// *count (every block of a cluster reads the same count), initialise the
// mbarriers. Returns the tile's list position, or -1; ``rank`` is the
// block's rank in its cluster.
__device__ __forceinline__ int wg_begin(const int* __restrict__ count,
                                        const WgPlan& pl, WgShared& sh,
                                        int* rank) {
  const int i = blockIdx.x / pl.csize;
  *rank = blockIdx.x - i * pl.csize;
  if (i >= __ldg(count)) return -1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], 4);  // one arrival per consumer warp
    }
  }
  __syncthreads();
  return i;
}

// The bf16 tile conv of tile (ti, tj) by block ``rank`` of its cluster:
// its slices rank, rank + csize, ... stored into the out cache. kDetect:
// also its per-pixel partial max |y - cache| over its channels against
// the consumer's cache ``nc`` (y the bf16-rounded output), into sh.part;
// rows >= n.out_h are left out. Every thread returns (the producer warp
// reconverged).
template <int N, bool kDetect>
__device__ __forceinline__ void conv_tile_wg(
    const __nv_bfloat16* __restrict__ st, const __nv_bfloat16* __restrict__ wp,
    const float* __restrict__ bias, __nv_bfloat16* out, int ti, int tj,
    int rank, const ConvArgs& a, const WgPlan& pl, WgShared& sh,
    const __nv_bfloat16* nc, const NextArgs& n) {
  constexpr int kStep = N * 16;  // B elements of one k-step
  constexpr int kStage = kStageSteps * kStep;
  constexpr int kNcs = N + 8;    // B6: staged elements per consumer pixel
  unsigned char* base = reinterpret_cast<unsigned char*>(&sh);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(
      base + (((smem_u32(base) + kSmemHeader + 1023) & ~1023u) -
              smem_u32(base)));
  __nv_bfloat16* win = ring + pl.stages * kStage;
  __nv_bfloat16* ncs = win + a.win_h * a.win_w * a.sp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {  // the producer: the block's weight slices
    if (lane == 0) {
      int c = 0;  // stages filled so far, over all slices
      for (int s = rank; s < pl.slices; s += pl.csize) {
        const __nv_bfloat16* src = wp + (long long)s * pl.steps * kStep;
        for (int t0 = 0; t0 < pl.steps; t0 += kStageSteps, ++c) {
          const int stg = c % pl.stages;
          if (c >= pl.stages)
            mbar_wait(&sh.empty[stg], ((c / pl.stages) - 1) & 1);
          mbar_expect_tx(&sh.full[stg], kStage * 2);
          bulk_load(ring + stg * kStage, src + (long long)t0 * kStep,
                    kStage * 2, &sh.full[stg]);
        }
      }
    }
    __syncwarp();
    return;
  }

  // the consumer warpgroup: the tile's window and, for B6 with one slice
  // a block, the consumer cache's values at the block's channels (read in
  // the epilogue), staged with 16-byte cp.async
  const long long ty0 = (long long)ti * a.th, tx0 = (long long)tj * a.tw;
  const bool pre_nc = kDetect && pl.slices <= pl.csize;
  {
    const long long row0 = ty0 * a.sh;
    const long long col0 = tx0 * a.sw + a.dx0;
    const int vpp = a.cin >> 3;  // 16-byte vectors per pixel
    const int total = a.win_h * a.win_w * vpp;
    for (int e = threadIdx.x; e < total; e += 128) {
      const int q = e / vpp, v = e - q * vpp;
      const int r = q / a.win_w, cc = q - r * a.win_w;
      cp_async16(win + q * a.sp + v * 8,
                 st + (row0 + r) * a.s_row + (col0 + cc) * a.cin + v * 8);
    }
    if (pre_nc) {
      const int vecs = min(N, a.cout - rank * N) / 8;
      for (int e = threadIdx.x; e < 64 * vecs; e += 128) {
        const int p = e / vecs, v = e - p * vecs;
        const long long yy = ty0 + (p >> 3);
        if (yy < n.out_h)
          cp_async16(ncs + p * kNcs + v * 8,
                     nc + (yy + n.slo_h) * n.nc_row +
                         (n.slo_w + tx0 + (p & 7)) * a.cout + rank * N +
                         v * 8);
      }
    }
    cp_async_wait_all();
    consumer_barrier();
  }
  const int g = lane >> 2, q = lane & 3;
  const int P = a.th * a.tw;
  // this lane's ldmatrix row: pixel 16*warp + (lane & 15) in the order of
  // the four 8x8 matrices (rows 0-7, rows 8-15; k 0-7, then k 8-15)
  int lp = warp * 16 + (lane & 7) + (lane & 8);
  if (lp >= P) lp = 0;  // rows past the tile: junk, unstored
  const int lpy = lp / a.tw, lpx = lp - lpy * a.tw;
  const uint32_t a_lane =
      smem_u32(win) +
      2 * (((lpy * a.sh) * a.win_w + lpx * a.sw) * a.sp + ((lane >> 4) << 3));
  const uint32_t ring_u32 = smem_u32(ring);
  const int spt = (a.cin + 15) >> 4;  // k-steps per tap
  const bool tail = a.cin & 15;
  float mx[2] = {0.f, 0.f};

  // A registers an issued wgmma may still read: two sets used in turn,
  // each kept untouched (fence_operand) until the wait that retires its
  // stage
  uint32_t af[2][kStageSteps][4];
  const int chunks = pl.steps / kStageSteps;
  int c = 0;  // stages consumed so far, over all slices
  for (int s = rank; s < pl.slices; s += pl.csize) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int kk = 0, dx = 0, dy = 0;  // the next k-step: channels 16*kk of tap
    uint32_t tap = 0;            // (dy, dx), at byte offset tap
    for (int k = 0; k < chunks; k += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (k + u == chunks) break;
        // the stage's A fragments; zero steps pad the last stage
#pragma unroll
        for (int j = 0; j < kStageSteps; ++j) {
          uint32_t* r = af[u][j];
          if (dy < a.kh) {
            ldmatrix_x4(r, a_lane + tap + kk * 32);
            if (tail && kk == spt - 1) r[2] = r[3] = 0u;
            if (++kk == spt) {
              kk = 0;
              if (++dx == a.kw) {
                dx = 0;
                ++dy;
              }
              tap = 2 * ((dy * a.dh * a.win_w + dx * a.dw) * a.sp);
            }
          } else {
            r[0] = r[1] = r[2] = r[3] = 0u;
          }
        }
        const int stg = c % pl.stages;
        mbar_wait(&sh.full[stg], (c / pl.stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kStageSteps; ++j)
          wgmma_rs<N>(acc, af[u][j],
                      b_desc(ring_u32 + 2 * stg * kStage + 32 * j));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        fence_operand(af[u ^ 1]);
        if (k + u > 0 && lane == 0)
          mbar_arrive(&sh.empty[(c - 1) % pl.stages]);
        ++c;
      }
    }
    wgmma_wait<0>();
    fence_operand(af[0]);
    fence_operand(af[1]);
    if (lane == 0) mbar_arrive(&sh.empty[(c - 1) % pl.stages]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");

    // epilogue: bias, ReLU, bf16, scatter into the out cache
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int co = s * N + i * 8 + 2 * q;
      if (co >= a.cout) break;  // groups of 8 are in or out (cout % 8 == 0)
      const float b0 = a.has_bias ? bias[co] : 0.f;
      const float b1 = a.has_bias ? bias[co + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = warp * 16 + g + 8 * h;
        if (p >= P) continue;
        const int py = p / a.tw, px = p - py * a.tw;
        float v0 = acc[4 * i + 2 * h] + b0;
        float v1 = acc[4 * i + 2 * h + 1] + b1;
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (ty0 + py) * a.out_row + (tx0 + px) * a.cout + co) = y;
        if constexpr (kDetect) {
          const long long yy = ty0 + py;
          if (yy < n.out_h) {
            const float2 cv =
                pre_nc ? cb_load2(ncs + p * kNcs + i * 8 + 2 * q)
                       : cb_load2(nc + (yy + n.slo_h) * n.nc_row +
                                  (n.slo_w + tx0 + px) * a.cout + co);
            const float2 yv = __bfloat1622float2(y);
            mx[h] = fmaxf(mx[h],
                          fmaxf(fabsf(yv.x - cv.x), fabsf(yv.y - cv.y)));
          }
        }
      }
    }
  }
  if constexpr (kDetect) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (q == 0) sh.part[warp * 16 + g + 8 * h] = mx[h];
    }
  }
}

// The opt-in above 48 KB of dynamic shared memory is an attribute of a
// kernel on one device: a high-water mark per kernel and device, so that
// streams spread over several cards opt in on each of them.
constexpr int kCbMaxDevices = 64;
constexpr int kCbDefaultSmem = 48 * 1024;
struct SmemMarks {
  int bytes[kCbMaxDevices] = {};
};

// Raise ``kernel``'s opt-in on the current device to ``smem`` bytes if
// its mark there is lower; a launch it would still refuse is reported by
// cudaGetLastError after the launch.
template <typename K>
int set_smem(K kernel, size_t smem, SmemMarks* marks) {
  if ((int)smem <= kCbDefaultSmem) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kCbMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((int)smem <= marks->bytes[dev]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  marks->bytes[dev] = (int)smem;
  return 0;
}

// Launch a bf16 tile-conv kernel: ``tiles`` clusters of pl.csize blocks
// (a plain grid when csize is 1), one launch.
template <typename... P, typename... A>
int launch_wg(void (*kernel)(P...), int tiles, const WgPlan& pl, int smem,
              SmemMarks* marks, cudaStream_t s, A... args) {
  int err = set_smem(kernel, (size_t)smem, marks);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * pl.csize);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.csize > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ------------------------------ float32 -------------------------------------

// Stage the haloed window of tile (ti, tj) into shared memory, pixel-major,
// 16 bytes at a time (the wrapper checks that cin*sizeof(T) is a multiple
// of 16).
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ st,
                                             T* win, int ti, int tj,
                                             const ConvArgs& a) {
  const long long row0 = (long long)ti * a.th * a.sh;
  const long long col0 = (long long)tj * a.tw * a.sw + a.dx0;
  const int vec = 16 / (int)sizeof(T);
  const int pix_vecs = a.cin / vec;
  const int total = a.win_h * a.win_w * pix_vecs;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int q = e / pix_vecs;  // window pixel
    int v = e - q * pix_vecs;
    int r = q / a.win_w;
    int c = q - r * a.win_w;
    const T* src = st + (row0 + r) * a.s_row + (col0 + c) * a.cin + v * vec;
    *reinterpret_cast<uint4*>(win + q * a.sp + v * vec) =
        *reinterpret_cast<const uint4*>(src);
  }
}

// CUDA-core FMAs, 4 output channels x 16 pixels per thread.
constexpr int kCo = 4;
constexpr int kPix = 16;

__device__ __forceinline__ void conv_tile_f32(
    const float* win, const float* __restrict__ w,
    const float* __restrict__ bias, float* out, int ti, int tj,
    const ConvArgs& a, float* ytile, int ys) {
  const int P = a.th * a.tw;
  const int cg = threadIdx.x % 64;  // output-channel group
  const int pg = threadIdx.x / 64;  // pixel group
  for (int co_base = 0; co_base < a.cout; co_base += 64 * kCo) {
    const int co = co_base + cg * kCo;
    if (co >= a.cout) continue;  // no barrier below: idle threads may skip
    float acc[kPix][kCo];
#pragma unroll
    for (int i = 0; i < kPix; ++i)
#pragma unroll
      for (int j = 0; j < kCo; ++j) acc[i][j] = 0.f;
    for (int dy = 0; dy < a.kh; ++dy) {
      for (int dx = 0; dx < a.kw; ++dx) {
        int base[kPix];
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          int p = pg * kPix + i;
          base[i] = tile_pixel_base(p < P ? p : 0, dy, dx, a);
        }
        const float* wt = w + (long long)((dy * a.kw + dx) * a.cin) * a.cout + co;
        for (int ci = 0; ci < a.cin; ++ci) {
          float4 wv = *reinterpret_cast<const float4*>(wt + (long long)ci * a.cout);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            float xv = win[base[i] + ci];
            acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
          }
        }
      }
    }
    const long long ty0 = (long long)ti * a.th;
    const long long tx0 = (long long)tj * a.tw;
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      int p = pg * kPix + i;
      if (p >= P) break;
      int py = p / a.tw, px = p - (p / a.tw) * a.tw;
      float v[kCo];
#pragma unroll
      for (int j = 0; j < kCo; ++j) {
        v[j] = acc[i][j] + (a.has_bias ? bias[co + j] : 0.f);
        if (a.relu) v[j] = fmaxf(v[j], 0.f);
      }
      const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(out + (ty0 + py) * a.out_row +
                                 (tx0 + px) * a.cout + co) = v4;
      if (ytile) *reinterpret_cast<float4*>(ytile + p * ys + co) = v4;
    }
  }
}

}  // namespace
