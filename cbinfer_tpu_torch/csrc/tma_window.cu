// Window copies on the Tensor Memory Accelerator: the DMA-window probes.
//
// Replaces scripts/probe_dma_constraints.py::run_case (P1) and
// run_case_read (P2). Those TPU probes ask which window shapes the chip's
// asynchronous copy engine takes, one DMA per window between VMEM and HBM.
// On Hopper that engine is TMA, and one cp.async.bulk.tensor per window is
// the counterpart: each call encodes one CUtensorMap over the whole
// contiguous bf16 tensor (no interleave, no swizzle) whose box is the
// window, so cuTensorMapEncodeTiled's rules decide which windows the card
// takes: the global address 16-byte aligned, every global stride a
// multiple of 16 bytes, every box extent <= 256 elements, the box's inner
// extent a multiple of 16 bytes. A map that fails to encode is reported
// with its CUresult and nothing is copied; the caller never copies such a
// window another way. The encoder comes through cudaGetDriverEntryPoint,
// so the library needs no -lcuda.
//
// Bound on the H100: not bytes (a window of at most 227 KB moves in
// nanoseconds at 3.35 TB/s) but the launch and the steps of one block in
// order: its fill or load, one copy, the wait before it exits. So the
// design keeps every thread's work short and leaves the copies to the copy
// engine.
//
// P1 (write). The first design filled the tile with one 2-byte store an
// element, each after an integer modulo by the run-time inner extent and
// an int -> float -> bf16 conversion (64 of them a thread for a 32 KB
// box), then waited for the store to reach device memory. Now: a box that
// encodes has rows of vpr = inner / 8 whole 16-byte vectors (1 <= vpr <=
// 32), and the block is vpr x rows-a-step threads (write_plan in
// ops/kernels/tma_window.py, passed in as ``threads``): thread (x, y) owns
// column x, builds its eight ramp values 8x+1 .. 8x+8 once in registers
// (exact in bf16 up to 256) and stores that 16-byte vector into rows y,
// y + rows-a-step, ...; a warp's 32 stores are 512 consecutive bytes. The
// issuing thread prefetches the tensor map at entry so its fetch overlaps
// the fill; after the proxy fence and the barrier it issues the store and
// waits only until the copy engine has read the tile (wait_group.read):
// the kernel's completion makes the writes visible to the next kernel on
// the stream.
// P2 (read). The first design had 256 threads spin on the mbarrier, then
// copy the tile out with 16-byte stores. Now one thread of one warp does
// everything on the copy engine, as the TPU kernel's two DMAs: it prefetches
// the map, initialises and arms the mbarrier with the box's bytes, loads
// the window (cp.async.bulk.tensor, global to shared), waits on the
// barrier, and copies the tile to the dense output with one bulk copy
// (cp.async.bulk, shared to global; the output comes from torch.empty, so
// it is 16-byte aligned, and the box's bytes are a multiple of 16), waiting
// again only on the read of shared memory.
#include <cuda.h>

#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;  // P1's most threads (write_plan's cap)
constexpr int kReadThreads = 32;  // P2: one warp, one thread of it busy
constexpr int kMaxRank = 5;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The window in the map's order (innermost first): its origin and the
// box's sizes.
struct Box {
  int rank;
  int c[kMaxRank];  // origin coordinates, innermost first
  int inner;        // elements of the innermost extent
  int bytes;        // bytes of the box (a multiple of 16 once encoded)
};

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a contiguous bf16 tensor (``shape`` outermost first) with the
// box ``box`` (outermost first).
CUresult encode(EncodeTiledFn fn, CUtensorMap* map, void* base, int rank,
                const long long* shape, const int* box) {
  cuuint64_t dims[kMaxRank], strides[kMaxRank];
  cuuint32_t boxd[kMaxRank], estr[kMaxRank];
  cuuint64_t stride = sizeof(__nv_bfloat16);
  for (int i = 0; i < rank; ++i) {
    const int d = rank - 1 - i;
    dims[i] = (cuuint64_t)shape[d];
    boxd[i] = (cuuint32_t)box[d];
    estr[i] = 1;
    if (i > 0) strides[i - 1] = stride;  // bytes between steps of dim i
    stride *= (cuuint64_t)shape[d];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, base,
            dims, strides, boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

Box make_box(int rank, const long long* start, const int* box) {
  Box b{};
  b.rank = rank;
  int elems = 1;
  for (int i = 0; i < rank; ++i) {
    b.c[i] = (int)start[rank - 1 - i];
    elems *= box[i];
  }
  b.inner = box[rank - 1];
  b.bytes = elems * (int)sizeof(__nv_bfloat16);
  return b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async.bulk.tensor store of the shared tile into the map's window.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* tile, const Box& b) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const uint32_t s = smem_addr(tile);
  const int* c = b.c;
  switch (b.rank) {
    case 1:
      asm volatile(
          "cp.async.bulk.tensor.1d.global.shared::cta.bulk_group"
          " [%0, {%2}], [%1];" ::"l"(m), "r"(s), "r"(c[0])
          : "memory");
      break;
    case 2:
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
          " [%0, {%2, %3}], [%1];" ::"l"(m), "r"(s), "r"(c[0]), "r"(c[1])
          : "memory");
      break;
    case 3:
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4}], [%1];" ::"l"(m), "r"(s), "r"(c[0]),
          "r"(c[1]), "r"(c[2])
          : "memory");
      break;
    case 4:
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(m), "r"(s), "r"(c[0]),
          "r"(c[1]), "r"(c[2]), "r"(c[3])
          : "memory");
      break;
    default:
      asm volatile(
          "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(m), "r"(s), "r"(c[0]),
          "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4])
          : "memory");
  }
}

// Closes the bulk group of the copies issued so far and waits until the
// copy engine has read their shared-memory source (not until their writes
// reach device memory: the kernel's completion covers those).
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Starts fetching a __grid_constant__ tensor map into the descriptor cache.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Two bf16 values in one 32-bit word, ``lo`` at the lower address.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cp.async.bulk.tensor load of the map's window into the shared tile,
// completing on ``bar``'s transaction count.
__device__ __forceinline__ void tma_load(void* tile, const CUtensorMap* map,
                                         unsigned long long* bar,
                                         const Box& b) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const uint32_t s = smem_addr(tile);
  const uint32_t k = smem_addr(bar);
  const int* c = b.c;
  switch (b.rank) {
    case 1:
      asm volatile(
          "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3}], [%2];" ::"r"(s),
          "l"(m), "r"(k), "r"(c[0])
          : "memory");
      break;
    case 2:
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(s),
          "l"(m), "r"(k), "r"(c[0]), "r"(c[1])
          : "memory");
      break;
    case 3:
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(s),
          "l"(m), "r"(k), "r"(c[0]), "r"(c[1]), "r"(c[2])
          : "memory");
      break;
    case 4:
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(s),
          "l"(m), "r"(k), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3])
          : "memory");
      break;
    default:
      asm volatile(
          "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(
              s),
          "l"(m), "r"(k), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]),
          "r"(c[4])
          : "memory");
  }
}

// Block (vpr, rows a step): thread (x, y) fills vector column x of rows y,
// y + blockDim.y, ... of the box's dense tile.
__global__ void __launch_bounds__(kThreads)
tma_window_write_kernel(const __grid_constant__ CUtensorMap map, Box b) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const bool issuer = threadIdx.x == 0 && threadIdx.y == 0;
  if (issuer) prefetch_map(&map);
  const float v = (float)(8 * threadIdx.x + 1);
  const uint4 ramp = make_uint4(pack_bf16x2(v, v + 1.f),
                                pack_bf16x2(v + 2.f, v + 3.f),
                                pack_bf16x2(v + 4.f, v + 5.f),
                                pack_bf16x2(v + 6.f, v + 7.f));
  uint4* tile = reinterpret_cast<uint4*>(smem_raw);
  const uint4* end = tile + (b.bytes >> 4);
  const int step = blockDim.x * blockDim.y;
  for (uint4* p = tile + threadIdx.y * blockDim.x + threadIdx.x; p < end;
       p += step)
    *p = ramp;
  // the copy engine (the async proxy) reads what these stores wrote
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (issuer) {
    tma_store(&map, smem_raw, b);
    bulk_commit_wait_read();
  }
}

__global__ void __launch_bounds__(kReadThreads)
tma_window_read_kernel(const __grid_constant__ CUtensorMap map, Box b,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if (threadIdx.x != 0) return;
  prefetch_map(&map);
  // after the tile: b.bytes is a multiple of 16
  auto* bar = reinterpret_cast<unsigned long long*>(smem_raw + b.bytes);
  const uint32_t k = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(k) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   k),
               "r"(b.bytes)
               : "memory");
  tma_load(smem_raw, &map, bar, b);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(k)
        : "memory");
  }
  // the second copy reads the tile through the async proxy, after this
  // thread observed the load complete
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(reinterpret_cast<uint64_t>(out)),
               "r"(smem_addr(smem_raw)), "r"(b.bytes)
               : "memory");
  bulk_commit_wait_read();
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// ``shape`` (rank entries, outermost first) of the contiguous bf16 tensor
// at ``base``; the window starts at ``start`` and spans ``box``; the block
// has ``threads`` threads (write_plan: a multiple of the box row's 16-byte
// vectors, at most 256). Returns a CUDA error code; ``*cu_result`` is the
// encoder's CUresult, and when it is not 0 (CUDA_SUCCESS) nothing was
// launched.
extern "C" int cb_tma_window_write(void* base, int rank,
                                   const long long* shape,
                                   const long long* start, const int* box,
                                   int threads, int* cu_result,
                                   void* stream) {
  *cu_result = 0;
  if (rank < 1 || rank > kMaxRank) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const CUresult r = encode(fn, &map, base, rank, shape, box);
  if (r != CUDA_SUCCESS) {
    *cu_result = (int)r;
    return 0;
  }
  const Box b = make_box(rank, start, box);
  const int vpr = b.inner / 8;  // 16-byte vectors a row: the map encoded
  if (threads < vpr || threads > kThreads || threads % vpr)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)tma_window_write_kernel, b.bytes);
  if (err) return err;
  tma_window_write_kernel<<<1, dim3(vpr, threads / vpr), b.bytes,
                            static_cast<cudaStream_t>(stream)>>>(map, b);
  return (int)cudaGetLastError();
}

// As cb_tma_window_write, the window copied into the dense ``out`` (the
// box's shape, 16-byte aligned).
extern "C" int cb_tma_window_read(const void* base, int rank,
                                  const long long* shape,
                                  const long long* start, const int* box,
                                  void* out, int* cu_result, void* stream) {
  *cu_result = 0;
  if (rank < 1 || rank > kMaxRank) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map;
  const CUresult r =
      encode(fn, &map, const_cast<void*>(base), rank, shape, box);
  if (r != CUDA_SUCCESS) {
    *cu_result = (int)r;
    return 0;
  }
  const Box b = make_box(rank, start, box);
  // the bulk copy's global address
  if (reinterpret_cast<uintptr_t>(out) % 16) return (int)cudaErrorInvalidValue;
  const int smem = b.bytes + 16;  // the tile, then the mbarrier
  int err = set_smem((const void*)tma_window_read_kernel, smem);
  if (err) return err;
  tma_window_read_kernel<<<1, kReadThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      map, b, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
