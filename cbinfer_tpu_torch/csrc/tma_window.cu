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
// P1 (write): one block fills a shared tile, the box in its dense order, with
// the ramp lane + 1 of its innermost extent, fences it for the async proxy,
// and one thread stores it into the window (cp.async.bulk.tensor, shared to
// global, one bulk group) and waits for the group.
// P2 (read): one thread arms an mbarrier with the box's bytes and loads the
// window (cp.async.bulk.tensor, global to shared); every thread waits on
// the barrier, then the block stores the tile into the dense output with
// 16-byte stores (a box row is a multiple of 16 bytes).
//
// Bound on the H100: bytes, the window written once (P1) or read and
// written once (P2), at most tens of KB here, so a launch costs its
// latency. These probes ask what the copy engine accepts, not how fast it
// is: one block and one copy per call is enough.
#include <cuda.h>

#include "cb_common.cuh"

namespace {

constexpr int kThreads = 256;
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
  int elems;        // elements of the box
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
  b.elems = 1;
  for (int i = 0; i < rank; ++i) {
    b.c[i] = (int)start[rank - 1 - i];
    b.elems *= box[i];
  }
  b.inner = box[rank - 1];
  b.bytes = b.elems * (int)sizeof(__nv_bfloat16);
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
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
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

__global__ void __launch_bounds__(kThreads)
tma_window_write_kernel(const __grid_constant__ CUtensorMap map, Box b) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  for (int e = threadIdx.x; e < b.elems; e += blockDim.x)
    tile[e] = __float2bfloat16_rn((float)(e % b.inner + 1));
  // the copy engine (the async proxy) reads what these stores wrote
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) tma_store(&map, tile, b);
}

__global__ void __launch_bounds__(kThreads)
tma_window_read_kernel(const __grid_constant__ CUtensorMap map, Box b,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // after the tile: b.bytes is a multiple of 16
  auto* bar = reinterpret_cast<unsigned long long*>(smem_raw + b.bytes);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(b.bytes)
        : "memory");
    tma_load(tile, &map, bar, b);
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int v = threadIdx.x; v < b.bytes / 16; v += blockDim.x) dst[v] = src[v];
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// ``shape`` (rank entries, outermost first) of the contiguous bf16 tensor
// at ``base``; the window starts at ``start`` and spans ``box``. Returns a
// CUDA error code; ``*cu_result`` is the encoder's CUresult, and when it is
// not 0 (CUDA_SUCCESS) nothing was launched.
extern "C" int cb_tma_window_write(void* base, int rank,
                                   const long long* shape,
                                   const long long* start, const int* box,
                                   int* cu_result, void* stream) {
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
  int err = set_smem((const void*)tma_window_write_kernel, b.bytes);
  if (err) return err;
  tma_window_write_kernel<<<1, kThreads, b.bytes,
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
  const int smem = b.bytes + 16;  // the tile, then the mbarrier
  int err = set_smem((const void*)tma_window_read_kernel, smem);
  if (err) return err;
  tma_window_read_kernel<<<1, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      map, b, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
