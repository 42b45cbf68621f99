// Reading the CUDA graph that a stream is capturing into: host code only,
// no kernel.
//
// The runner captures each chunk's frame loop into a CUDA graph, and a
// profile of a replay names the graph's device activities by kernel alone.
// While it captures, every scope of the program (layers.stage) notes the
// capturing graph's node count at its entry and exit
// (cb_graph_node_count), so the nodes added while a scope is innermost
// belong to it; at the end of the capture cb_graph_nodes lists each node's
// type and, for a kernel node, its function's name demangled as the
// profiler prints it. Both only read the graph, which is allowed while the
// capture runs (cudaStreamGetCaptureInfo: every operation but destroying
// the graph or removing a node).
//
// The graph is read through the runtime API: a stream and a graph are the
// same objects whichever runtime made them. A kernel node's function is
// read through the low-level cu* API (cuGraphKernelNodeGetParams,
// cuKernelGetFunction, cuFuncGetName), since most kernels of a capture are
// PyTorch's or cuBLAS's and unknown to this library's runtime; those
// functions come through cudaGetDriverEntryPoint, so the library needs no
// -lcuda.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cxxabi.h>

#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef CUresult (*KernelParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
typedef CUresult (*KernelFunctionFn)(CUfunction*, CUkernel);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);

// The profiler leaves a longer mangled name as it is (kineto's demangle).
constexpr size_t kMaxDemangled = 1024;

void* cu_fn(const char* name, unsigned version) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, &p, version, cudaEnableDefault, &q);
#else
  (void)version;
  const cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                                &q);
#endif
  return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? p
                                                                : nullptr;
}

struct CuApi {
  KernelParamsFn params = nullptr;
  KernelFunctionFn function = nullptr;
  FuncNameFn name = nullptr;
};

const CuApi& cu_api() {
  static const CuApi d = [] {
    CuApi r;
    r.params = reinterpret_cast<KernelParamsFn>(
        cu_fn("cuGraphKernelNodeGetParams", 12000));
    r.function = reinterpret_cast<KernelFunctionFn>(
        cu_fn("cuKernelGetFunction", 12000));
    r.name = reinterpret_cast<FuncNameFn>(cu_fn("cuFuncGetName", 12030));
    return r;
  }();
  return d;
}

// The graph ``stream`` is capturing into, or null when it captures none.
cudaGraph_t capturing(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               nullptr, &graph, nullptr,
                               nullptr) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive) {
    return nullptr;
  }
  return graph;
}

// A kernel node's mangled function name, or null where CUDA gives none.
const char* mangled_name(cudaGraphNode_t node) {
  const CuApi& d = cu_api();
  if (d.params == nullptr || d.name == nullptr) return nullptr;
  CUDA_KERNEL_NODE_PARAMS_v2 p;
  std::memset(&p, 0, sizeof p);
  if (d.params(reinterpret_cast<CUgraphNode>(node), &p) != CUDA_SUCCESS) {
    return nullptr;
  }
  CUfunction f = p.func;
  if (f == nullptr && p.kern != nullptr && d.function != nullptr &&
      d.function(&f, p.kern) != CUDA_SUCCESS) {
    f = nullptr;
  }
  const char* name = nullptr;
  if (f == nullptr || d.name(&name, f) != CUDA_SUCCESS) return nullptr;
  return name;
}

}  // namespace

// Before a capture: starts this library's runtime on the current device
// (a capture must not be the first call) and looks up the cu*
// functions. Returns 0 when kernel names can be read, 1 when only types
// can, -2 on a CUDA error.
extern "C" int cb_graph_nodes_init() {
  if (cudaFree(nullptr) != cudaSuccess) return -2;
  const CuApi& d = cu_api();
  return (d.params != nullptr && d.name != nullptr) ? 0 : 1;
}

// Nodes of the graph ``stream`` is capturing into; -1 when it captures
// none, -2 on a CUDA error.
extern "C" long long cb_graph_node_count(void* stream) {
  cudaGraph_t graph = capturing(stream);
  if (graph == nullptr) return -1;
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) return -2;
  return static_cast<long long>(n);
}

// Every node of the graph ``stream`` is capturing into, in the graph's
// order (the order they were added): ``types[i]``, node i's
// cudaGraphNodeType (the first ``max_nodes``); ``names``, their names one
// after another, each ending in a NUL: a kernel node's function name
// demangled as the profiler prints it, "" for any other node and for a
// name CUDA does not give. ``*names_need`` is the bytes all names
// take; they are written only if that is at most ``names_bytes``. Returns
// the node count, -1 when the stream captures no graph, -2 on a CUDA
// error.
extern "C" long long cb_graph_nodes(void* stream, long long max_nodes,
                                    int* types, char* names,
                                    long long names_bytes,
                                    long long* names_need) {
  cudaGraph_t graph = capturing(stream);
  if (graph == nullptr) return -1;
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) return -2;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && cudaGraphGetNodes(graph, nodes.data(), &n) != cudaSuccess) {
    return -2;
  }
  const bool fits_types = static_cast<long long>(n) <= max_nodes;
  std::vector<char> out;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) return -2;
    if (fits_types) types[i] = static_cast<int>(type);
    const char* mangled =
        type == cudaGraphNodeTypeKernel ? mangled_name(nodes[i]) : nullptr;
    char* demangled = nullptr;
    if (mangled != nullptr && std::strlen(mangled) <= kMaxDemangled) {
      int status = 0;
      demangled = abi::__cxa_demangle(mangled, nullptr, nullptr, &status);
      if (status != 0) demangled = nullptr;
    }
    const char* name = demangled ? demangled : (mangled ? mangled : "");
    out.insert(out.end(), name, name + std::strlen(name) + 1);
    std::free(demangled);
  }
  *names_need = static_cast<long long>(out.size());
  if (*names_need <= names_bytes && !out.empty()) {
    std::memcpy(names, out.data(), out.size());
  }
  return static_cast<long long>(n);
}
