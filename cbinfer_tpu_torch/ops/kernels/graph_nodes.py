"""Reading the CUDA graph that a stream is capturing into
(``csrc/graph_nodes.cu``, host code only, no kernel).

``node_count(stream)`` is the capturing graph's node count, which every
scope notes at its entry and exit while the runner captures
(``layers.StageRecorder``); ``nodes(stream)`` lists each node at the end of
the capture: its kind and, for a kernel node, the function's name
demangled as the profiler prints it. ``stream`` is a ``cudaStream_t`` as
an int (``torch.cuda.current_stream().cuda_stream``).
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Optional, Tuple

from .build import library

# cudaGraphNodeType -> the kind of device activity the node runs as; the
# other nodes (host, empty, event, child graph ...) run none
ACTIVITY_KIND = {0: "kernel", 1: "memcpy", 2: "memset"}


def _lib() -> ctypes.CDLL:
    lib = library("graph_nodes")
    if not getattr(lib, "_typed", False):
        lib.cb_graph_nodes_init.restype = ctypes.c_int
        lib.cb_graph_node_count.restype = ctypes.c_longlong
        lib.cb_graph_node_count.argtypes = [ctypes.c_void_p]
        lib.cb_graph_nodes.restype = ctypes.c_longlong
        lib.cb_graph_nodes.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        lib._typed = True
    return lib


def prepare() -> None:
    """Call before a capture: a capture must not be the library's first
    CUDA call. (Where CUDA gives no kernel names, ``nodes`` gives
    None for each.)"""
    if _lib().cb_graph_nodes_init() < 0:
        raise RuntimeError("graph_nodes: CUDA error at start")


def node_count(stream: int) -> int:
    """Nodes of the graph ``stream`` is capturing into."""
    n = _lib().cb_graph_node_count(stream)
    if n < 0:
        raise RuntimeError(f"graph_nodes: stream {stream:#x} captures no "
                           "graph" if n == -1 else "graph_nodes: CUDA error")
    return n


def nodes(stream: int) -> List[Tuple[int, Optional[str]]]:
    """(cudaGraphNodeType, kernel name or None) of every node of the graph
    ``stream`` is capturing into, in the order they were added."""
    lib = _lib()
    n = node_count(stream)
    types = (ctypes.c_int * max(n, 1))()
    size = 256 * max(n, 1)
    need = ctypes.c_longlong(0)
    while True:
        buf = ctypes.create_string_buffer(size)
        got = lib.cb_graph_nodes(stream, n, types, buf, size,
                                 ctypes.byref(need))
        if got != n:
            raise RuntimeError(f"graph_nodes: listed {got} of {n} nodes")
        if need.value <= size:
            break
        size = need.value
    # a chunk's graph repeats each kernel once a frame: one string each
    names = [sys.intern(b.decode()) for b in
             buf.raw[:need.value].split(b"\0")[:n]]
    return [(types[i], names[i] or None) for i in range(n)]
