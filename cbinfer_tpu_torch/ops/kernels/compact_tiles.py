"""Stream compaction of a tile mask (the compact layer's kernel).

Replaces the sort of ``cbinfer_tpu/ops/compact.py::compact_mask``. The CUDA
source (``csrc/compact_tiles.cu``) carries the design note: one block of
1,024 threads scans the flags (16 a thread a pass, a warp scan by
shuffles, one scan of the warp totals in shared memory) and writes the ids
of the set flags in row-major order, the sentinel ``n_tiles`` after them.
Latency bounds it: the masks of the paths are a few KB. The plain version
is the JAX package's sort, and the kernel's result is the sort's, bit for
bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import Kernel
from .build import check, library

THREADS = 1024          # of the one block (kThreads in csrc/compact_tiles.cu)
FLAGS = 16              # flags a thread loads in a pass (one 16-byte vector)
PASS = THREADS * FLAGS  # flags a pass covers; larger masks take more passes

KERNEL = Kernel(name="compact_tiles", route="cuda",
                source="cbinfer_tpu_torch/csrc/compact_tiles.cu",
                replaces="cbinfer_tpu/ops/compact.py:26")

_BIG = 1 << 30  # > any n_tiles, < int32 max


def compact_tiles_plain(mask: torch.Tensor, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (same result as the kernel), the JAX
    package's sort: changed tiles keep their ids as keys, unchanged tiles
    get a beyond-range key, so an ascending sort packs the changed ids to
    the front in row-major order and the tail holds the sentinel
    ``n_tiles``."""
    n_tiles = mask.numel()
    flat = mask.reshape(-1)
    ids = torch.arange(n_tiles, dtype=torch.int32, device=mask.device)
    key = torch.where(flat, ids, _BIG)
    # unchanged keys are _BIG > n_tiles: clamping them IS the sentinel
    idx = torch.sort(key).values[:capacity].clamp_(max=n_tiles)
    return idx.contiguous(), flat.sum(dtype=torch.int32)


def _fn():
    f = library("compact_tiles").cb_compact_tiles
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp, vp, vp, i, i, ll, ll, i, i, vp]
        f.restype = ctypes.c_int
    return f


def compact_tiles(mask: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bool tile mask -> (idx, count): ``idx`` (min(capacity, n_tiles),)
    int32, the flat row-major ids of the set flags in ascending order,
    then ``n_tiles`` to the end; ``count`` a 0-d int32 device tensor, the
    number of set flags (it may exceed ``capacity``). Any layout of the
    mask is taken (a strided view is read through its strides). No host
    read: the outputs are made with ``torch.empty`` and the kernel writes
    every entry, so the call captures into a CUDA graph."""
    n_tiles = mask.numel()
    if mask.dtype != torch.bool:
        raise ValueError(f"compact_tiles: the mask must be bool, not "
                         f"{mask.dtype}")
    if capacity < 0:
        raise ValueError(f"compact_tiles: capacity {capacity} < 0")
    if mask.device.type == "cpu":
        return compact_tiles_plain(mask, capacity)
    if not mask.is_cuda:
        raise ValueError("compact_tiles: the mask must be on the card")
    capacity = min(capacity, n_tiles)  # the sort's slice
    # a 2-D view: rows of the last dimension (a copy only where the
    # leading dimensions do not merge into one stride)
    view = (mask.reshape(-1, mask.shape[-1]) if mask.dim() and n_tiles
            else mask.reshape(-1, 1))
    cols = view.shape[1]
    contiguous = view.is_contiguous()
    s_row, s_col = (cols, 1) if contiguous else view.stride()
    vec16 = contiguous and view.data_ptr() % 16 == 0
    idx = torch.empty(capacity, dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    err = _fn()(view.data_ptr(), idx.data_ptr(), count.data_ptr(), n_tiles,
                cols, s_row, s_col, capacity, int(vec16), stream)
    check(err, "compact_tiles")
    KERNEL.launches += 1
    return idx, count
