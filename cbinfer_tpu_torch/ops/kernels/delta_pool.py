"""Change-based max pool over the changed out tiles (B8).

Replaces ``cbinfer_tpu/ops/pallas/delta_pool.py::delta_pool_pallas``. The
CUDA source (``csrc/delta_pool.cu``) carries the design note: bytes bound
it; a grid sized to the card walks the device-side count, and every thread
issues all its 16-byte window loads before the max, straight from the
padded storage.
"""

from __future__ import annotations

import ctypes

import torch

from ..delta_conv import tile_ids
from ..delta_pool import delta_pool_jnp
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

# blocks of 256 threads per SM, as B3's: at C = 128 in bf16 a thread holds
# 16 16-byte loads (64 registers), so two blocks fit an SM
BLOCKS_PER_SM = 2

KERNEL = Kernel(name="delta_pool", route="cuda",
                source="cbinfer_tpu_torch/csrc/delta_pool.cu",
                replaces="cbinfer_tpu/ops/pallas/delta_pool.py:261")


def delta_pool_plain(storage: torch.Tensor, idx: torch.Tensor,
                     out_cache: torch.Tensor, g: TileGeometry, *,
                     count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, windowed max, scatter into
    ``out_cache`` in place."""
    return delta_pool_jnp(storage, tile_ids(idx, count), out_cache, g)


def _fn():
    f = library("delta_pool").cb_delta_pool
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 4 + [i] * 12 + [ll, ll, vp]
        f.restype = ctypes.c_int
    return f


def delta_pool(storage: torch.Tensor, idx: torch.Tensor,
               out_cache: torch.Tensor, g: TileGeometry, *,
               count: torch.Tensor) -> torch.Tensor:
    """Fused gather + max pool + scatter over ``idx[:count]``.

    storage: (Hs, Ws, C) padded input cache of the pool; out_cache:
    (out_h_pad, out_w_pad, C), UPDATED IN PLACE (the JAX package donates
    and aliases it) — tiles not listed are never touched. ``count`` is a
    device int32 scalar. On the card both caches share one dtype."""
    if storage.device.type == "cpu" and out_cache.device.type == "cpu":
        return delta_pool_plain(storage, idx, out_cache, g, count=count)
    tensors = (storage, idx, out_cache, count)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("delta_pool: tensors must all be on the card")
    dtype, C = storage.dtype, storage.shape[-1]
    if (dtype not in DTYPE_CODE or out_cache.dtype != dtype or C % 2
            or tuple(storage.shape) != g.store_shape[:2] + (C,)
            or tuple(out_cache.shape) != (g.out_h_pad, g.out_w_pad, C)
            or g.dilation != (1, 1)
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1 or idx.numel() > g.n_tiles
            or storage.data_ptr() % 4 or out_cache.data_ptr() % 4):
        raise ValueError(
            f"delta_pool: unsupported operands storage{tuple(storage.shape)} "
            f"{dtype} out{tuple(out_cache.shape)} {out_cache.dtype} "
            f"idx{tuple(idx.shape)} {idx.dtype} for {g}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("delta_pool: operands must be contiguous")
    kh, kw = g.kernel
    sh, sw = g.stride
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    grid = walk_grid(idx.numel(), sm_count(storage.device.index),
                     BLOCKS_PER_SM)
    err = _fn()(storage.data_ptr(), idx.data_ptr(), count.data_ptr(),
                out_cache.data_ptr(), idx.numel(), grid, DTYPE_CODE[dtype],
                C, g.tiles_w, g.th, g.tw, kh, kw, sh, sw, g.dx0,
                storage.shape[1] * C, g.out_w_pad * C, stream)
    check(err, "delta_pool")
    KERNEL.launches += 1
    return out_cache
