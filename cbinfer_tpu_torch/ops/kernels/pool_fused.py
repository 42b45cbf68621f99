"""Hint-forwarded max pool over the producer's dirty 8x16 blocks (B3).

Replaces ``cbinfer_tpu/ops/pallas/delta_pool.py::detect_pool_fused``. The
CUDA source (``csrc/pool_fused.cu``) carries the design note: bytes bound
it; a grid sized to the card walks the device-side count, every thread
issues all its 16-byte pool loads before the max, and a block marks the
one out tile each dirty block touches.
"""

from __future__ import annotations

import ctypes

import torch

from ..delta_conv import tile_ids
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

# blocks of 256 threads per SM: at C = 256 in bf16 a thread holds 16
# 16-byte loads (64 registers), so two blocks fit an SM
BLOCKS_PER_SM = 2

KERNEL = Kernel(name="detect_pool_fused", route="cuda",
                source="cbinfer_tpu_torch/csrc/pool_fused.cu",
                replaces="cbinfer_tpu/ops/pallas/delta_pool.py:191")


def _check_geometry(g: TileGeometry, hint_h: int, hint_w: int) -> int:
    """The JAX kernel's static contract: an aligned pool whose pooled
    block is exactly one (or a divisor of one) 8x8 out tile."""
    pool = g.stride[0]
    if not (g.kernel == (pool, pool) and g.stride == (pool, pool)
            and hint_h % pool == 0 and hint_w % pool == 0
            and 8 % (hint_h // pool) == 0 and hint_w // pool == 8
            and g.in_w % hint_w == 0 and g.in_h % hint_h == 0
            and g.th == 8 and g.tw == 8):
        raise ValueError(f"detect_pool_fused: unsupported geometry {g} "
                         f"for blocks {hint_h}x{hint_w}")
    return pool


def detect_pool_fused_plain(x: torch.Tensor, out_cache: torch.Tensor,
                            idx: torch.Tensor, count: torch.Tensor,
                            g: TileGeometry, *, hint_h: int = 8,
                            hint_w: int = 16):
    """Plain PyTorch version. Updates ``out_cache`` in place; returns
    (out_cache, mask f32 (tiles_h, tiles_w))."""
    pool = _check_geometry(g, hint_h, hint_w)
    oh, ow = hint_h // pool, hint_w // pool
    blocks_w = g.in_w // hint_w
    ids = tile_ids(idx, count)
    hi, hj = ids // blocks_w, ids % blocks_w
    dev = x.device
    rows = hi[:, None] * hint_h + torch.arange(hint_h, device=dev)
    cols = hj[:, None] * hint_w + torch.arange(hint_w, device=dev)
    blk = x.to(out_cache.dtype)[rows[:, :, None], cols[:, None, :]]
    C = out_cache.shape[-1]
    y = blk.reshape(-1, oh, pool, ow, pool, C).amax(dim=(2, 4))
    out_cache.view(g.out_h_pad // oh, oh, g.out_w_pad // ow, ow, C)[
        hi, :, hj] = y
    mask = torch.zeros((g.tiles_h, g.tiles_w), dtype=torch.float32,
                       device=dev)
    mask[(hi * oh) // 8, (hj * ow) // 8] = 1.0
    return out_cache, mask


def _fn():
    f = library("pool_fused").cb_pool_fused
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 5 + [i] * 9 + [ll, ll, vp]
        f.restype = ctypes.c_int
    return f


def detect_pool_fused(x: torch.Tensor, out_cache: torch.Tensor,
                      idx: torch.Tensor, count: torch.Tensor,
                      g: TileGeometry, *, hint_h: int = 8, hint_w: int = 16):
    """Pool the producer's dirty (hint_h, hint_w) blocks ``idx[:count]``
    (ids on the (H/hint_h, W/hint_w) block grid) into ``out_cache``,
    UPDATED IN PLACE (the JAX package donates and aliases it). ``x`` may be
    the producer's padded out cache. Returns (out_cache, mask f32)."""
    if x.device.type == "cpu" and out_cache.device.type == "cpu":
        return detect_pool_fused_plain(x, out_cache, idx, count, g,
                                       hint_h=hint_h, hint_w=hint_w)
    pool = _check_geometry(g, hint_h, hint_w)
    x = x.to(out_cache.dtype)  # the JAX kernel pools in the cache dtype
    C = out_cache.shape[-1]
    if not all(t.is_cuda for t in (x, out_cache, idx, count)):
        raise ValueError("detect_pool_fused: tensors must all be on the card")
    if (out_cache.dtype not in DTYPE_CODE or x.shape[-1] != C or C % 2
            or x.shape[0] < g.in_h or x.shape[1] < g.in_w
            or tuple(out_cache.shape) != (g.out_h_pad, g.out_w_pad, C)
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1
            or idx.numel() > (g.in_h // hint_h) * (g.in_w // hint_w)
            or x.data_ptr() % 4 or out_cache.data_ptr() % 4):
        raise ValueError(
            f"detect_pool_fused: unsupported operands x{tuple(x.shape)} "
            f"out{tuple(out_cache.shape)} {out_cache.dtype} "
            f"idx{tuple(idx.shape)} {idx.dtype}")
    for t in (x, out_cache, idx):
        if not t.is_contiguous():
            raise ValueError("detect_pool_fused: operands must be contiguous")
    mask = torch.zeros((g.tiles_h, g.tiles_w), dtype=torch.float32,
                       device=out_cache.device)
    stream = torch.cuda.current_stream(out_cache.device).cuda_stream
    grid = walk_grid(idx.numel(), sm_count(out_cache.device.index),
                     BLOCKS_PER_SM)
    err = _fn()(x.data_ptr(), out_cache.data_ptr(), idx.data_ptr(),
                count.data_ptr(), mask.data_ptr(), idx.numel(), grid,
                DTYPE_CODE[out_cache.dtype], C, g.in_w // hint_w, hint_h,
                hint_w, pool, g.tiles_w, x.shape[1] * C, g.out_w_pad * C,
                stream)
    check(err, "detect_pool_fused")
    KERNEL.launches += 1
    return out_cache, mask
