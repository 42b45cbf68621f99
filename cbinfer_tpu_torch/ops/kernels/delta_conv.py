"""Sparse delta convolution over the changed out tiles (B2).

Replaces ``cbinfer_tpu/ops/pallas/delta_conv.py::delta_conv_pallas``. The
CUDA source (``csrc/delta_conv.cu``) carries the design note: operations
bound it on the H100; in bf16 a thread-block cluster per changed tile
splits its cout (``ops/conv_plan.py``), each block staging the haloed
window and its slice of the packed weights in shared memory with bulk
copies and running wgmma (float32 sums); float32 caches take one block per
tile on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..conv_plan import conv_plan, packed_weights
from ..delta_conv import conv_tiles, gather_windows, scatter_tiles, tile_ids
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel
from .build import check, library

KERNEL = Kernel(name="delta_conv", route="cuda",
                source="cbinfer_tpu_torch/csrc/delta_conv.cu",
                replaces="cbinfer_tpu/ops/pallas/delta_conv.py:133")


def channel_quantum(dtype) -> int:
    """The channel grid of the tile-conv kernels (B2, B6): 16-byte staging
    of the input channels, and n-tiles of 8 outputs in bf16 or 4-wide
    output vectors in float32. cin and cout must be multiples of it."""
    return 8 if dtype == torch.bfloat16 else 4


# output pixels of one tile that the kernel computes in one block (the 64
# rows of a wgmma tile in bf16); a coarser tile is launched as sub-tiles
TILE_PIXELS = 64


def _divisor_upto(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def split_tiles(idx: torch.Tensor, count: torch.Tensor, g: TileGeometry
                ) -> Tuple[torch.Tensor, torch.Tensor, TileGeometry]:
    """The tile list of ``g`` as the list of its sub-tiles of at most 8x8
    output pixels (each side the largest divisor of the tile's up to 8),
    with the count on the device scaled and the launch geometry of the
    sub-tiles. The same pixels from the same storage into the same out
    cache: only the tile grid the kernel walks changes (its padded and
    storage extents are ``g``'s). A listed tile's sub-tiles follow one
    another, so the first ``count`` tiles are the first sub-tiles; a
    sentinel id stays past the sub-grid."""
    sth, stw = _divisor_upto(g.th, 8), _divisor_upto(g.tw, 8)
    a, b = g.th // sth, g.tw // stw
    (sh, sw), (dh, dw), (kh, kw) = g.stride, g.dilation, g.kernel
    keff_h, keff_w = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    gs = dataclasses.replace(
        g, th=sth, tw=stw, tiles_h=g.tiles_h * a, tiles_w=g.tiles_w * b,
        n_tiles=g.n_tiles * a * b, win_h=(sth - 1) * sh + keff_h,
        win_w=(stw - 1) * sw + keff_w, win_h_dma=(keff_h - 1) + sth * sh,
        win_w_dma=((g.dx0 + keff_w - 1 + stw * sw + 7) // 8) * 8)
    rows = (idx // g.tiles_w)[:, None] * a + torch.arange(
        a, dtype=idx.dtype, device=idx.device)
    cols = (idx % g.tiles_w)[:, None] * b + torch.arange(
        b, dtype=idx.dtype, device=idx.device)
    sub = rows[:, :, None] * gs.tiles_w + cols[:, None, :]
    return sub.reshape(-1), count * (a * b), gs


def delta_conv_plain(xp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], out_cache: torch.Tensor,
                     g: TileGeometry, activation: Optional[str],
                     compute_dtype=torch.float32, *,
                     count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, k^2 shifted float32 GEMMs, scatter
    into ``out_cache`` in place."""
    ids = tile_ids(idx, count)
    y = conv_tiles(gather_windows(xp, ids, g), w, b, g, activation,
                   compute_dtype)
    return scatter_tiles(out_cache, ids, y, g)


def _fn():
    f = library("delta_conv").cb_delta_conv
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 6 + [i] * 16 + [ll, ll] + [i] * 8 + [vp]
        f.restype = ctypes.c_int
    return f


def delta_conv(xp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor], out_cache: torch.Tensor,
               g: TileGeometry, activation: Optional[str],
               compute_dtype=torch.float32, *,
               count: torch.Tensor) -> torch.Tensor:
    """Fused gather + tile conv + scatter over ``idx[:count]``.

    xp: (Hs, Ws, cin) padded input storage; w: (kh, kw, cin, cout) HWIO;
    b: (cout,) float32 or None; out_cache: (out_h_pad, out_w_pad, cout),
    UPDATED IN PLACE (the JAX package donates and aliases it) — tiles not
    listed are never touched. ``count`` is a device int32 scalar.
    On the card, storage, weights and out cache share the compute dtype.
    """
    if xp.device.type == "cpu" and out_cache.device.type == "cpu":
        return delta_conv_plain(xp, idx, w, b, out_cache, g, activation,
                                compute_dtype, count=count)
    if g.th * g.tw > TILE_PIXELS:
        idx, count, g = split_tiles(idx, count, g)
    dtype = xp.dtype
    cin, cout = w.shape[2], w.shape[3]
    tensors = [xp, idx, w, out_cache, count] + ([b] if b is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("delta_conv: tensors must all be on the card")
    # a cin off the MMA's 16-channel k-step ends in a half step
    q = channel_quantum(dtype)
    if (dtype not in DTYPE_CODE or w.dtype != dtype
            or out_cache.dtype != dtype or dtype != compute_dtype
            or tuple(xp.shape) != g.store_shape or cin != g.cin
            or tuple(out_cache.shape) != (g.out_h_pad, g.out_w_pad, cout)
            or cin % q or cout % q or xp.data_ptr() % 16
            or g.th * g.tw > TILE_PIXELS
            or (b is not None and (b.dtype != torch.float32
                                   or b.shape != (cout,)))
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1 or idx.numel() > g.n_tiles
            or activation not in (None, "relu")):
        raise ValueError(
            f"delta_conv: unsupported operands xp{tuple(xp.shape)} {dtype} "
            f"w{tuple(w.shape)} {w.dtype} out{tuple(out_cache.shape)} "
            f"{out_cache.dtype} compute {compute_dtype} for {g}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("delta_conv: operands must be contiguous")
    sh, sw = g.stride
    dh, dw = g.dilation
    kh, kw = g.kernel
    if dtype == torch.bfloat16:
        plan = conv_plan(cin, cout, kh, kw, g.win_h, g.win_w)
        wk = packed_weights(w, plan.n_blk)
    else:
        wk, plan = w, (0,) * 6
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = _fn()(xp.data_ptr(), idx.data_ptr(), count.data_ptr(),
                wk.data_ptr(), b.data_ptr() if b is not None else None,
                out_cache.data_ptr(), idx.numel(), DTYPE_CODE[dtype], cin,
                cout, kh, kw, sh, sw, dh, dw, g.th, g.tw, g.win_h, g.win_w,
                g.dx0, g.tiles_w, xp.shape[1] * cin, g.out_w_pad * cout,
                int(activation == "relu"), int(b is not None), *plan, stream)
    check(err, "delta_conv")
    KERNEL.launches += 1
    return out_cache
