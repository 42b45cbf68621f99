"""Hinted tile copy of a forward-hint conv layer (B9).

Replaces ``cbinfer_tpu/ops/pallas/accept.py::accept_tiles``. The CUDA
source (``csrc/accept_tiles.cu``) carries the design note: bytes bound the
kernel on the H100 (a pure copy of the hinted 8x8xC tiles), one block per
hint tile walks a device-side count, and the clamped bottom tile may
overlap the row above because both blocks write the same bytes.
"""

from __future__ import annotations

import ctypes

import torch

from ..delta_conv import tile_ids
from ..geometry import TileGeometry, cdiv
from . import DTYPE_CODE, Kernel
from .build import check, library

HINT = 8

KERNEL = Kernel(name="accept_tiles", route="cuda",
                source="cbinfer_tpu_torch/csrc/accept_tiles.cu",
                replaces="cbinfer_tpu/ops/pallas/accept.py:105")


def accept_tiles_plain(x: torch.Tensor, storage: torch.Tensor,
                       idx: torch.Tensor, count: torch.Tensor,
                       g: TileGeometry) -> torch.Tensor:
    """Plain PyTorch version (same signature and result as the kernel):
    copies the listed 8x8 tiles, the bottom one clamped to ``H - 8``, into
    the interior of ``storage`` in place."""
    H, W = g.in_h, g.in_w
    ids = tile_ids(idx, count)
    hw = W // HINT
    oy = torch.clamp(ids // hw * HINT, max=H - HINT)
    ox = ids % hw * HINT
    ar = torch.arange(HINT, device=x.device)
    rows = (oy[:, None] + ar)[:, :, None]
    cols = (ox[:, None] + ar)[:, None, :]
    storage[rows + g.store_lo_h, cols + g.store_lo_w] = \
        x[rows, cols].to(storage.dtype)
    return storage


def _fn():
    f = library("accept_tiles").cb_accept_tiles
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp, vp, vp, vp, i, i, i, ll, ll, ll, i, i, vp]
        f.restype = ctypes.c_int
    return f


def accept_tiles(x: torch.Tensor, storage: torch.Tensor, idx: torch.Tensor,
                 count: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """Copy the hinted 8x8 tiles of ``x`` into the padded storage.

    x: (>=H, >=W, C) producer output (may be its padded out cache; logical
    dims come from ``g``). storage: this layer's padded input cache,
    UPDATED IN PLACE (the JAX package donates and aliases it). idx/count:
    compacted ids on the 8x8 hint grid of the logical input, ``count`` a
    device int32 scalar. On the card x and the storage share their dtype:
    anything else raises (no silent conversion). Returns the storage.
    """
    H, W = g.in_h, g.in_w
    if W % HINT or H < HINT:
        raise ValueError(f"accept_tiles needs W % 8 == 0 and H >= 8, "
                         f"got {(H, W)}")
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return accept_tiles_plain(x, storage, idx, count, g)
    C = storage.shape[-1]
    if not (x.is_cuda and storage.is_cuda and idx.is_cuda and count.is_cuda):
        raise ValueError("accept_tiles: tensors must all be on the card")
    es = storage.element_size()
    if (storage.dtype not in DTYPE_CODE or x.dtype != storage.dtype
            or x.shape[-1] != C or (C * es) % 4
            or x.shape[0] < H or x.shape[1] < W
            or tuple(storage.shape) != g.store_shape[:2] + (C,)
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1
            or idx.numel() > cdiv(H, HINT) * (W // HINT)):
        raise ValueError(
            f"accept_tiles: unsupported operands x{tuple(x.shape)} "
            f"{x.dtype} storage{tuple(storage.shape)} {storage.dtype} "
            f"idx{tuple(idx.shape)} {idx.dtype}")
    for t in (x, storage, idx):
        if not t.is_contiguous():
            raise ValueError("accept_tiles: operands must be contiguous")
    x_row, s_row = x.shape[1] * C * es, storage.shape[1] * C * es
    s_origin = g.store_lo_h * s_row + g.store_lo_w * C * es
    tile_row = HINT * C * es
    vec16 = not any(v % 16 for v in (x.data_ptr(), storage.data_ptr(), x_row,
                                     s_row, s_origin, tile_row))
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    err = _fn()(x.data_ptr(), storage.data_ptr(), idx.data_ptr(),
                count.data_ptr(), idx.numel(), H, W // HINT, x_row, s_row,
                s_origin, tile_row, int(vec16), stream)
    check(err, "accept_tiles")
    KERNEL.launches += 1
    return storage
