"""Hinted tile copy of a forward-hint conv layer (B9).

Replaces ``cbinfer_tpu/ops/pallas/accept.py::accept_tiles``. The CUDA
source (``csrc/accept_tiles.cu``) carries the design note: bytes bound the
kernel on the H100 (a pure copy of the hinted 8x8xC tiles), a grid sized to
the card walks (tile, part) pairs up to the device-side count with every
load of a thread in flight before its stores, and the clamped bottom tile
may overlap the row above because both blocks write the same bytes. The
last hint row and column may be partial (any map size): nothing past the
logical map is read or written.
"""

from __future__ import annotations

import ctypes

import torch

from ..delta_conv import tile_ids
from ..geometry import TileGeometry, cdiv
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

HINT = 8
THREADS = 256  # of a block (kThreads in csrc/accept_tiles.cu)
# blocks of 256 threads per SM (a thread holds two 16-byte units, 31
# registers): against two, lists of every tile walked 1.05-1.07x faster and
# 30-tile lists within 3%; eight gained at most 4% more (same-call A/B,
# PERF.md), and at four every tile of a C = 256 map still outgrows the grid
BLOCKS_PER_SM = 4
# units a part holds at most: two a thread (of THREADS), as B8's parts
PART_UNITS = 512

KERNEL = Kernel(name="accept_tiles", route="cuda",
                source="cbinfer_tpu_torch/csrc/accept_tiles.cu",
                replaces="cbinfer_tpu/ops/pallas/accept.py:105")


def accept_tiles_plain(x: torch.Tensor, storage: torch.Tensor,
                       idx: torch.Tensor, count: torch.Tensor,
                       g: TileGeometry) -> torch.Tensor:
    """Plain PyTorch version (same signature and result as the kernel):
    copies the listed 8x8 tiles, the bottom one clamped to ``H - 8`` on a
    map of at least 8 rows, into the interior of ``storage`` in place; the
    pixels of a tile past the map (a map of fewer than 8 rows, the partial
    last column) are not copied."""
    H, W = g.in_h, g.in_w
    ids = tile_ids(idx, count)
    hw = cdiv(W, HINT)
    oy = torch.clamp(ids // hw * HINT, max=max(H - HINT, 0))
    ox = ids % hw * HINT
    ar = torch.arange(HINT, device=x.device)
    rows = (oy[:, None] + ar)[:, :, None].expand(-1, HINT, HINT)
    cols = (ox[:, None] + ar)[:, None, :].expand(-1, HINT, HINT)
    inside = (rows < H) & (cols < W)
    rows, cols = rows[inside], cols[inside]
    storage[rows + g.store_lo_h, cols + g.store_lo_w] = \
        x[rows, cols].to(storage.dtype)
    return storage


def part_split(row_units: int, part_units: int = PART_UNITS) -> tuple:
    """(parts, per, upt) of B9 for a tile of 8 rows of ``row_units`` load
    units: the tile's units, in (row, unit) order, are cut into ``parts``
    runs of ``per`` units (the last may be shorter, none is empty), the
    fewest runs of at most ``part_units``; a thread of the block loads
    ``upt`` (1, 2 or 4) of its run's units before it stores. The kernel
    takes these as they are."""
    items = 8 * row_units
    parts = -(-items // part_units)
    per = -(-items // parts)
    upt = -(-per // THREADS)
    return parts, per, 1 << (upt - 1).bit_length()


def _strides(x: torch.Tensor, storage: torch.Tensor, g: TileGeometry):
    """Bytes between rows of x and of the storage, the interior's origin in
    the storage, and a tile row's bytes."""
    C, es = storage.shape[-1], storage.element_size()
    s_row = storage.shape[1] * C * es
    return (x.shape[1] * C * es, s_row,
            g.store_lo_h * s_row + g.store_lo_w * C * es, HINT * C * es)


def unit_bytes(x: torch.Tensor, storage: torch.Tensor,
               g: TileGeometry) -> int:
    """B9's load unit: 16 bytes where both pointers and every row start of
    a tile (in x and in the storage) are 16-byte aligned and a pixel is
    whole units (so the partial last column of a ragged map ends on a
    unit), else 4."""
    pixel = storage.shape[-1] * storage.element_size()
    return 4 if any(v % 16 for v in (x.data_ptr(), storage.data_ptr(),
                                     *_strides(x, storage, g), pixel)) \
        else 16


def _fn():
    f = library("accept_tiles").cb_accept_tiles
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp, vp, vp, vp, i, i, i, i, ll, ll, ll, i, i, i, i, i,
                      vp]
        f.restype = ctypes.c_int
    return f


def accept_tiles(x: torch.Tensor, storage: torch.Tensor, idx: torch.Tensor,
                 count: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """Copy the hinted 8x8 tiles of ``x`` into the padded storage.

    x: (>=H, >=W, C) producer output (may be its padded out cache; logical
    dims come from ``g``). storage: this layer's padded input cache,
    UPDATED IN PLACE (the JAX package donates and aliases it). idx/count:
    compacted ids on the 8x8 hint grid of the logical input
    (``cdiv(H, 8) x cdiv(W, 8)``: any map size), ``count`` a device int32
    scalar. On the card x and the storage share their dtype: anything else
    raises (no silent conversion). Returns the storage.
    """
    H, W = g.in_h, g.in_w
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return accept_tiles_plain(x, storage, idx, count, g)
    C = storage.shape[-1]
    if not (x.is_cuda and storage.is_cuda and idx.is_cuda and count.is_cuda):
        raise ValueError("accept_tiles: tensors must all be on the card")
    es = storage.element_size()
    if (storage.dtype not in DTYPE_CODE or x.dtype != storage.dtype
            or x.shape[-1] != C or (C * es) % 4
            or x.data_ptr() % 4 or storage.data_ptr() % 4
            or x.shape[0] < H or x.shape[1] < W
            or tuple(storage.shape) != g.store_shape[:2] + (C,)
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1
            or idx.numel() > cdiv(H, HINT) * cdiv(W, HINT)):
        raise ValueError(
            f"accept_tiles: unsupported operands x{tuple(x.shape)} "
            f"{x.dtype} storage{tuple(storage.shape)} {storage.dtype} "
            f"idx{tuple(idx.shape)} {idx.dtype}")
    for t in (x, storage, idx):
        if not t.is_contiguous():
            raise ValueError("accept_tiles: operands must be contiguous")
    x_row, s_row, s_origin, tile_row = _strides(x, storage, g)
    unit = unit_bytes(x, storage, g)
    parts, per, upt = part_split(tile_row // unit)
    grid = walk_grid(idx.numel() * parts, sm_count(storage.device.index),
                     BLOCKS_PER_SM)
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    err = _fn()(x.data_ptr(), storage.data_ptr(), idx.data_ptr(),
                count.data_ptr(), idx.numel(), grid, H, W, x_row,
                s_row, s_origin, tile_row, int(unit == 16), parts, per, upt,
                stream)
    check(err, "accept_tiles")
    KERNEL.launches += 1
    return storage
