"""The small-cin stem's gate, tile size and plain detect (port of the parts
of ``cbinfer_tpu.ops.flat4`` that are not TPU layout).

The JAX package stores the accepted stem input as a rank-2 "flat4" buffer
(4 lanes per pixel, 128-lane rows, 8-row margins) because Mosaic cannot
DMA-slice a 3-channel HWC array. The card has no such rule, so the port
keeps the stem cache in the padded HWC storage every other layer uses
(``ops.delta_conv.make_storage`` on the stem's (8, 32)-tile geometry: zero
margins are the conv's SAME padding). What stays is what the layer's gate
and stats need — the (8, 32) stem tile, ``supports`` — and the plain
per-pixel detect.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import detect
from .delta_conv import storage_interior
from .geometry import TileGeometry, conv_tile_geometry

TILE_H = 8    # stem tile rows
TILE_W = 32   # stem tile width in pixels
CELL = 8      # side of the dilated-mask cells (the dirty-hint grid)


def supports(in_shape: Tuple[int, int, int], kernel, stride, dilation,
             padding, activation) -> bool:
    """Static gate of the ``patch_stem`` backend: 3x3/s1/SAME, cin <= 3,
    map divisible by the (8, 32) stem tile."""
    h, w, c = in_shape
    return (tuple(kernel) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(dilation) == (1, 1) and padding == "SAME"
            and 1 <= c <= 3 and h % TILE_H == 0 and w % TILE_W == 0
            and activation in (None, "relu"))


def cell_geometry(g: TileGeometry, cell: int = CELL) -> TileGeometry:
    """The stem's geometry on the grid of ``cell`` x ``cell`` cells (the
    8x8 hint grid by default; the gate fixes SAME)."""
    return conv_tile_geometry((g.in_h, g.in_w, g.cin), g.kernel, g.stride,
                              g.dilation, "SAME", cell, cell)


def mask_cell(tile_h: int, tile_w: int) -> int:
    """The stem detect's cell for a configured tile: the largest of 8, 4,
    2 and 1 that divides both sides, so the configured tile, the 8x8 hint
    tile and the (8, 32) stem tile are each whole cells, and each one's
    window (3x3 SAME) the union of its cells' windows."""
    return next(c for c in (CELL, 4, 2, 1)
                if tile_h % c == 0 and tile_w % c == 0)


def detect_accept_flat4(x: torch.Tensor, storage: torch.Tensor, tau,
                        g: TileGeometry):
    """Per-pixel detect + accepted-value update of the stem cache, IN
    PLACE. The tau comparison runs on the UNROUNDED (H, W, cin) input
    against the cache in float32 (comparing the cache-dtype-rounded input
    instead flips borderline pixels). Named after the JAX package's
    function it ports. Returns (storage, changed (H, W) bool, n_changed
    int32)."""
    interior = storage_interior(storage, g)
    diff = (x.float() - interior.float()).abs().amax(dim=-1)
    changed = diff > detect.tau32(tau)
    torch.where(changed[..., None], x.to(interior.dtype), interior,
                out=interior)
    return storage, changed, changed.sum(dtype=torch.int32)
