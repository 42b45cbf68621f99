"""Stages C4-C6: gather -> delta-conv GEMM -> scatter, in plain PyTorch
(port of ``cbinfer_tpu.ops.delta_conv``).

The unit is an output TILE; its gathered operand is the tile's input
window (with receptive-field halo) out of the spatially padded input
storage, and the GEMM is k_h*k_w shifted matmuls accumulated in float32.
These functions are the plain version the CPU runs and the yardstick the
CUDA kernel (``ops/kernels/delta_conv.py``) is held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from .geometry import TileGeometry


def make_storage(g: TileGeometry, fill, margin_fill, dtype,
                 device) -> torch.Tensor:
    """Persistent spatially padded input-cache storage: interior (the
    logical map) = ``fill``; margins (conv zero padding / pool -inf, plus
    the TPU layout's slack) = ``margin_fill``, written once, never again."""
    st = torch.full(g.store_shape, margin_fill, dtype=dtype, device=device)
    storage_interior(st, g).fill_(fill)
    return st


def storage_interior(storage: torch.Tensor, g: TileGeometry
                     ) -> torch.Tensor:
    """A VIEW of the logical map inside the padded storage (writes through)."""
    return storage[g.store_lo_h:g.store_lo_h + g.in_h,
                   g.store_lo_w:g.store_lo_w + g.in_w]


def tile_ids(idx: torch.Tensor, count) -> torch.Tensor:
    """The valid prefix ``idx[:count]`` as int64. Reads ``count`` on the
    host: only the plain versions call this, never the card's frame loop."""
    return idx[:int(count)].long()


def gather_windows(storage: torch.Tensor, ids: torch.Tensor,
                   g: TileGeometry) -> torch.Tensor:
    """C4: (n, win_h, win_w, cin) input windows of tiles ``ids``; tile
    (i, j)'s window starts at storage (i*th*sh, j*tw*sw + dx0)."""
    sh, sw = g.stride
    ti, tj = ids // g.tiles_w, ids % g.tiles_w
    dev = storage.device
    rows = ti[:, None] * (g.th * sh) + torch.arange(g.win_h, device=dev)
    cols = (tj[:, None] * (g.tw * sw) + g.dx0
            + torch.arange(g.win_w, device=dev))
    return storage[rows[:, :, None], cols[:, None, :]]


def conv_tiles(windows: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor], g: TileGeometry,
               activation: Optional[str], compute_dtype=torch.float32
               ) -> torch.Tensor:
    """C5: (n, win_h, win_w, cin) -> (n, th, tw, cout) float32, as
    k^2 shifted matmuls. Operands are rounded to the compute dtype and then
    multiplied and summed in float32 (the kernels' ``preferred_element_type
    = float32`` semantics), bias and ReLU in float32."""
    kh, kw = g.kernel
    sh, sw = g.stride
    dh, dw = g.dilation
    n = windows.shape[0]
    cout = w.shape[-1]
    wd = windows.to(compute_dtype).float()
    wf = w.to(compute_dtype).float()
    acc = torch.zeros((n * g.th * g.tw, cout), dtype=torch.float32,
                      device=windows.device)
    for dy in range(kh):
        for dx in range(kw):
            patch = wd[:, dy * dh:dy * dh + (g.th - 1) * sh + 1:sh,
                       dx * dw:dx * dw + (g.tw - 1) * sw + 1:sw]
            acc += patch.reshape(n * g.th * g.tw, g.cin) @ wf[dy, dx]
    if b is not None:
        acc += b.float()
    if activation == "relu":
        acc = torch.relu(acc)
    return acc.reshape(n, g.th, g.tw, cout)


def scatter_tiles(out_cache: torch.Tensor, ids: torch.Tensor,
                  y_tiles: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """C6: write tiles ``ids`` into the output cache IN PLACE."""
    tiled = out_cache.view(g.tiles_h, g.th, g.tiles_w, g.tw,
                           out_cache.shape[-1])
    tiled[ids // g.tiles_w, :, ids % g.tiles_w] = y_tiles.to(out_cache.dtype)
    return out_cache


def dense_conv_shifted(storage: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], g: TileGeometry,
                       activation: Optional[str],
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Full-map conv over the padded storage with the tile path's
    accumulation order; (out_h_pad, out_w_pad, cout) float32."""
    sh, sw = g.stride
    dh, dw = g.dilation
    kh, kw = g.kernel
    xd = storage.to(compute_dtype).float()
    wf = w.to(compute_dtype).float()
    n_rows = g.out_h_pad * g.out_w_pad
    acc = torch.zeros((n_rows, w.shape[-1]), dtype=torch.float32,
                      device=storage.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xd[dy * dh:dy * dh + (g.out_h_pad - 1) * sh + 1:sh,
                     g.dx0 + dx * dw:
                     g.dx0 + dx * dw + (g.out_w_pad - 1) * sw + 1:sw]
            acc += tap.reshape(n_rows, g.cin) @ wf[dy, dx]
    if b is not None:
        acc += b.float()
    if activation == "relu":
        acc = torch.relu(acc)
    return acc.reshape(g.out_h_pad, g.out_w_pad, w.shape[-1])
