"""Stages C4-C6: gather -> delta-conv GEMM -> scatter, in plain PyTorch
(port of ``cbinfer_tpu.ops.delta_conv``).

The unit is an output TILE; its gathered operand is the tile's input
window (with receptive-field halo) out of the spatially padded input
storage, and the GEMM is k_h*k_w shifted matmuls accumulated in float32.
These functions are the plain version the CPU runs and the yardstick the
CUDA kernel (``ops/kernels/delta_conv.py``) is held against, and
``delta_conv_jnp`` with ``dense_conv_shifted`` is the capacity-bounded
tile path of the ``"torch"`` and ``band_cached`` layer backends and its
dense fallback, which share one accumulation epilogue (``_accumulate``).
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


def storage_update_interior(storage: torch.Tensor, interior: torch.Tensor,
                            g: TileGeometry) -> torch.Tensor:
    """Write the logical map into the storage IN PLACE; returns it."""
    storage_interior(storage, g).copy_(interior)
    return storage


def tile_ids(idx: torch.Tensor, count) -> torch.Tensor:
    """The valid prefix ``idx[:count]`` as int64. Reads ``count`` on the
    host: only the plain versions call this, never the card's frame loop."""
    return idx[:int(count)].long()


def gather_windows(storage: torch.Tensor, ids: torch.Tensor,
                   g: TileGeometry) -> torch.Tensor:
    """C4: (n, win_h, win_w, cin) input windows of tiles ``ids``; tile
    (i, j)'s window starts at storage (i*th*sh, j*tw*sw + dx0). Sentinel
    ids (``n_tiles``) are clamped to the last tile: a scatter drops their
    results, so the windows they gather are harmless."""
    sh, sw = g.stride
    ids = ids.long().clamp(max=g.n_tiles - 1)
    ti, tj = ids // g.tiles_w, ids % g.tiles_w
    dev = storage.device
    rows = ti[:, None] * (g.th * sh) + torch.arange(g.win_h, device=dev)
    cols = (tj[:, None] * (g.tw * sw) + g.dx0
            + torch.arange(g.win_w, device=dev))
    return storage[rows[:, :, None], cols[:, None, :]]


def use_im2col(g: TileGeometry) -> bool:
    """Small-cin layers (cin*k^2 <= 128, the 3-channel stems) contract as
    ONE im2col matmul, the rest as k^2 shifted matmuls. The same gate
    holds for the tile path and the dense fallback, which is what keeps an
    overflow frame value-exact against the tile path."""
    return g.cin * g.kernel[0] * g.kernel[1] <= 128


def _accumulate(tap, n_rows: int, w: torch.Tensor,
                b: Optional[torch.Tensor], g: TileGeometry,
                activation: Optional[str], compute_dtype) -> torch.Tensor:
    """The ONE accumulation epilogue of ``conv_tiles`` and
    ``dense_conv_shifted``: operands rounded to the compute dtype, then
    multiplied and summed in float32 in (dy, dx) visit order (or one
    im2col matmul, see ``use_im2col``), bias and ReLU in float32.
    ``tap(dy, dx)`` gives the float32 operand of one kernel offset.
    Sharing it makes the capacity-overflow fallback value-exact against
    the tile path by construction. Returns (n_rows, cout) float32."""
    kh, kw = g.kernel
    cout = w.shape[-1]
    wf = w.to(compute_dtype).float()
    if use_im2col(g):
        patches = torch.cat([tap(dy, dx) for dy in range(kh)
                             for dx in range(kw)], dim=-1)
        acc = patches.reshape(n_rows, kh * kw * g.cin) \
            @ wf.reshape(kh * kw * g.cin, cout)
    else:
        acc = torch.zeros((n_rows, cout), dtype=torch.float32,
                          device=wf.device)
        for dy in range(kh):
            for dx in range(kw):
                acc += tap(dy, dx).reshape(n_rows, g.cin) @ wf[dy, dx]
    if b is not None:
        acc += b.float()
    if activation == "relu":
        acc = torch.relu_(acc)
    return acc


def conv_tiles(windows: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor], g: TileGeometry,
               activation: Optional[str], compute_dtype=torch.float32
               ) -> torch.Tensor:
    """C5: (n, win_h, win_w, cin) -> (n, th, tw, cout) float32 through
    ``_accumulate`` (the kernels' ``preferred_element_type = float32``
    semantics)."""
    sh, sw = g.stride
    dh, dw = g.dilation
    n = windows.shape[0]
    wd = windows.to(compute_dtype).float()

    def tap(dy, dx):
        return wd[:, dy * dh:dy * dh + (g.th - 1) * sh + 1:sh,
                  dx * dw:dx * dw + (g.tw - 1) * sw + 1:sw]

    acc = _accumulate(tap, n * g.th * g.tw, w, b, g, activation,
                      compute_dtype)
    return acc.reshape(n, g.th, g.tw, w.shape[-1])


def scatter_tiles(out_cache: torch.Tensor, ids: torch.Tensor,
                  y_tiles: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """C6: write tiles ``ids`` into the output cache IN PLACE."""
    tiled = out_cache.view(g.tiles_h, g.th, g.tiles_w, g.tw,
                           out_cache.shape[-1])
    tiled[ids // g.tiles_w, :, ids % g.tiles_w] = y_tiles.to(out_cache.dtype)
    return out_cache


def scatter_tiles_drop(out_cache: torch.Tensor, idx: torch.Tensor,
                       y_tiles: torch.Tensor, g: TileGeometry
                       ) -> torch.Tensor:
    """C6 over a compacted, sentinel-padded list (``compact_mask``'s
    ``idx``: valid ids first, then ``n_tiles``), IN PLACE and without a
    host read: the JAX package drops sentinel writes (``mode="drop"``);
    here each sentinel slot repeats the last valid slot's id and tile, so
    the duplicate writes agree, and an empty list writes the last tile's
    own value back."""
    idx = idx.long()
    valid = idx < g.n_tiles
    n_valid = valid.sum()
    pos = torch.arange(idx.shape[0], device=idx.device)
    src = torch.where(valid, pos, (n_valid - 1).clamp(min=0))
    ids = idx.clamp(max=g.n_tiles - 1)[src]
    tiled = out_cache.view(g.tiles_h, g.th, g.tiles_w, g.tw,
                           out_cache.shape[-1])
    ti, tj = ids // g.tiles_w, ids % g.tiles_w
    y = torch.where(n_valid > 0, y_tiles[src].to(out_cache.dtype),
                    tiled[ti, :, tj])
    tiled[ti, :, tj] = y
    return out_cache


def delta_conv_jnp(xp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], out_cache: torch.Tensor,
                   g: TileGeometry, activation: Optional[str],
                   compute_dtype=torch.float32) -> torch.Tensor:
    """Gather + conv + scatter of a sentinel-padded list of ``capacity``
    tile ids, IN PLACE: the capacity-bounded tile path (the JAX package's
    ``delta_conv_jnp``, named after it). No host read, so a CUDA graph
    captures it."""
    y = conv_tiles(gather_windows(xp, idx, g), w, b, g, activation,
                   compute_dtype)
    return scatter_tiles_drop(out_cache, idx, y, g)


def dense_conv_shifted(storage: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], g: TileGeometry,
                       activation: Optional[str],
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Full-map conv over the padded storage through the tile path's
    ``_accumulate``; (out_h_pad, out_w_pad, cout) float32. The dense
    fallback of an overflow frame, value-exact against the tile path."""
    sh, sw = g.stride
    dh, dw = g.dilation
    xd = storage.to(compute_dtype).float()

    def tap(dy, dx):
        return xd[dy * dh:dy * dh + (g.out_h_pad - 1) * sh + 1:sh,
                  g.dx0 + dx * dw:
                  g.dx0 + dx * dw + (g.out_w_pad - 1) * sw + 1:sw]

    acc = _accumulate(tap, g.out_h_pad * g.out_w_pad, w, b, g, activation,
                      compute_dtype)
    return acc.reshape(g.out_h_pad, g.out_w_pad, w.shape[-1])
