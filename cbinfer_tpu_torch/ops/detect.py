"""Stages C1+C2 on a full map: change detection, accepted-cache update and
the output-tile mask (PyTorch port of ``cbinfer_tpu.ops.detect``).

Pixel p changed iff ``max_c |x[p,c] - in_cache[p,c]| > tau`` (in float32);
the cache is updated only at changed pixels, so the comparison baseline is
the last ACCEPTED value. An output tile must be recomputed iff a changed
pixel lies in its receptive field.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import TileGeometry

# in_cache init value: frame 0 sees every pixel as changed. Finite so
# bf16/fp32 arithmetic stays NaN-free.
COLD_START_FILL = 3.0e38


def tau32(tau) -> float:
    """tau rounded to float32, as a Python float: compared against a
    float32 tensor it gives the JAX package's float32 comparison, and being
    a host scalar it needs no host-to-device copy (a device tensor made
    from a host value waits for the card)."""
    return float(np.float32(tau))


def detect_and_update(x: torch.Tensor, in_cache: torch.Tensor, tau
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel detect of (H, W, C) ``x`` against ``in_cache`` (cache
    dtype). Returns (new_in_cache, changed (H, W) bool); pure."""
    diff = (x.float() - in_cache.float()).abs().amax(dim=-1)
    changed = diff > tau32(tau)
    new_cache = torch.where(changed[..., None], x.to(in_cache.dtype),
                            in_cache)
    return new_cache, changed


def detect_and_update_flat(x: torch.Tensor, in_cache: torch.Tensor, tau,
                           C: int, out: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``detect_and_update`` on the FLAT (H, W*C) view of an HWC buffer
    (the same memory, so the reshape is free): the per-pixel channel max
    is a (1, C) window reduce and the write-back a repeat-expand ``where``.
    Returns (new_cache (H, W*C), changed (H, W) bool); the new cache is
    written into ``out`` when given (``in_cache`` itself for an in-place
    update)."""
    H = x.shape[0]
    diff = (x.float() - in_cache.float()).abs_()
    changed = diff.view(H, -1, C).amax(dim=-1) > tau32(tau)
    expand = changed.repeat_interleave(C, dim=1)
    new = torch.where(expand, x.to(in_cache.dtype), in_cache,
                      **({} if out is None else {"out": out}))
    return new, changed


def changed_tile_mask(changed: torch.Tensor, g: TileGeometry
                      ) -> torch.Tensor:
    """Per-pixel change map -> (tiles_h, tiles_w) bool output-tile mask:
    a windowed OR with window (win_h, win_w), stride (th*sh, tw*sw) and
    window t starting at ``t*th*sh - pad_lo`` — exactly the input region
    output tile t reads."""
    sh, sw = g.stride
    phi_h = (g.tiles_h - 1) * g.th * sh + g.win_h - g.in_h - g.pad_lo_h
    phi_w = (g.tiles_w - 1) * g.tw * sw + g.win_w - g.in_w - g.pad_lo_w
    m = changed.float()
    # negative high padding crops, as XLA's reduce_window allows
    m = F.pad(m, (g.pad_lo_w, phi_w, g.pad_lo_h, phi_h))
    out = F.max_pool2d(m[None, None], kernel_size=(g.win_h, g.win_w),
                       stride=(g.th * sh, g.tw * sw))[0, 0] > 0
    assert out.shape == (g.tiles_h, g.tiles_w), (out.shape, g)
    return out
