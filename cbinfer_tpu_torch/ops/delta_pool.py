"""Stage C7: change-based max pooling in plain PyTorch (port of
``cbinfer_tpu.ops.delta_pool``)."""

from __future__ import annotations

import torch

from .delta_conv import gather_windows, scatter_tiles_drop
from .geometry import TileGeometry


def pool_tiles(windows: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """(n, win_h, win_w, c) -> (n, th, tw, c) max pool per tile."""
    kh, kw = g.kernel
    sh, sw = g.stride
    y = None
    for dy in range(kh):
        for dx in range(kw):
            patch = windows[:, dy:dy + (g.th - 1) * sh + 1:sh,
                            dx:dx + (g.tw - 1) * sw + 1:sw]
            y = patch if y is None else torch.maximum(y, patch)
    return y


def delta_pool_jnp(storage: torch.Tensor, idx: torch.Tensor,
                   out_cache: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """Gather + pool + scatter of the tiles of a compacted list (sentinel
    ``n_tiles`` past the changed ids, as ``compact_mask`` gives; a list of
    valid ids alone is one too) out of the padded storage into
    ``out_cache`` IN PLACE, sentinels dropped, with no host read. Named
    after the JAX package's function it ports."""
    return scatter_tiles_drop(out_cache, idx,
                              pool_tiles(gather_windows(storage, idx, g), g),
                              g)


def dense_pool(storage: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """Full-map max pool over the padded storage -> (out_h_pad, out_w_pad,
    C), the refresh path's pool (margins hold the -inf fill)."""
    kh, kw = g.kernel
    sh, sw = g.stride
    y = None
    for dy in range(kh):
        for dx in range(kw):
            patch = storage[dy:dy + (g.out_h_pad - 1) * sh + 1:sh,
                            g.dx0 + dx:
                            g.dx0 + dx + (g.out_w_pad - 1) * sw + 1:sw]
            y = patch if y is None else torch.maximum(y, patch)
    return y
