"""Stage C7: change-based max pooling in plain PyTorch (port of
``cbinfer_tpu.ops.delta_pool``)."""

from __future__ import annotations

import torch

from .geometry import TileGeometry


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
