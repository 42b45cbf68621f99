"""Stage C3: stream compaction of a tile mask (port of
``cbinfer_tpu.ops.compact``).

Glue between detect and the delta kernels, not a kernel of its own. It
sorts, as the JAX package does: changed tiles keep their ids as keys,
unchanged tiles get a beyond-range key, so an ascending sort packs the
changed ids to the front in row-major order and the tail holds the
sentinel ``n_tiles``. The count stays a device tensor: no ``nonzero`` and
no ``.item()``, both of which wait for the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Compacted(NamedTuple):
    idx: torch.Tensor    # (capacity,) int32 flat tile ids; sentinel n_tiles
    count: torch.Tensor  # () int32 number of changed tiles


_BIG = 1 << 30  # > any n_tiles, < int32 max


def compact_mask(mask: torch.Tensor, capacity: int) -> Compacted:
    """Bool tile mask -> sentinel-padded list of changed flat tile ids."""
    n_tiles = mask.numel()
    flat = mask.reshape(-1)
    ids = torch.arange(n_tiles, dtype=torch.int32, device=mask.device)
    key = torch.where(flat, ids, _BIG)
    # unchanged keys are _BIG > n_tiles: clamping them IS the sentinel
    idx = torch.sort(key).values[:capacity].clamp_(max=n_tiles)
    count = flat.sum(dtype=torch.int32)
    return Compacted(idx=idx.contiguous(), count=count)
