"""Stage C3: stream compaction of a tile mask (port of
``cbinfer_tpu.ops.compact``).

Glue between detect and the delta kernels. On the card it is one kernel,
``compact_tiles`` (``ops/kernels/compact_tiles.py``): a single block's
prefix sum over the flags, as the original CBinfer compacts. On the CPU it
is the JAX package's sort, the kernel's plain version; both give the same
list bit for bit. The count stays a device tensor: no ``nonzero`` and no
``.item()``, both of which wait for the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels.compact_tiles import compact_tiles


class Compacted(NamedTuple):
    idx: torch.Tensor    # (capacity,) int32 flat tile ids; sentinel n_tiles
    count: torch.Tensor  # () int32 number of changed tiles


def compact_mask(mask: torch.Tensor, capacity: int) -> Compacted:
    """Bool tile mask -> sentinel-padded list of changed flat tile ids."""
    idx, count = compact_tiles(mask, capacity)
    return Compacted(idx=idx, count=count)
