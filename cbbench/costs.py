"""The benchmark's frozen arithmetic: the card's peaks, a launch's bound,
the operations per recomputed tile and the bytes each of the port's
kernels must move for a given list of tiles.

Copies, kept here so that a change to the program cannot move the
yardstick: ``metrics.layer_flops_per_tile`` (operations per tile),
``chip_smoke.py::_bound_ms`` and the kernel table's bytes per launch
(``chip_smoke.py``'s ``kernels`` phase). Everything is counted from the
masks the plain reference computes (``reference.py``), never from the
program's counters. Each input byte is counted once and each output byte
once; operations count the output pixels a map really has (a tile that
overhangs a map's edge counts its pixels inside the map only).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel ids -> the group whose roofline share reads them
CONV_KERNELS = ("B2", "B5", "B6")
DETECT_KERNELS = ("B1", "B3", "B4", "B7", "B8", "B9")


def bound_s(flops, nbytes):
    """The least time a launch can take on the card: the larger of its
    operations at the bf16 peak and its bytes at the HBM peak (works on
    numbers and on tensors alike)."""
    if isinstance(flops, torch.Tensor) or isinstance(nbytes, torch.Tensor):
        f = torch.as_tensor(flops, dtype=torch.float64)
        b = torch.as_tensor(nbytes, dtype=torch.float64)
        return torch.maximum(f / PEAK_BF16_FLOPS, b / PEAK_BYTES)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def flops_per_pixel(kernel: int, cin: int, cout: int) -> int:
    """MAC*2 of one output pixel of a conv (``layer_flops_per_tile`` over
    one pixel)."""
    return 2 * kernel * kernel * cin * cout


def tile_or(mask: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """OR over each (th, tw) block of a bool (H, W) map, a partial block
    at the bottom or right edge counting the pixels it has."""
    h, w = mask.shape
    m = F.pad(mask.float(), (0, -w % tw, 0, -h % th))
    return F.max_pool2d(m[None, None], (th, tw))[0, 0] > 0


def tiles_to_pixels(tiles: torch.Tensor, th: int, tw: int, h: int, w: int
                    ) -> torch.Tensor:
    """A tile mask as the (h, w) map of the pixels its tiles hold."""
    return tiles.repeat_interleave(th, 0).repeat_interleave(tw, 1)[:h, :w]


def window_cover(out_px: torch.Tensor, kernel: int, stride: int, pad: int,
                 in_h: int, in_w: int) -> torch.Tensor:
    """Input pixels (within the padded input: the map and its SAME
    margins) that the output pixels ``out_px`` read, each counted once."""
    ones = torch.ones((1, 1, kernel, kernel), device=out_px.device)
    cov = F.conv_transpose2d(out_px.float()[None, None], ones, stride=stride)
    cov = cov[0, 0, :in_h + 2 * pad, :in_w + 2 * pad]
    return (cov > 0).sum()


class Launches:
    """Per kernel id, the sums over a run of launches of operations,
    bytes and bound seconds, kept on the device (no host read per
    launch)."""

    def __init__(self, device):
        self.device = device
        self.sums: Dict[str, List[torch.Tensor]] = {}

    def add(self, kid: str, flops, nbytes):
        f = torch.as_tensor(flops, dtype=torch.float64, device=self.device)
        b = torch.as_tensor(nbytes, dtype=torch.float64, device=self.device)
        row = torch.stack([f, b, bound_s(f, b), torch.ones_like(f)])
        if kid in self.sums:
            self.sums[kid] += row
        else:
            self.sums[kid] = row.clone()

    def host(self) -> Dict[str, Tuple[float, float, float, int]]:
        """kid -> (operations, bytes, bound seconds, launches)."""
        return {k: (float(v[0]), float(v[1]), float(v[2]), int(v[3]))
                for k, v in self.sums.items()}


# ----------------------- bytes of each kernel's launch -----------------------
# es: bytes of a cache element (bf16: 2); x_es: the frame's (float32: 4)

def b1_detect_sparse(own_px, npix, C, es, out_tiles, hinted):
    """Sparse detect over the hinted 8x8 tiles: x and the cache read over
    the hinted pixels, accepted pixels written, the tile mask, the list."""
    return 2 * own_px * C * es + npix * C * es + out_tiles * 4 + hinted * 4 + 8


def b2_delta_conv(cover_px, cin, out_px, cout, es, w_numel, tiles):
    """Tile conv: the listed tiles' input windows, their outputs, the
    weights, the bias (float32) and the list."""
    return (cover_px * cin * es + out_px * cout * es + w_numel * es
            + cout * 4 + tiles * 4)


def b3_pool_fused(blocks, C, es, out_tiles, block_px=8 * 16):
    """Forward-hint pool: each listed 8x16 block read and its quarter
    written, the out-tile mask and the list."""
    return blocks * (block_px + block_px // 4) * C * es + out_tiles * 4 \
        + blocks * 4


def b4_stem_detect(h, w, C, x_es, es, npix, cells):
    """Full-map stem detect: the frame and the cache read, accepted
    pixels written, the cell mask, the count."""
    return h * w * C * (x_es + es) + npix * C * es + cells * 4 + 4


def b5_stem_conv(cover_px, cin, out_px, cout, es, w_numel, listed):
    """Stem conv over its (8, 32) tiles (every tile past the capacity)."""
    return (cover_px * cin * es + out_px * cout * es + w_numel * es
            + cout * 4 + listed * 4 + 4)


def b6_conv_detect(cover_px, cin, out_px, cout, es, w_numel, tiles, npix2,
                   out_tiles2):
    """Tile conv with the consumer's detect: as B2, plus the consumer's
    cache read over the computed tiles, its accepted pixels written and
    its tile mask."""
    return (cover_px * cin * es + 2 * out_px * cout * es + npix2 * cout * es
            + w_numel * es + cout * 4 + tiles * 4 + out_tiles2 * 4 + 8)


def b8_delta_pool(cover_px, C, es, out_px, tiles):
    """Re-detecting pool's tile pass: the listed windows read, the outputs
    written, the list."""
    return cover_px * C * es + out_px * C * es + tiles * 4 + 4
