"""The benchmark's frozen arithmetic: the card's peaks, a launch's bound,
the operations per recomputed tile and the bytes each of the port's
kernels must move for a given list of tiles.

Copies, kept here so that a change to the program cannot move the
yardstick: ``metrics.layer_flops_per_tile`` (operations per tile),
``chip_smoke.py::_bound_ms`` and the kernel table's bytes per launch
(``chip_smoke.py``'s ``kernels`` phase). Everything is counted by
``Counter`` from the judged pass's changed-pixel masks
(``layerwise.py``), worked out by the τ rule from the program's stored
state, which the decision check holds the program's caches to exactly;
never from the program's counters. Each input byte is counted once and
each output byte once; operations count the output pixels a map really
has (a tile that overhangs a map's edge counts its pixels inside the map
only).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

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


# ------------------- launches per frame, from the masks -------------------

HINT = 8          # the dirty-hint grid between layers
STEM_TILE = (8, 32)


class Counter:
    """Each frame's kernel launches and operations, node by node, from the
    masks that decide the program's work: per CB node the changed input
    pixels ``d`` (None on a refresh frame, which recomputes densely), and
    from them the changed output tiles, the 8x8 dirty hints between nodes
    (OR-ed at a concat), the stem's capacity overflow, and a ``B6``
    producer's launch, which its consumer's detect completes
    (``netdef.fused_consumers``). Call ``node`` for every node of a frame
    in topological order, after ``start``."""

    def __init__(self, nodes, capacity_fraction: float, es: int, device):
        from . import netdef
        self.nodes = {n["name"]: n for n in nodes}
        self.consumer = netdef.fused_consumers(nodes)
        self.out_changed = netdef.out_changed
        self.capacity_fraction = capacity_fraction
        self.es = es
        self.launches = Launches(device)
        self.flops = torch.zeros((), dtype=torch.float64, device=device)
        self.start()

    def start(self):
        self.hints: Dict[str, torch.Tensor] = {}
        self.pending: Dict[str, tuple] = {}

    def _dense_flops(self, n, shape) -> float:
        if n["kind"] != "conv":
            return 0.0
        c, h, w = shape
        return float(h * w * flops_per_pixel(n["kernel"], c, n["features"]))

    def node(self, name: str, shape, d: Optional[torch.Tensor],
             refresh: bool):
        """Node ``name`` of this frame, its input of (C, H, W) ``shape``."""
        n = self.nodes[name]
        hint = self.hints.get(n["inputs"][0])
        out = None
        if n["kind"] == "concat":
            ins = [self.hints.get(i) for i in n["inputs"]]
            if not refresh and all(h is not None for h in ins):
                out = ins[0]
                for h in ins[1:]:
                    out = out | h
        elif n["kind"] == "pool" and n["forward"]:
            if not refresh:
                out = self._pool_fused(shape, hint)
        elif not n["cb"] or d is None:
            self.flops += self._dense_flops(n, shape)
        else:
            out = self._cb(n, shape, d, hint, self.pending.pop(name, None))
        self.hints[name] = out

    def _pool_fused(self, shape, hint):
        C = shape[0]
        pairs = hint[:, 0::2] | hint[:, 1::2]
        out = tile_or(hint, 2, 2)  # a pooled 8x8 tile: 2x2 hints
        self.launches.add("B3", 0.0, b3_pool_fused(
            pairs.sum(), C, self.es, out.numel()))
        return out

    def _cb(self, n, shape, d, hint, pending):
        kernels = n["kernels"]
        C, H, W = shape
        npix = d.sum()
        changed = self.out_changed(d, n)
        oh, ow = changed.shape
        if pending is not None:  # the producer's B6 ran this detect
            kid, args = pending
            self.launches.add(kid, args[0], b6_conv_detect(
                *args[1:], npix2=npix,
                out_tiles2=math.ceil(oh / HINT) * math.ceil(ow / HINT)))
        k = n["kernel"]
        keff = (k - 1) * n["dilation"] + 1
        if "B4" in kernels:  # the stem: detect on the frame, 8x32 tiles
            cells = tile_or(changed, HINT, HINT)
            stem = tile_or(changed, *STEM_TILE)
            listed = stem.sum()
            cap = max(1, min(math.ceil(self.capacity_fraction * stem.numel()),
                             stem.numel()))
            overflow = listed > cap
            work = stem | overflow
            self.launches.add("B4", 0.0, b4_stem_detect(
                H, W, C, 4, self.es, npix, cells.numel()))
            px = tiles_to_pixels(work, *STEM_TILE, oh, ow)
            n_px = px.sum()
            cout = n["features"]
            fl = n_px * flops_per_pixel(k, C, cout)
            cover = window_cover(px, keff, 1, (keff - 1) // 2, H, W)
            self.launches.add("B5", fl, b5_stem_conv(
                cover, C, n_px, cout, self.es, k * k * C * cout, listed))
            self.flops += fl
            return cells | overflow
        tiles = tile_or(changed, HINT, HINT)
        n_tiles = tiles.sum()
        px = tiles_to_pixels(tiles, HINT, HINT, oh, ow)
        n_px = px.sum()
        if "B1" in kernels:
            own = tiles_to_pixels(hint, HINT, HINT, H, W).sum()
            self.launches.add("B1", 0.0, b1_detect_sparse(
                own, npix, C, self.es, tiles.numel(), hint.sum()))
        if n["kind"] == "pool":  # re-detecting pool: B8 on its tiles
            w = n["window"]
            cover = window_cover(px, w, w, 0, H, W)
            self.launches.add("B8", 0.0, b8_delta_pool(
                cover, C, self.es, n_px, n_tiles))
            return tiles
        cout = n["features"]
        fl = n_px * flops_per_pixel(k, C, cout)
        cover = window_cover(px, keff, 1, (keff - 1) // 2, H, W)
        wn = k * k * C * cout
        self.flops += fl
        if "B6" in kernels:
            self.pending[self.consumer[n["name"]]] = (
                "B6", (fl, cover, C, n_px, cout, self.es, wn, n_tiles))
        elif "B2" in kernels:
            self.launches.add("B2", fl, b2_delta_conv(
                cover, C, n_px, cout, self.es, wn, n_tiles))
        return tiles
