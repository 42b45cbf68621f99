"""The plain reference of change-based (CB) inference over a sequential
chain of convolutions and 2x2 max pools, in plain PyTorch.

It reads the pinned weights, taus and frames itself and imports nothing
of the program under test. Per frame and CB layer it follows the CB rule
as the configuration states it:

- detect: a pixel of the layer's input changed when the largest absolute
  difference over its channels between the input and the layer's input
  cache exceeds the layer's tau (compared in float32; the stem compares
  the unrounded frame);
- accept: the changed pixels' values, rounded to the cache dtype, go into
  the input cache; the others keep the value last accepted;
- the layer's output is the layer's function of its input cache (a tile
  recomputed only where its window saw a change keeps exactly that value,
  since the cache did not change under the tiles left alone), rounded to
  the cache dtype;
- a forward-hint pool is the max pool of its input (its input cache
  tracks the producer's output exactly);
- a refresh frame accepts the whole input of every layer;
- a dense (non-CB) layer computes its whole output from its input.

Arithmetic is float32 with TF32 off; values are rounded where the
configuration stores them (weights in the compute dtype, caches and layer
outputs in the cache dtype; biases float32). The same code with
``storage="float8_e4m3fn"`` is the control: the reference at the
precision below the configuration's.

With ``count=True`` it also records, per frame and layer, the masks that
decide the program's work (changed pixels, changed output tiles, the
dirty hints between layers, the stem's capacity overflow) and turns them
into each kernel launch's operations and bytes (``costs.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import costs

HINT = 8          # the dirty-hint grid between layers
STEM_TILE = (8, 32)
E4M3_MAX = 448.0


def rounder(storage: str):
    """The rounding of a stored value to ``storage``, as a float32 map."""
    if storage == "float32":
        return lambda x: x
    if storage == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if storage == "float8_e4m3fn":
        return lambda x: x.clamp(-E4M3_MAX, E4M3_MAX).to(
            torch.float8_e4m3fn).float()
    raise ValueError(f"unknown storage {storage!r}")


def _out_changed(d: torch.Tensor, layer: dict) -> torch.Tensor:
    """Output pixels whose window holds a changed input pixel."""
    m = d.float()[None, None]
    if layer["kind"] == "pool":
        k = layer["window"]
        return F.max_pool2d(m, k, k)[0, 0] > 0
    k = layer["kernel"]
    return F.max_pool2d(m, k, 1, padding=(k - 1) // 2)[0, 0] > 0


class Reference:
    """One camera's CB state over a configuration's layers."""

    def __init__(self, config: dict, weights: Dict[str, np.ndarray],
                 taus: List[float], device, storage: str = "bfloat16",
                 count: bool = False):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.layers = config["layers"]
        self.device = torch.device(device)
        self.q = rounder(storage)
        self.es = 2 if config["cache_dtype"] == "bfloat16" else 4
        self.capacity_fraction = config["capacity_fraction"]
        self.params: List[Optional[tuple]] = []
        self.taus: List[Optional[float]] = []
        it = iter(taus)
        for i, layer in enumerate(self.layers):
            if layer["kind"] == "conv":
                w = torch.from_numpy(np.asarray(weights[f"w{i}"], np.float32))
                b = torch.from_numpy(np.asarray(weights[f"b{i}"], np.float32))
                w = self.q(w.to(self.device)).permute(3, 2, 0, 1).contiguous()
                self.params.append((w, b.to(self.device)))
            else:
                self.params.append(None)
            self.taus.append(float(np.float32(next(it))) if layer["cb"]
                             else None)
        if next(it, None) is not None:
            raise ValueError("more taus than CB layers")
        self.caches: List[Optional[torch.Tensor]] = [None] * len(self.layers)
        self.count = count
        self.launches = costs.Launches(self.device) if count else None
        self.flops = torch.zeros((), dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------ layers

    def _f(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Layer i's function of a (C, H, W) float32 input."""
        layer = self.layers[i]
        if layer["kind"] == "pool":
            k = layer["window"]
            return F.max_pool2d(x[None], k, k)[0]
        w, b = self.params[i]
        k = layer["kernel"]
        y = F.conv2d(x[None], w, b, padding=(k - 1) // 2)[0]
        if layer["activation"] == "relu":
            y = torch.relu(y)
        return y

    def step(self, frame: torch.Tensor, refresh: bool) -> torch.Tensor:
        """One (H, W, 3) float32 frame; returns the last layer's (C, H, W)
        float32 output (not rounded: the logits the program's output is
        judged against)."""
        x = frame.permute(2, 0, 1).float()
        hint = None      # the producer's dirty mask on the 8x8 grid
        pending = None   # a B6 launch waiting for its consumer's detect
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if layer["kind"] == "pool" and layer.get("forward"):
                y = self._f(i, x)
                if self.count and not refresh:
                    hint = self._count_pool_fused(x, hint)
            elif not layer["cb"]:
                y = self._f(i, x)
                if self.count:
                    self.flops += self._dense_flops(i, x)
            else:
                if refresh or self.caches[i] is None:
                    d = None
                    self.caches[i] = self.q(x).clone()
                else:
                    diff = (x - self.caches[i]).abs().amax(0)
                    d = diff > self.taus[i]
                    self.caches[i] = torch.where(d[None], self.q(x),
                                                 self.caches[i])
                y = self._f(i, self.caches[i])
                if self.count:
                    if d is None:
                        self.flops += self._dense_flops(i, x)
                    else:
                        hint, pending = self._count_cb(i, x, d, hint,
                                                       pending)
            x = y if i == last else self.q(y)
        return x

    # ---------------------------------------------------------- counting

    def _dense_flops(self, i: int, x: torch.Tensor) -> float:
        layer = self.layers[i]
        if layer["kind"] != "conv":
            return 0.0
        h, w = x.shape[1:]
        return float(h * w * costs.flops_per_pixel(
            layer["kernel"], x.shape[0], layer["features"]))

    def _count_pool_fused(self, x, hint):
        C, H, W = x.shape
        pairs = hint[:, 0::2] | hint[:, 1::2]
        out = costs.tile_or(hint, 2, 2)  # a pooled 8x8 tile: 2x2 hints
        self.launches.add("B3", 0.0, costs.b3_pool_fused(
            pairs.sum(), C, self.es, out.numel()))
        return out

    def _count_cb(self, i, x, d, hint, pending):
        layer = self.layers[i]
        kernels = layer["kernels"]
        C, H, W = x.shape
        npix = d.sum()
        changed = _out_changed(d, layer)
        oh, ow = changed.shape
        if pending is not None:  # the producer's B6 ran this detect
            kid, args = pending
            self.launches.add(kid, args[0], costs.b6_conv_detect(
                *args[1:], npix2=npix,
                out_tiles2=math.ceil(oh / HINT) * math.ceil(ow / HINT)))
            pending = None
        if "B4" in kernels:  # the stem: detect on the frame, 8x32 tiles
            cells = costs.tile_or(changed, HINT, HINT)
            stem = costs.tile_or(changed, *STEM_TILE)
            listed = stem.sum()
            cap = max(1, min(math.ceil(self.capacity_fraction * stem.numel()),
                             stem.numel()))
            overflow = listed > cap
            work = stem | overflow
            self.launches.add("B4", 0.0, costs.b4_stem_detect(
                H, W, C, 4, self.es, npix, cells.numel()))
            px = costs.tiles_to_pixels(work, *STEM_TILE, oh, ow)
            n_px = px.sum()
            cout = layer["features"]
            fl = n_px * costs.flops_per_pixel(layer["kernel"], C, cout)
            cover = costs.window_cover(px, layer["kernel"], 1,
                                       (layer["kernel"] - 1) // 2, H, W)
            self.launches.add("B5", fl, costs.b5_stem_conv(
                cover, C, n_px, cout, self.es, self.params[i][0].numel(),
                listed))
            self.flops += fl
            return cells | overflow, None
        tiles = costs.tile_or(changed, HINT, HINT)
        n_tiles = tiles.sum()
        px = costs.tiles_to_pixels(tiles, HINT, HINT, oh, ow)
        n_px = px.sum()
        if "B1" in kernels:
            own = costs.tiles_to_pixels(hint, HINT, HINT, H, W).sum()
            self.launches.add("B1", 0.0, costs.b1_detect_sparse(
                own, npix, C, self.es, tiles.numel(), hint.sum()))
        if layer["kind"] == "pool":  # re-detecting pool: B8 on its tiles
            k = layer["window"]
            cover = costs.window_cover(px, k, k, 0, H, W)
            self.launches.add("B8", 0.0, costs.b8_delta_pool(
                cover, C, self.es, n_px, n_tiles))
            return tiles, None
        k, cout = layer["kernel"], layer["features"]
        fl = n_px * costs.flops_per_pixel(k, C, cout)
        cover = costs.window_cover(px, k, 1, (k - 1) // 2, H, W)
        wn = self.params[i][0].numel()
        self.flops += fl
        if "B6" in kernels:
            pending = ("B6", (fl, cover, C, n_px, cout, self.es, wn, n_tiles))
        elif "B2" in kernels:
            self.launches.add("B2", fl, costs.b2_delta_conv(
                cover, C, n_px, cout, self.es, wn, n_tiles))
        return tiles, pending
