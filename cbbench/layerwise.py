"""The layer-wise judgement: every CB node of every frame judged from the
program's own stored state, in plain PyTorch.

Per frame the harness hands over, for each CB node, the program's input
cache before the frame and after it and its output cache after it, as
tensors in the program's storage. A node's input is the program's own:
the frame, a CB producer's output cache, or (a concat, a dense node) the
reference's function of those. Nothing is propagated from the reference's
own decisions, so the depth of the net does not compound a difference.
Two things are checked per node:

- decisions: with d the largest channel of |x - in_cache_before| of a
  pixel, in float32 from the stored values, ``in_cache_after`` equals the
  input rounded to the cache dtype where d > tau and ``in_cache_before``
  elsewhere, exactly (a refresh frame accepts every pixel). No band around
  tau is allowed: the fused tile conv + detect (B6) decides on the value
  rounded to the cache dtype, as the consumer would read it back. A pixel
  outside the rule counts in ``decisions``;
- values: the output cache's logical map against the node's float32
  function of ``in_cache_after`` (weights rounded to the compute dtype),
  rounded to the cache dtype. ``layer_gap`` is the largest difference
  over the map divided by the largest |output| of the node's function in
  that frame: a share of the layer's own scale, so that layers of any
  magnitude read alike. A pool is exact (gap 0); a conv's kernel sums in
  another order than the reference, which moves a value across a rounding
  of the cache dtype at most.

A forward-hint pool keeps no input cache (its output tracks its
producer's): it is judged by values alone, from its input. The control is
the same function at float8 e4m3 storage (input and weights rounded to
it, output too) on the same stored input, compared with the same rounded
reference.

Where a node's input lies inside its input cache's storage (the program
pads the map with margins) is found once, on the first frame, a refresh,
at which the cache holds the whole input: the one offset at which it
does. The output cache holds its map at the top left.

Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import costs, netdef
from .reference import no_tf32, rounder

Stored = Dict[str, tuple]  # node -> (in_before, in_after, out_cache)


def _chw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(2, 0, 1).float()


def _gap(out: torch.Tensor, want: torch.Tensor, scale: torch.Tensor):
    """max |out - want| as a share of ``scale`` (0 where both are 0)."""
    diff = (out - want).abs().amax()
    return torch.where(scale > 0, diff / scale.clamp_min(1e-30),
                       torch.where(diff > 0, float("inf"), 0.0))


def locate(storage: torch.Tensor, want: torch.Tensor) -> Optional[tuple]:
    """The (row, column) offset at which the (H, W, C) map ``want`` lies in
    the (Hs, Ws, Cs) ``storage``'s first C channels, or None. Where
    several fit (a map with no structure), the first in row order."""
    h, w, c = want.shape
    for oh in range(storage.shape[0] - h + 1):
        for ow in range(storage.shape[1] - w + 1):
            if torch.equal(storage[oh:oh + h, ow:ow + w, :c].float(), want):
                return oh, ow
    return None


class LayerJudge:
    """Judges one camera's frames node by node; ``frame`` once per frame,
    the first a refresh, in order."""

    def __init__(self, config: dict, weights, taus, in_shape, device,
                 control: bool = False, count: bool = False):
        no_tf32()
        self.nodes = netdef.nodes_of(config)
        self.out_name = netdef.output_name(config, self.nodes)
        self.shapes = netdef.shapes(self.nodes, in_shape)
        self.device = torch.device(device)
        self.q = rounder(config["cache_dtype"])
        self.qc = rounder("float8_e4m3fn") if control else None
        convs = [n for n in self.nodes if n["kind"] == "conv"]
        self.params = {n["name"]: netdef.conv_weights(
            n, weights, rounder(config["compute_dtype"]), self.device)
            for n in convs}
        self.cparams = {n["name"]: netdef.conv_weights(
            n, weights, self.qc, self.device) for n in convs} if control \
            else {}
        cb = [n["name"] for n in self.nodes if n["cb"]]
        if len(taus) != len(cb):
            raise ValueError(f"{len(taus)} taus for {len(cb)} CB nodes")
        self.taus = {k: float(np.float32(t)) for k, t in zip(cb, taus)}
        self.offsets: Dict[str, tuple] = {}
        self.counter = costs.Counter(
            self.nodes, config["capacity_fraction"],
            2 if config["cache_dtype"] == "bfloat16" else 4,
            self.device) if count else None
        zero = torch.zeros((), device=self.device)
        self.worst = {k: zero.clone() for k in cb}       # layer_gap by node
        self.cworst = {k: zero.clone() for k in cb}      # the control's
        self.wrong = {k: torch.zeros((), dtype=torch.int64,
                                     device=self.device) for k in cb}
        self.frames = 0

    def _interior(self, n: dict, storage: torch.Tensor) -> torch.Tensor:
        h, w, _ = self.shapes[n["inputs"][0]]
        c = sum(self.shapes[i][2] for i in n["inputs"])
        oh, ow = self.offsets[n["name"]]
        return storage[oh:oh + h, ow:ow + w, :c]

    def frame(self, frame: torch.Tensor, refresh: bool, stored: Stored):
        """One (H, W, 3) float32 frame and the program's state around it.
        Returns (the output node's float32 (C, H, W) map from the
        program's inputs, the control's, or None; the frame's largest
        layer gap; the frame's pixels outside the decision rule; the
        control's largest layer gap in the frame, or None)."""
        if self.frames == 0 and not refresh:
            raise ValueError("the first judged frame must be a refresh")
        self.frames += 1
        vals = {"input": frame.permute(2, 0, 1).float()}
        cvals = dict(vals)
        gap = torch.zeros((), device=self.device)
        wrong = torch.zeros((), dtype=torch.int64, device=self.device)
        cgap = torch.zeros((), device=self.device) if self.qc else None
        if self.counter:
            self.counter.start()
        for n in self.nodes:
            name = n["name"]
            ins = [vals[i] for i in n["inputs"]]
            x = ins[0] if len(ins) == 1 else torch.cat(ins, 0)
            d = None
            if n["kind"] == "concat":
                y = x
                if self.qc:
                    cvals[name] = torch.cat([cvals[i] for i in n["inputs"]])
            elif not n["cb"]:
                y = netdef.apply(n, x, self.params.get(name))
                if self.qc:
                    c = netdef.apply(n, self.qc(cvals[n["inputs"][0]]),
                                     self.cparams.get(name))
                    cvals[name] = c if name == self.out_name else self.qc(c)
                if name != self.out_name:
                    y = self.q(y)
            else:
                y, d, g, bad, cg = self._cb(n, x, refresh, stored[name])
                cvals[name] = y
                gap = torch.maximum(gap, g)
                wrong += bad
                if cg is not None:
                    cgap = torch.maximum(cgap, cg)
            vals[name] = y
            if self.counter:
                self.counter.node(name, tuple(x.shape), d, refresh)
        return (vals[self.out_name], cvals[self.out_name] if self.qc
                else None, gap, wrong, cgap)

    def _cb(self, n, x, refresh: bool, st: tuple):
        """A CB node: (its output as consumers read it, the changed pixels
        or None, its layer gap, its pixels outside the rule, the
        control's gap or None)."""
        name = n["name"]
        before, after, out = st
        h, w, c = self.shapes[name]
        y = _chw(out[:h, :w, :c])
        d = None
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        if n["kind"] == "pool" and n["forward"]:
            src = x  # no input cache: the output tracks the input
        else:
            qx = self.q(x)
            if name not in self.offsets:
                at = locate(after, qx.permute(1, 2, 0))
                if at is None:
                    raise AssertionError(
                        f"node {name}: the refresh frame's input is nowhere "
                        "in its input cache")
                self.offsets[name] = at
            src = _chw(self._interior(n, after))
            if refresh:
                want = qx
            else:
                prev = _chw(self._interior(n, before))
                d = (x - prev).abs().amax(0) > self.taus[name]
                want = torch.where(d[None], qx, prev)
            bad = (src != want).any(0).sum()
        ref = netdef.apply(n, src, self.params.get(name))
        scale = ref.abs().amax()
        g = _gap(y, self.q(ref), scale)
        self.worst[name] = torch.maximum(self.worst[name], g)
        self.wrong[name] += bad
        cg = None
        if self.qc:
            ctl = self.qc(netdef.apply(n, self.qc(src),
                                       self.cparams.get(name)))
            cg = _gap(ctl, self.q(ref), scale)
            self.cworst[name] = torch.maximum(self.cworst[name], cg)
        return y, d, g, bad, cg

    def by_node(self) -> Dict[str, list]:
        """node -> [its largest layer gap, its pixels outside the rule(,
        the control's largest gap)] over the frames judged."""
        out = {}
        for k in self.worst:
            row = [float(self.worst[k]), int(self.wrong[k])]
            if self.qc:
                row.append(float(self.cworst[k]))
            out[k] = row
        return out
