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

This reference runs free: each layer reads the reference's own output of
the layer before, so its caches follow its own decisions. The layer-wise
judgement (``layerwise.py``) reads the program's stored state instead,
and the launch counts come from there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import netdef

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


def no_tf32():
    """Float32 convolutions and matmuls in float32, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Reference:
    """One camera's CB state over a chain configuration's layers."""

    def __init__(self, config: dict, weights: Dict[str, np.ndarray],
                 taus: List[float], device, storage: str = "bfloat16"):
        no_tf32()
        if "layers" not in config:
            raise ValueError("the free-running reference follows a chain")
        self.nodes = netdef.nodes_of(config)
        self.device = torch.device(device)
        self.q = rounder(storage)
        self.params = [netdef.conv_weights(n, weights, self.q, self.device)
                       if n["kind"] == "conv" else None for n in self.nodes]
        it = iter(taus)
        self.taus = [float(np.float32(next(it))) if n["cb"] else None
                     for n in self.nodes]
        if next(it, None) is not None:
            raise ValueError("more taus than CB layers")
        self.caches: List = [None] * len(self.nodes)
        self.outputs: Dict[str, torch.Tensor] = {}  # the last frame's

    def step(self, frame: torch.Tensor, refresh: bool) -> torch.Tensor:
        """One (H, W, 3) float32 frame; returns the last layer's (C, H, W)
        float32 output (not rounded: the logits the program's output is
        judged against)."""
        x = frame.permute(2, 0, 1).float()
        last = len(self.nodes) - 1
        for i, n in enumerate(self.nodes):
            if n["cb"] and not (n["kind"] == "pool" and n["forward"]):
                if refresh or self.caches[i] is None:
                    self.caches[i] = self.q(x).clone()
                else:
                    d = (x - self.caches[i]).abs().amax(0) > self.taus[i]
                    self.caches[i] = torch.where(d[None], self.q(x),
                                                 self.caches[i])
                y = netdef.apply(n, self.caches[i], self.params[i])
            else:
                y = netdef.apply(n, x, self.params[i])
            x = y if i == last else self.q(y)
            self.outputs[n["name"]] = x
        return x
