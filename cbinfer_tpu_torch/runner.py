"""Streaming video runner (PyTorch port of ``cbinfer_tpu.runner.scan_video``).

The JAX package runs a clip as one ``lax.scan`` over a donated carry. Here
it is a Python frame loop over caches updated in place. Nothing in the loop
reads a device value on the host (no ``.item()``, no ``.cpu()``, no branch
on a tensor), so the host only enqueues work; the caller synchronises once
per clip, when it reads the outputs.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from .convert import CBNet


def _f32(v):
    """A counter as float32: device tensors stay on the device, counters
    known on the host stay Python numbers."""
    return v.float() if isinstance(v, torch.Tensor) else float(v)


def scan_video(net: CBNet, params, frames: torch.Tensor,
               state: Optional[List] = None, collect_stats=True,
               thresholds: Optional[Sequence[float]] = None,
               refresh_every: Optional[int] = None, frame_offset: int = 0,
               refresh_start: bool = False,
               out_map: Optional[Callable] = None):
    """Run a (T, H, W, C) clip through the CB net frame by frame.

    Returns (outputs stacked over T, final_state, stats). ``state`` (default
    a fresh ``net.init_state()``) is updated in place. ``refresh_every=K``
    runs every frame with ``(frame_offset + t) % K == 0`` through
    ``net.apply_refresh``: the accepted-value rule lets a cache drift up to
    tau from the exactly computed value indefinitely, and a periodic full
    recompute bounds that staleness to K frames; ``frame_offset`` (a host
    int) keeps the phase across successive calls on one stream.
    ``refresh_start`` instead runs frame 0 of THIS call through
    ``net.apply_refresh`` (the chunk-start refresh of chunked streaming);
    the two are mutually exclusive. ``out_map`` transforms each frame's output before
    stacking (e.g. an argmax to uint8 class maps). ``collect_stats``:
    ``True`` stacks each per-layer counter over T, ``"mean"`` returns its
    float32 mean over the clip (0-dim device tensors, or floats for the
    counters known on the host), ``False`` drops
    stats (``[]``).
    """
    if state is None:
        state = net.init_state()
    if collect_stats not in (True, False, "mean"):
        raise ValueError(f"collect_stats={collect_stats!r}")
    if refresh_start and refresh_every is not None:
        raise ValueError("refresh_start replaces refresh_every; use one")
    n = frames.shape[0]
    if n == 0:
        raise ValueError("scan_video needs at least one frame")
    ys, per_frame = [], []
    acc = None
    for t in range(n):
        if refresh_every is not None:
            refresh = (frame_offset + t) % refresh_every == 0
        else:
            refresh = refresh_start and t == 0
        step = net.apply_refresh if refresh else net.apply
        y, state, stats = step(params, state, frames[t], thresholds)
        ys.append(out_map(y) if out_map is not None else y)
        if collect_stats == "mean":
            stats = [{k: _f32(v) for k, v in s.items()} for s in stats]
            acc = stats if acc is None else [
                {k: a[k] + s[k] for k in a} for a, s in zip(acc, stats)]
        elif collect_stats:
            per_frame.append(stats)
    if collect_stats == "mean":
        out_stats = [{k: v / n for k, v in a.items()} for a in acc]
    elif collect_stats:
        out_stats = [
            {k: torch.stack([torch.as_tensor(f[i][k], device=frames.device)
                             for f in per_frame]) for k in per_frame[0][i]}
            for i in range(len(per_frame[0]))]
    else:
        out_stats = []
    return torch.stack(ys), state, out_stats
