"""Profiling and observability (PyTorch port of ``cbinfer_tpu.profiling``).

* ``trace(logdir)``: a ``torch.profiler`` context writing a Chrome /
  TensorBoard trace of the host and (on the card) the device, in which the
  hand-written kernels appear by their CUDA names, inside the program's
  scopes (``layers.stage``: ``L{k}_{kind}`` layers, their stages,
  ``refresh``, ``out_map``, ``stats``) and the runner's host spans
  (``runner.call``, ``runner.key``, ``runner.copy_in``,
  ``runner.replay[.refresh]``, ``runner.copy_out``). A CUDA graph's replay
  runs no scope: its activities are attributed by the graph's stage map
  (``runner._Graphs.info()``'s ``nodes``, ``runner.stage_maps()``).
* always-on counters: every CB layer returns its changed / computed /
  detect tile counts through the stats channel; ``summarize_stats``
  renders them.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context: host activity, plus the device's when
    CUDA is available; the trace lands in ``logdir`` as
    ``<worker>.<time>.pt.trace.json`` (open it in TensorBoard or Perfetto)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def summarize_stats(stats, specs=None) -> str:
    """Human-readable per-layer table from a scan's stats channel (stacked
    or mean form). For a CBNet's list of stats, ``specs`` is its specs and
    the string is the JAX package's for the same counters; for a
    CBGraphNet's name-keyed stats, ``specs`` is its nodes and each row is
    labelled by node name, in the stats' (topological) order."""
    if isinstance(stats, dict):
        items = list(stats.items())
        kinds = {n.name: n.spec for n in specs} if specs else {}
        width = max([5] + [len(k) for k in stats])
        head = f"{'node':<{width}}"
    else:
        items = list(enumerate(stats))
        kinds = dict(enumerate(specs)) if specs else {}
        width, head = 5, "layer"
    lines = [f"{head} | kind      | mean computed | max | overflow% | "
             "mean detect"]
    for key, s in items:
        label = f"{key:>{width}}" if isinstance(key, int) \
            else f"{key:<{width}}"
        if not s:
            kind = type(kinds[key]).__name__ if kinds else "dense"
            lines.append(f"{label} | {kind:<9} |      --       |  -- |"
                         "    --     |    --")
            continue
        computed = _np(s["computed_tiles"]).astype(np.float64)
        n = float(np.max(_np(s["n_tiles"])))
        ov = float(np.mean(_np(s["overflow"]))) * 100
        det = float(np.mean(_np(s["detect_tiles"])))
        kind = type(kinds[key]).__name__ if kinds else "cb"
        lines.append(
            f"{label} | {kind:<9} | {np.mean(computed)/n:12.1%} |"
            f" {np.max(computed)/n:3.0%} | {ov:8.1f}% | {det:8.1f}")
    return "\n".join(lines)
