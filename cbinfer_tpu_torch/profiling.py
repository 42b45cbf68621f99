"""Profiling and observability (PyTorch port of ``cbinfer_tpu.profiling``).

* ``trace(logdir)``: a ``torch.profiler`` context writing a Chrome /
  TensorBoard trace of the host and (on the card) the device, in which the
  hand-written kernels appear by their CUDA names.
* always-on counters: every CB layer returns its changed / computed /
  detect tile counts through the stats channel; ``summarize_stats``
  renders them.
* ``stage_timer``: coarse host-side wall-clock section timing for scripts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

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


@contextlib.contextmanager
def stage_timer(record: Dict[str, float], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record[name] = record.get(name, 0.0) + time.perf_counter() - t0


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def summarize_stats(stats: List[Dict], specs=None) -> str:
    """Human-readable per-layer table from a scan's stats channel (stacked
    or mean form; the same string as the JAX package's for the same
    counters)."""
    lines = ["layer | kind      | mean computed | max | overflow% | "
             "mean detect"]
    for i, s in enumerate(stats):
        if not s:
            kind = type(specs[i]).__name__ if specs else "dense"
            lines.append(f"{i:5d} | {kind:<9} |      --       |  -- |"
                         "    --     |    --")
            continue
        computed = _np(s["computed_tiles"]).astype(np.float64)
        n = float(np.max(_np(s["n_tiles"])))
        ov = float(np.mean(_np(s["overflow"]))) * 100
        det = float(np.mean(_np(s["detect_tiles"])))
        kind = type(specs[i]).__name__ if specs else "cb"
        lines.append(
            f"{i:5d} | {kind:<9} | {np.mean(computed)/n:12.1%} |"
            f" {np.max(computed)/n:3.0%} | {ov:8.1f}% | {det:8.1f}")
    return "\n".join(lines)
