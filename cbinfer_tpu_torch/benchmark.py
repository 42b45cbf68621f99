"""Benchmark harness: CB against dense on identical inputs (PyTorch port of
``cbinfer_tpu.benchmark``, ``cbinfer_tpu/benchmark.py``).

The methodology is the reference's: every timed chunk is a DISTINCT clip,
timed in one pass after an untimed warm-up clip; one scalar fetch at the
end synchronises, and the host-device round trip of a null op, measured
the same way, is subtracted. On the card both sides run at the device's
pace: the dense baseline as a captured CUDA graph of the frame loop (the
eager loop measures the host), the CB path through ``runner.scan_video_jit``
(one graph replay a chunk). On CPU tensors both run eagerly, so a CPU run
gives the reference's accuracy and FLOP figures, and its times are the
CPU's.

Not ported: ``devices_or_die`` and ``wait_for_tpu`` (``:56``, ``:105``),
the TPU runtime's watchdogs, and the reference's flat4 ingest staging
(``scan_video(ingest=True)``, ``:254``): the port's stem reads the HWC
frames themselves.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import RunConfig
from .metrics import _np, change_rate_histogram, effective_flops, miou, pck
from .network import resolve_device
from .runner import _Graphs, scan_video_jit
from .video import SpriteVideo, SpriteVideoConfig


def scalar_sync(v) -> float:
    """Block until ``v`` is computed by fetching one scalar derived from it
    (``cbinfer_tpu/benchmark.py:38``)."""
    return float((v[-1] if v.ndim > 3 else v).float().sum())


def concat_stats(chunk_stats: Sequence):
    """Concatenate per-chunk scan stats along the frame axis, on the host
    (``cbinfer_tpu/benchmark.py:43``): every leaf (a tensor, numpy array
    or number; a 0-dim mean becomes one entry) of each chunk's list or
    dict of per-layer dicts, in order. FLOP and overflow accounting must
    cover ALL timed chunks: under a refresh prolog on some chunks the last
    chunk alone over- or under-states the reduction."""
    def cat(*xs):
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], (list, tuple)):
            return type(xs[0])(cat(*ys) for ys in zip(*xs))
        return np.concatenate([np.atleast_1d(_np(x)) for x in xs])
    return cat(*chunk_stats)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (the first card):
    every time kept beside it."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def measure_sync_overhead(reps: int = 5, device="cuda") -> float:
    """Seconds of one host-device round trip (a null op's dispatch and its
    scalar fetch): the MEDIAN of ``reps`` samples
    (``cbinfer_tpu/benchmark.py:144``). Subtract from single-sync elapsed
    times."""
    dev = resolve_device(device)
    a = torch.ones((8, 128), device=dev)
    _ = float(a.sum() * 0 + 1.0)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ = float(a.sum() * 0 + 1.0)
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def device_ms(fn: Callable[[], Any], device) -> float:
    """Milliseconds of ``fn()`` at the device's pace: CUDA events around it
    on the card, with any host sync inside raising (``fn`` must only
    enqueue: replays of captured graphs); the host clock around it on the
    CPU, where nothing runs asynchronously."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def time_chunked(run_chunk: Callable, chunks: Sequence,
                 frames_per_chunk: int,
                 sync_overhead: Optional[float] = None) -> float:
    """Time ``run_chunk(i, chunk)`` over distinct chunks in ONE pass
    (``cbinfer_tpu/benchmark.py:159``).

    ``run_chunk`` must already be warm (kernels built, graphs captured,
    cold-start state filled on a chunk that is NOT in ``chunks``) and
    must return a tensor to sync on. Returns frames/sec."""
    if sync_overhead is None:
        sync_overhead = measure_sync_overhead(device=chunks[0].device)
    out = None
    t0 = time.perf_counter()
    for i, ch in enumerate(chunks):
        out = run_chunk(i, ch)
    scalar_sync(out)
    elapsed = time.perf_counter() - t0 - sync_overhead
    return len(chunks) * frames_per_chunk / max(1e-9, elapsed)


@dataclasses.dataclass
class BenchResult:
    """``cbinfer_tpu/benchmark.py:180-202``."""

    dense_fps: float
    cb_fps: float
    speedup: float
    cold_start_ms: float
    flop_reduction: float
    metric_name: str
    metric_value: float          # CB-vs-dense agreement (1.0 = identical)
    change_rates: list
    config: Optional[dict] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def headline(self) -> Dict:
        """The one-line metric of a bench run."""
        return {
            "metric": f"frames/sec/chip (CB path); {self.metric_name} vs "
                      "dense",
            "value": round(self.cb_fps, 3),
            "unit": "fps",
            "vs_baseline": round(self.speedup, 3),
        }


def _state_tensors(state):
    for s in (state.values() if isinstance(state, dict) else state):
        if s is not None:
            for f in dataclasses.fields(s):
                yield getattr(s, f.name)


def bench_network(net, params, clips: Sequence[torch.Tensor],
                  metric: str = "miou", num_classes: int = 8,
                  thresholds=None, refresh_every: Optional[int] = None,
                  run_config: Optional[RunConfig] = None) -> BenchResult:
    """Benchmark one ``CBNet``: dense baseline against the CB scan
    (``cbinfer_tpu/benchmark.py:205-324``).

    clips: >= 2 clips of identical (T, H, W, C) shape with DISTINCT frames
    (``make_clips``), on the card (or all on the CPU). clips[0] is the
    untimed warm-up (kernel builds, library algorithm choices, graph
    captures, the CB cold start); clips[1:] are timed in one pass each for
    dense and CB. The CB path chains its state across chunks, so it is
    timed in steady state under the given refresh policy, with
    ``collect_stats="mean"`` (the deployment observability form).

    ``refresh_every=K`` refreshes every frame whose index in the stream is
    a multiple of K, the reference's schedule. ``scan_video_jit`` can
    refresh only a chunk's first frame, so K must be a multiple of T: the
    chunks starting at a multiple of K then refresh, the same schedule.
    Any other K raises (the eager loop would time the host, not the card).
    """
    if len(clips) < 2:
        raise ValueError("need >= 2 clips: clips[0] warms, clips[1:] time")
    T = int(clips[0].shape[0])
    if refresh_every is not None and refresh_every % T:
        raise ValueError(
            f"refresh_every={refresh_every} is not a multiple of the clip "
            f"length T={T}: scan_video_jit refreshes only a chunk's first "
            "frame, so this schedule has no graphed form")
    for c in clips:
        scalar_sync(c)  # resident before timing
    sync_overhead = measure_sync_overhead(device=clips[0].device)
    taus = None if thresholds is None else [float(t) for t in thresholds]

    def refresh_at(offset: int) -> bool:
        return refresh_every is not None and offset % refresh_every == 0

    # ---- dense baseline: one CUDA graph of the frame loop ----
    # outputs are collected DURING the timed pass (the reference's rule)
    dense_graphs = _Graphs(1)

    def dense_scan(ch):
        return dense_graphs.run(("dense",), lambda fs: torch.stack(
            [net.apply_dense(params, f) for f in fs]), ch)

    scalar_sync(dense_scan(clips[0]))  # warm + capture (untimed clip)
    dense_outs = []

    def dense_chunk(i, ch):
        d = dense_scan(ch)
        dense_outs.append(d)
        return d

    dense_fps = time_chunked(dense_chunk, clips[1:], T, sync_overhead)

    # ---- CB path ----
    # cold start: frame 0 from a fresh state, eagerly (a replay would
    # not re-run the state's set-up); the median of 3 samples, each on a
    # distinct frame, clamped at 0
    y0 = net.apply(params, net.init_state(), clips[0][0])[0]
    scalar_sync(y0)
    cold_samples = []
    n_frames_total = len(clips) * T
    for r in range(3):
        idx = (r + 1) % n_frames_total
        frame = clips[idx // T % len(clips)][idx % T]
        t0 = time.perf_counter()
        y0 = net.apply(params, net.init_state(), frame)[0]
        scalar_sync(y0)
        cold_samples.append(time.perf_counter() - t0 - sync_overhead)
    cold_ms = max(0.0, float(np.median(cold_samples))) * 1e3

    run = scan_video_jit(net)
    state = net.init_state()

    def cb_scan(ch, offset):
        return run(params, ch, state, thresholds=taus,
                   refresh_start=refresh_at(offset), collect_stats="mean")

    ys = cb_scan(clips[0], 0)[0]
    scalar_sync(ys)  # cold start + cache warm; the first key's capture
    # the other refresh key, if a timed chunk takes it, is captured here
    # from a copy of the state, which is then written back in place (a
    # graph reads the state at its captured addresses)
    if any(refresh_at((i + 1) * T) != refresh_at(0)
           for i in range(len(clips) - 1)):
        saved = [t.clone() for t in _state_tensors(state)]
        run(params, clips[0], state, thresholds=taus,
            refresh_start=not refresh_at(0), collect_stats="mean")
        for t, s in zip(_state_tensors(state), saved):
            t.copy_(s)
        del saved
    cb_outs, cb_stats = [], []

    def cb_chunk(i, ch):
        ys, _, stats = cb_scan(ch, (i + 1) * T)
        cb_outs.append(ys)
        cb_stats.append(stats)
        return ys

    cb_fps = time_chunked(cb_chunk, clips[1:], T, sync_overhead)

    # ---- accuracy + compute accounting (untimed; the timed outputs) ----
    cb_np = np.concatenate([_np(y) for y in cb_outs])
    dn_np = np.concatenate([_np(d) for d in dense_outs])
    if metric == "miou":
        mval = miou(cb_np, dn_np, num_classes)
    elif metric == "pck":
        mval = pck(cb_np, dn_np)
    else:
        raise ValueError(metric)
    stats = concat_stats(cb_stats)
    ef = effective_flops(stats, net.specs, net.in_shape,
                         net.cfg.tile.tile_h, net.cfg.tile.tile_w)
    return BenchResult(
        dense_fps=dense_fps, cb_fps=cb_fps, speedup=cb_fps / dense_fps,
        cold_start_ms=cold_ms, flop_reduction=ef["flop_reduction"],
        metric_name=metric, metric_value=mval,
        change_rates=change_rate_histogram(stats),
        config=None if run_config is None else dataclasses.asdict(
            run_config))


class ABArm:
    """One form of a network in an interleaved same-process A/B (the
    methodology of the JAX package's ``scripts/exp_*_ab.py``): its own
    ``scan_video_jit`` runner and one state, reset in place from a
    pristine copy before each rep, so each key keeps one graph. A rep is
    a refresh-prolog chunk that warms the state (untimed), then the
    steady chunks timed by CUDA events around their replays
    (``device_ms``), with the collector off inside the window."""

    def __init__(self, net, params, thresholds=None, out_map=None,
                 collect_stats=False):
        self.net, self.params, self.taus = net, params, thresholds
        self.out_map, self.collect_stats = out_map, collect_stats
        self.run = scan_video_jit(net)
        self.state = net.init_state()
        self._pristine = [t.clone() for t in _state_tensors(self.state)]

    def chunk(self, frames, refresh=False):
        """(outputs, stats) of one chunk from the arm's state."""
        ys, _, stats = self.run(self.params, frames, self.state,
                                thresholds=self.taus, refresh_start=refresh,
                                collect_stats=self.collect_stats,
                                out_map=self.out_map)
        return ys, stats

    def reset(self):
        for t, s in zip(_state_tensors(self.state), self._pristine):
            t.copy_(s)

    def warm(self, chunks: Sequence[torch.Tensor]):
        """The eager first call and the capture of the refresh and the
        steady key, outside any timed window (a first call may build
        kernels and sync)."""
        self.reset()
        self.chunk(chunks[0], refresh=True)
        self.chunk(chunks[1])

    def rep(self, chunks: Sequence[torch.Tensor]):
        """(ms of ``chunks[1:]``, their (outputs, stats)) after a reset and
        ``chunks[0]`` as the refresh prolog."""
        self.reset()
        self.chunk(chunks[0], refresh=True)
        outs: List = []
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            ms = device_ms(lambda: outs.extend(
                self.chunk(c) for c in chunks[1:]), chunks[0].device)
        finally:
            if gc_on:
                gc.enable()
        return ms, outs


def make_clips(cfg: RunConfig, n: int = 3) -> List[torch.Tensor]:
    """n same-statistics clips with distinct frames (one video stream,
    consecutive segments), on ``cfg.pipeline.device``: the warm-up and
    timed chunks of ``bench_network`` (``cbinfer_tpu/benchmark.py:327``).
    The frames are the reference's byte for byte."""
    dev = resolve_device(cfg.pipeline.device)
    video = SpriteVideo(SpriteVideoConfig(
        height=cfg.height, width=cfg.width, n_sprites=4,
        sprite_size=max(16, cfg.height // 15), speed=4.0, noise_std=0.002,
        seed=cfg.seed))
    return [torch.from_numpy(video.clip(cfg.frames)).to(dev)
            for _ in range(n)]


def make_clip(cfg: RunConfig) -> torch.Tensor:
    """``cbinfer_tpu/benchmark.py:337``."""
    return make_clips(cfg, 1)[0]
