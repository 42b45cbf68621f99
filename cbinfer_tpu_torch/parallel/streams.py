"""Many independent camera streams on one card or over several (PyTorch
port of ``cbinfer_tpu.parallel.streams``; BASELINE.json configs[4]).

A mesh is a list of ``torch.device``s. Parameters are replicated once per
device; each stream owns its state on its device, so no traffic crosses
devices during a frame. Streams beyond the device count run as sequential
WAVES of one stream per device per dispatch, never stacked into one
batched program: the CB kernels walk a device-side count of one stream's
tiles, and every launch stays in its single-stream steady state, so the
throughput per card is that of running the streams back to back.

Each stream keeps its own ``runner.scan_video_jit``: its CUDA graphs are
bound to its state's addresses (a refresh and a steady graph per stream,
plus a one-frame graph for ``step``), and each stream's graphs have a
memory pool of their own. Streams are dispatched in order on the current
CUDA stream of their device, inside ``torch.cuda.device(dev)``: the
kernels' ctypes launches run in the host thread's current device
context. On CPU devices every form is the eager loop.

``make_stream_mesh(n, device="cpu")`` (or any list of CPU devices) runs the
wave logic on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from ..network import resolve_device
from ..runner import _tensors, scan_video_jit


def make_stream_mesh(n_devices: Optional[int] = None,
                     device="cuda") -> List[torch.device]:
    """The first ``n_devices`` GPUs (default: all of them). Asking for more
    than the machine has raises; nothing shrinks the mesh or moves it to
    the CPU. ``device="cpu"`` gives ``n_devices`` (default 1) CPU entries."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"a mesh of {n} GPUs asked for; this machine has "
                         f"{have}")
    return [torch.device("cuda", i) for i in range(n)]


def _map(fn: Callable, tree):
    """``tree`` (tensors in lists, tuples, dicts and dataclasses; anything
    else passes through) with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def _zip_map(fn: Callable, trees: Sequence):
    """``fn`` applied to the tensors at the same place of several trees of
    one structure (lists and dicts of tensors: the stats)."""
    first = trees[0]
    if isinstance(first, list):
        return [_zip_map(fn, [t[i] for t in trees])
                for i in range(len(first))]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    return fn(list(trees))


def shard_streams(mesh: Sequence[torch.device], tree, batched: bool = True):
    """Place a tree for the streams of ``mesh``. ``batched``: the leaves
    carry a leading stream axis; returns one tree per stream, stream ``s``
    on ``mesh[s % len(mesh)]``. Otherwise the tree is replicated: one tree
    per mesh entry, copied once per distinct device (entries naming the
    same device share it; a leaf already there is not copied)."""
    if not batched:
        per_device = {}
        for dev in mesh:
            dev = torch.device(dev)
            if dev not in per_device:
                per_device[dev] = _map(lambda t: t.to(dev), tree)
        return [per_device[torch.device(dev)] for dev in mesh]
    leaves = _tensors(tree)
    n = int(leaves[0].shape[0]) if leaves else 0
    return [_map(lambda t: t[s].to(mesh[s % len(mesh)]), tree)
            for s in range(n)]


def on_device(dev: torch.device):
    """The context a dispatch to ``dev`` runs in: that device current on
    the card (the kernels launch in the thread's current device context),
    nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def stream_state(net, dev: torch.device):
    """A fresh state of ``net`` on ``dev``."""
    with on_device(dev):
        return _map(lambda t: t.to(dev), net.init_state())


class MultiStreamRunner:
    """Multi-stream CB inference over a mesh of devices.

    Usage:
        runner = MultiStreamRunner(net, params, n_streams=8, mesh=mesh)
        ys, stats = runner.step(frames)       # frames: (S, H, W, C)
        ys, stats = runner.run_clip(clips)    # clips: (S, T, H, W, C)

    ``thresholds`` / ``out_map`` / ``collect_stats`` are ``scan_video``'s;
    deployment loops pass an argmax-to-uint8 ``out_map`` and
    ``collect_stats="mean"``. Outputs: ``step`` gives ``(S, ...)`` outputs
    and stats leaves ``(S,)``; ``run_clip`` gives ``(S, T, ...)`` outputs
    and stats leaves ``(T, S)``, or ``(S,)`` under ``"mean"``; stats are
    ``[]`` when ``collect_stats`` is False. Gathered outputs and stats lie
    on the mesh's first device (a tensor cannot span devices).

    ``gather_outputs=False`` returns a list instead: one entry per stream
    at D = 1, and one list of D per-stream entries per wave at D > 1 (the
    JAX package returns one ``(D, ...)`` array per wave there). A consumer
    that reads the streams one by one is spared the gather's copies.
    """

    def __init__(self, net, params, n_streams: int,
                 mesh: Optional[Sequence] = None, thresholds=None,
                 out_map=None, collect_stats=True,
                 gather_outputs: bool = True):
        if collect_stats not in (True, False, "mean"):
            raise ValueError(f"collect_stats={collect_stats!r}")
        self.net = net
        self.thresholds = (None if thresholds is None
                           else tuple(float(t) for t in thresholds))
        self.out_map = out_map
        self.collect_stats = collect_stats
        self.gather_outputs = gather_outputs
        self.n_streams = n_streams
        self.mesh = [torch.device(d) for d in
                     (mesh if mesh is not None else make_stream_mesh())]
        D = len(self.mesh)
        if n_streams % D:
            raise ValueError(
                f"n_streams={n_streams} must divide over {D} devices")
        # WAVES: at most one stream resident per device per dispatch
        self.n_waves = n_streams // D
        self._D = D
        self.params = shard_streams(self.mesh, params, batched=False)
        self.states = [stream_state(net, self._device(s))
                       for s in range(n_streams)]
        self.scans = [scan_video_jit(net) for _ in range(n_streams)]

    def _device(self, s: int) -> torch.device:
        return self.mesh[s % self._D]

    def reset(self):
        """Every stream back to its cold start: ``init_state()``'s values
        written into the existing tensors, so the captured graphs stay
        bound to them."""
        fresh = {}
        for s, state in enumerate(self.states):
            dev = self._device(s)
            if dev not in fresh:
                fresh[dev] = _tensors(stream_state(self.net, dev))
            with on_device(dev):
                for dst, src in zip(_tensors(state), fresh[dev]):
                    dst.copy_(src)

    def _dispatch(self, s: int, frames, refresh_start: bool,
                  collect_stats):
        dev = self._device(s)
        with on_device(dev):
            frames = torch.as_tensor(frames).to(dev)
            ys, _, stats = self.scans[s](
                self.params[s % self._D], frames, self.states[s],
                thresholds=self.thresholds, refresh_start=refresh_start,
                collect_stats=collect_stats, out_map=self.out_map)
        return ys, stats

    def _finish(self, outs, stats_axis: int):
        ys = [y for y, _ in outs]
        stats = [st for _, st in outs]
        if not self.gather_outputs:
            if self._D == 1:
                return ys, stats
            D = self._D
            return ([ys[w * D:(w + 1) * D] for w in range(self.n_waves)],
                    [stats[w * D:(w + 1) * D] for w in range(self.n_waves)])
        home = self.mesh[0]
        y = torch.stack([t.to(home) for t in ys])
        if not self.collect_stats:
            return y, []
        return y, _zip_map(lambda xs: torch.stack(
            [t.to(home) for t in xs], stats_axis), stats)

    def step(self, frames):
        """One frame per stream, no refresh: (S, H, W, C) -> ((S, ...),
        per-frame stats with (S,) leaves). On the card each stream replays
        a captured one-frame graph."""
        outs = []
        for s in range(self.n_streams):
            ys, st = self._dispatch(s, frames[s][None], False,
                                    bool(self.collect_stats))
            outs.append((ys[0], _map(lambda t: t[0], st)
                         if self.collect_stats else []))
        return self._finish(outs, 0)

    def run_clip(self, clips, refresh_start: bool = False):
        """(S, T, H, W, C) -> ((S, T, ...), stats with (T, S) leaves, or
        (S,) under "mean"). ``refresh_start`` runs each stream's frame 0
        through ``apply_refresh`` (the chunk-start refresh of chunked
        streaming). On the card each stream replays its own graph."""
        outs = [self._dispatch(s, clips[s], refresh_start,
                               self.collect_stats)
                for s in range(self.n_streams)]
        return self._finish(outs, 0 if self.collect_stats == "mean" else 1)

    def graphs(self) -> List[List[dict]]:
        """Per stream, its live graphs (``runner._Graphs.info()``)."""
        return [scan.graphs.info() for scan in self.scans]
