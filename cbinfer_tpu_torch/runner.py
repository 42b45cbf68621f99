"""Streaming video runner (PyTorch port of ``cbinfer_tpu.runner``).

The JAX package runs a clip as one ``lax.scan`` over a donated carry. Here
``scan_video`` is a Python frame loop over caches updated in place. Nothing
in the loop reads a device value on the host (no ``.item()``, no
``.cpu()``, no branch on a tensor), so the host only enqueues work.

The one-dispatch forms, ``scan_video_jit`` and the live ``FrameStepper``,
are the counterpart of the JAX package's jitted scans: on the card each
call replays a captured CUDA graph of that same loop, one launch for a
K-frame chunk. A graph reads and writes tensors at the addresses it was
captured with, so every state tensor keeps its storage for the life of
the state (the layers update caches in place and never rebind them), and
the params are bound by address too. On the CPU there are no graphs and
both forms run the eager loop.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ConvSpec
from .netview import NetView
from .network import torch_dtype
from .ops.kernels import launches

STAT_KEYS = ("changed_pixels", "changed_tiles", "computed_tiles",
             "detect_tiles", "n_tiles", "overflow")

# Host-known counters (a refresh frame's, every frame's n_tiles) as device
# constants, one tensor per distinct tuple of values and device. A net's
# frames give two tuples (refresh and steady), so this stays small. A
# captured graph reads these tensors: an entry is never dropped.
_CONSTANTS: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _constants(values: Tuple[int, ...], device) -> Tuple[torch.Tensor, ...]:
    """0-dim int32 device views of ``values``: made by one copy from the
    host at their first use, which an eager call makes before any capture
    of the same frames (a capture cannot copy from the host)."""
    key = (values, torch.device(device))
    got = _CONSTANTS.get(key)
    if got is None:
        got = _CONSTANTS[key] = torch.tensor(
            values, dtype=torch.int32).to(device).unbind(0)
    return got


def _stack_counters(values: Sequence, device) -> torch.Tensor:
    """Counters (0-dim device tensors, or ints and bools known on the
    host) -> one 1-D device tensor, by one stack: bools and int32 promote
    to int32."""
    host = tuple(int(v) for v in values if not isinstance(v, torch.Tensor))
    consts = iter(_constants(host, device) if host else ())
    return torch.stack([v if isinstance(v, torch.Tensor) else next(consts)
                        for v in values])


def _is_bool(v) -> bool:
    return (v.dtype == torch.bool if isinstance(v, torch.Tensor)
            else isinstance(v, bool))


def _items(stats) -> List[Tuple[Any, Dict[str, Any]]]:
    """(key, counters) pairs of one frame's stats: a CBNet's list by layer
    index, or a CBGraphNet's dict by node name in topological order."""
    return list(stats.items()) if isinstance(stats, dict) \
        else list(enumerate(stats))


def _frame_counters(stats, device):
    """One frame's per-layer stats -> (layout, vector): ``layout`` says
    whether the stats are name-keyed and names each layer's keys in dict
    order, with whether the counter is boolean; the vector holds the
    integer counters, then the boolean ones, each block in layer order
    (one stack per frame instead of a device op per counter)."""
    items = _items(stats)
    layout = (isinstance(stats, dict),
              tuple((key, tuple((k, _is_bool(v)) for k, v in s.items()))
                    for key, s in items))
    ints = [v for _, s in items for v in s.values() if not _is_bool(v)]
    bools = [v for _, s in items for v in s.values() if _is_bool(v)]
    if not ints and not bools:
        return layout, None
    return layout, _stack_counters(ints + bools, device)


def _layer_dicts(layout, ints: Sequence, bools: Sequence):
    """Inverse of ``_frame_counters``' order: per-layer dicts of ``ints``
    (the integer counters' values) and ``bools`` (the boolean ones'), in
    a list or a name-keyed dict as the layout says."""
    named, rows = layout
    it_i, it_b = iter(ints), iter(bools)
    dicts = [(key, {k: next(it_b) if b else next(it_i) for k, b in keys})
             for key, keys in rows]
    return dict(dicts) if named else [d for _, d in dicts]


def _empty_stats(net, device):
    """``collect_stats=True``'s stats of an empty clip: ``(0,)`` stacks."""
    dicts = [(r.key, {k: torch.empty(0, device=device, dtype=torch.bool
                                     if k == "overflow" else torch.int32)
                      for k in STAT_KEYS} if r.is_cb else {})
             for r in NetView.of(net).rows]
    return dict(dicts) if hasattr(net, "nodes") else [d for _, d in dicts]


def _row_dtype(view: NetView, i: int, cfg) -> Optional[torch.dtype]:
    """The dtype of row i's output: a CB layer's cache dtype, a dense
    conv's compute dtype; any other row passes its producers' on (None:
    the frame's own)."""
    row = view.rows[i]
    if row.is_cb:
        return torch_dtype(cfg.cache_dtype)
    if isinstance(row.spec, ConvSpec):
        return torch_dtype(cfg.compute_dtype)
    dtypes = [d for d in (_row_dtype(view, p, cfg) for p in row.producers)
              if d is not None]
    return functools.reduce(torch.promote_types, dtypes) if dtypes else None


def _output_like(net, out_map, device) -> torch.Tensor:
    """A frame output's shape and dtype without running a frame: the
    output layer's, on the meta device, through ``out_map``."""
    view = NetView.of(net)
    shape, dtype = net.in_shape, None
    if view.rows:
        out = len(view.rows) - 1
        if hasattr(net, "nodes"):
            out = next(i for i, r in enumerate(view.rows)
                       if r.key == net.output)
        shape = view.rows[out].out_shape
        dtype = _row_dtype(view, out, net.cfg)
    y = torch.empty(shape, dtype=dtype or torch.float32, device="meta")
    y = out_map(y) if out_map is not None else y
    return torch.empty((0,) + tuple(y.shape), dtype=y.dtype, device=device)


def scan_video(net, params, frames: torch.Tensor,
               state: Optional[Any] = None, collect_stats=True,
               thresholds: Optional[Sequence[float]] = None,
               refresh_every: Optional[int] = None, frame_offset: int = 0,
               refresh_start: bool = False,
               out_map: Optional[Callable] = None):
    """Run a (T, H, W, C) clip through the CB net (a ``CBNet`` or a
    ``CBGraphNet``) frame by frame.

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
    ``True`` stacks each per-layer counter over T (int32, bool for
    ``overflow``), ``"mean"`` returns its float32 mean over the clip
    (0-dim tensors), ``False`` drops stats (``[]``); the stats are a list
    by layer (``CBNet``) or a dict by node name in topological order
    (``CBGraphNet``). The counters of a frame travel as one stacked
    vector, so stats cost a few device ops a frame, not one per counter.

    An empty clip returns ``(0, ...)`` outputs of the frame output's (or
    ``out_map``'s) shape and dtype, ``(0,)`` stacks (``[]`` without stats)
    and the state unchanged; it raises with ``refresh_start`` (no frame to
    refresh) and under ``"mean"`` (no mean of nothing), as the JAX package
    does.
    """
    if state is None:
        state = net.init_state()
    if collect_stats not in (True, False, "mean"):
        raise ValueError(f"collect_stats={collect_stats!r}")
    if refresh_start and refresh_every is not None:
        raise ValueError("refresh_start replaces refresh_every; use one")
    n = frames.shape[0]
    if n == 0:
        if refresh_start:
            raise ValueError("scan_video(refresh_start=True) needs at "
                             "least one frame (got an empty clip)")
        if collect_stats == "mean":
            raise ValueError("scan_video(collect_stats='mean') needs at "
                             "least one frame (got an empty clip)")
        ys = _output_like(net, out_map, frames.device)
        return ys, state, (_empty_stats(net, frames.device)
                           if collect_stats else [])
    ys, vectors = [], []
    layout = None
    for t in range(n):
        if refresh_every is not None:
            refresh = (frame_offset + t) % refresh_every == 0
        else:
            refresh = refresh_start and t == 0
        step = net.apply_refresh if refresh else net.apply
        y, state, stats = step(params, state, frames[t], thresholds)
        ys.append(out_map(y) if out_map is not None else y)
        if collect_stats:
            lay, vec = _frame_counters(stats, frames.device)
            if layout is None:
                layout = lay
            elif lay != layout:
                raise ValueError("the stats' layout changed within a clip")
            vectors.append(vec)
    out_stats: Any = []
    if collect_stats and vectors[0] is None:
        out_stats = _layer_dicts(layout, (), ())
    elif collect_stats:
        table = torch.stack(vectors, 1)  # (counters, T)
        n_int = sum(1 for _, keys in layout[1] for _, b in keys if not b)
        if collect_stats == "mean":
            # an exact integer sum, then one rounding to float32
            means = table.sum(1).float().div_(n).unbind(0)
            out_stats = _layer_dicts(layout, means[:n_int], means[n_int:])
        else:
            out_stats = _layer_dicts(layout, table[:n_int].unbind(0),
                                     table[n_int:].bool().unbind(0))
    return torch.stack(ys), state, out_stats


# ------------------------------ packed stats --------------------------------


def _stat_dicts(stats) -> List[Dict[str, Any]]:
    """Flatten a stats container (a list of per-layer dicts, or a dict
    keyed by node name in topological order) into an ordered list of the
    non-empty counter dicts."""
    if isinstance(stats, dict):
        if "changed_tiles" in stats:
            return [stats]
        out: List[Dict[str, Any]] = []
        for v in stats.values():
            out.extend(_stat_dicts(v))
        return out
    if isinstance(stats, (list, tuple)):
        out = []
        for v in stats:
            out.extend(_stat_dicts(v))
        return out
    return []


def pack_stats(stats, device=None) -> torch.Tensor:
    """Per-layer stats dicts -> ONE (n_cb_layers, 6) int32 tensor, a row
    per CB layer in ``STAT_KEYS`` order (dense layers' empty dicts are
    skipped), on ``device`` (default: the stats' own device, the CPU when
    every counter is known on the host); a scan's stacked (T,) counters
    give (n_cb_layers, 6, T). One output buffer for a graph to write and a
    caller to copy, instead of six per layer."""
    dicts = _stat_dicts(stats)
    values = [d[k] for d in dicts for k in STAT_KEYS]
    if device is None:
        device = next((v.device for v in values
                       if isinstance(v, torch.Tensor)), torch.device("cpu"))
    if not dicts:
        return torch.zeros((0, 6), dtype=torch.int32, device=device)
    packed = _stack_counters(values, device).to(torch.int32)
    return packed.view((len(dicts), len(STAT_KEYS))
                       + tuple(packed.shape[1:]))


def unpack_stats(packed) -> List[Dict[str, Any]]:
    """Inverse of pack_stats (host side): (L, 6) tensor -> list of dicts of
    numpy scalars ((L, 6, T) -> of (T,) arrays)."""
    arr = (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
           else np.asarray(packed))
    return [{k: arr[i, j] for j, k in enumerate(STAT_KEYS)}
            for i in range(arr.shape[0])]


# ------------------------------- CUDA graphs --------------------------------


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a params or state tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _tensors(getattr(tree, f))]
    return []


def _addresses(params, state) -> Tuple:
    """What a captured graph is bound to: the state's addresses, and the
    params' addresses and versions (a weight written in place is packed
    anew for the tile-conv kernels, at another address)."""
    return (tuple(t.data_ptr() for t in _tensors(state)),
            tuple((t.data_ptr(), t._version) for t in _tensors(params)))


def _copy_out(tree):
    """A fresh copy of a graph's static outputs (a later replay overwrites
    them): each storage once, views rebuilt on the copy; host values
    pass through."""
    memo: Dict[int, torch.Tensor] = {}

    def one(v):
        if isinstance(v, torch.Tensor):
            base = v if v._base is None else v._base
            c = memo.get(id(base))
            if c is None:
                c = memo[id(base)] = base.clone()
            if base is v:
                return c
            if c.stride() != base.stride():
                return v.clone()
            return c.as_strided(v.size(), v.stride(),
                                v.storage_offset() - base.storage_offset())
        if isinstance(v, list):
            return [one(x) for x in v]
        if isinstance(v, tuple):
            return tuple(one(x) for x in v)
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        return v
    return one(tree)


class _Graph:
    """One captured graph: its static input and outputs, the kernel
    launches its capture recorded, and how often it was replayed."""

    def __init__(self, graph, frames, out, launched, meta):
        self.graph, self.frames, self.out = graph, frames, out
        self.launches, self.meta, self.replays = launched, meta, 0


class _Graphs:
    """The CUDA graphs of one runner, one per key, the least recently used
    dropped past ``limit``; they share one memory pool, which is safe
    because their replays never overlap and each replay's outputs are
    copied out before the next one.

    ``run(key, fn, frames)``: CPU frames run ``fn`` eagerly (there are no
    graphs on the CPU). On the card, the first call of a key runs ``fn``
    eagerly: it is the warm-up (lazy kernel builds, library algorithm
    choices, the tile convs' weight packing) and the call's result; then
    ``fn`` is captured on a static copy of the frames, with any host sync
    raising, and every later call of the key copies its frames in,
    replays, and returns a copy of the outputs. A capture or replay that
    fails raises: nothing runs the eager loop instead."""

    def __init__(self, limit: int):
        self.limit = limit
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = \
            collections.OrderedDict()
        self._pool = None
        self.captures = 0  # graphs captured so far, dropped ones included

    def run(self, key: Tuple, fn: Callable, frames: torch.Tensor, meta=None):
        if frames.device.type == "cpu":
            return fn(frames)
        if frames.device.type != "cuda":
            raise ValueError(f"frames on {frames.device}: the graph runner "
                             "takes CUDA or CPU tensors")
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            entry.frames.copy_(frames)
            entry.graph.replay()
            entry.replays += 1
            return _copy_out(entry.out)
        out = fn(frames)
        self._graphs[key] = self._capture(fn, frames, meta)
        while len(self._graphs) > self.limit:
            self._graphs.popitem(last=False)
        return out

    def _capture(self, fn, frames, meta) -> _Graph:
        static = torch.empty_like(frames)
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = launches()
        # entering the capture synchronises the device on purpose; inside
        # it, any host sync raises (the caller's mode is restored after)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = fn(static)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        launched = {k: v - before[k] for k, v in launches().items()
                    if v != before[k]}
        self.captures += 1
        return _Graph(graph, static, out, launched, meta)

    def info(self) -> List[Dict[str, Any]]:
        """Per live graph: what the caller described at capture
        (``meta``), the kernel launches the capture recorded (a replay
        launches them again; the wrappers' counters count the capture
        only), and the replays so far."""
        return [{**(g.meta or {}), "launches": dict(g.launches),
                 "replays": g.replays} for g in self._graphs.values()]


def write_taus(static: torch.Tensor, thresholds) -> torch.Tensor:
    """Write a thresholds vector into ``static`` (a float32 vector on the
    card or the CPU) in place, without a host sync: a tensor by a device
    copy, host numbers rounded to float32 and copied from pinned memory
    asynchronously (a copy from pageable memory waits for the card; the
    pinned block is not reused before the copy has run). A captured graph
    that reads ``static`` then takes the new values at its next replay."""
    if isinstance(thresholds, torch.Tensor):
        return static.copy_(thresholds)
    host = torch.from_numpy(np.asarray(thresholds, dtype=np.float32))
    if static.is_cuda:
        return static.copy_(host.pin_memory(), non_blocking=True)
    return static.copy_(host)


def scan_video_jit(net):
    """``scan_video`` in one dispatch per call: returns
    ``fn(params, frames, state, *, thresholds=None, refresh_start=False,
    collect_stats=True, out_map=None) -> (ys, state, stats)``, the state
    updated in place as by ``scan_video``.

    On the card each call replays a CUDA graph of the frame loop, captured
    per (frames' shape and dtype, ``refresh_start``, ``collect_stats``,
    ``out_map``, whether thresholds are given, the state's and params'
    addresses) after the key's first, eager call. Thresholds are runtime
    values, as in the JAX package's jitted scan: the kernels read tau from
    device memory, so each call writes its thresholds (host numbers or a
    tensor) into one static float32 vector per device (``write_taus``)
    before the replay, and one graph serves every threshold vector. A new
    state object (other addresses) captures anew; at most 4 graphs stay
    live (a refresh and a steady graph for two keys). On CPU tensors it is
    the eager ``scan_video``. ``fn.graphs`` holds the runner
    (``fn.graphs.info()``)."""
    graphs = _Graphs(4)
    statics: Dict[torch.device, torch.Tensor] = {}

    def run(params, frames, state, *, thresholds=None, refresh_start=False,
            collect_stats=True, out_map=None):
        taus = None
        if thresholds is not None:
            taus = statics.get(frames.device)
            if taus is None:
                taus = statics[frames.device] = torch.empty(
                    len(thresholds), dtype=torch.float32,
                    device=frames.device)
            write_taus(taus, thresholds)
        key = (tuple(frames.shape), frames.dtype, frames.device,
               bool(refresh_start), collect_stats, out_map,
               thresholds is not None, _addresses(params, state))

        def fn(fs):
            ys, _, stats = scan_video(net, params, fs, state,
                                      collect_stats=collect_stats,
                                      thresholds=taus,
                                      refresh_start=refresh_start,
                                      out_map=out_map)
            return ys, stats
        ys, stats = graphs.run(key, fn, frames, meta={
            "frames": int(frames.shape[0]),
            "refresh_start": bool(refresh_start)})
        return ys, state, stats

    run.graphs = graphs
    return run


# ------------------------------ live stepping -------------------------------


def _make_state_packer(state, threshold_bytes: int):
    """Move every state tensor of at most ``threshold_bytes`` bytes into
    one flat arena per (device, dtype), as a view, so that the layers'
    in-place updates land in the arena; returns (arenas, n_packed).

    The JAX package packs small carry leaves into arenas to cut the
    buffers a dispatch hands over; here the state never leaves the card,
    and a graph replay hands over nothing, so the knob changes where the
    small caches live and no result. Each view starts on a 256-byte
    boundary (the kernels' vector loads need aligned rows). Call it before
    any graph is captured: it rebinds the packed tensors once."""
    align = 256
    owners = []
    for s in (state.values() if isinstance(state, dict) else state):
        if s is None:
            continue
        for f in s.__dataclass_fields__:
            t = getattr(s, f)
            if t.numel() * t.element_size() <= threshold_bytes:
                owners.append((s, f, t))
    groups: Dict[Tuple, list] = {}
    for s, f, t in owners:
        groups.setdefault((t.device, t.dtype), []).append((s, f, t))
    arenas = {}
    for (device, dtype), members in groups.items():
        step = align // torch.empty((), dtype=dtype).element_size()
        offsets, o = [], 0
        for _, _, t in members:
            offsets.append(o)
            o += -(-t.numel() // step) * step
        arena = torch.empty(o, dtype=dtype, device=device)
        for (s, f, t), off in zip(members, offsets):
            view = arena[off:off + t.numel()].view(t.shape)
            view.copy_(t)
            setattr(s, f, view)
        arenas[(device, dtype)] = arena
    return arenas, len(owners)


def _as_frames(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


class FrameStepper:
    """Streaming interface for frames that arrive one at a time (camera,
    socket), the live twin of ``scan_video``: ``thresholds`` fixed at
    construction (a float32 vector on the state's device, which the
    kernels read at run time), the
    periodic dense refresh that bounds cache drift on unbounded streams
    (``refresh_every``), and ``out_map`` for the deployment output form.
    Frame 0 always refreshes: it is the dense cold start that fills the
    caches.

    ``__call__(frame)`` steps one frame, ``step_chunk(frames)`` K frames
    with mean-form stats; on the card each is one replay of a captured CUDA
    graph (a plain and a refreshing graph per K, captured after each
    one's first, eager call), on the CPU the eager loop. Both entries share
    one ``_since_refresh`` count, so mixing them keeps the bounded-
    staleness contract. ``reset()`` writes a fresh state into the existing
    tensors, so the graphs stay valid. At most 8 graphs stay live.

    Knobs, as in the JAX package:
      ``collect_stats``: False (default, the deployment form) returns no
        stats; ``"packed"`` one (L, 6) int32 tensor per frame (see
        pack_stats; decode with unpack_stats); True the per-layer dicts.
      ``pack_small_buffers``: byte threshold; state tensors at or below it
        live in one arena per dtype (``_make_state_packer``). 0 = off.
      ``bind_params``: kept for the JAX package's API. A graph reads the
        params at the addresses it was captured with, so they are always
        bound; the flag changes nothing.
    """

    def __init__(self, net, params, thresholds=None,
                 refresh_every: Optional[int] = None, out_map=None,
                 collect_stats: Any = False, pack_small_buffers: int = 0,
                 bind_params: bool = False):
        if collect_stats not in (True, False, "packed"):
            raise ValueError(f"collect_stats={collect_stats!r}")
        self._net = net
        self._params = params
        self._state = net.init_state()
        tensors = _tensors(self._state)
        self._device = tensors[0].device if tensors else torch.device("cpu")
        # fixed for the stepper's life, as the JAX package's; on the
        # stepper's device once, so no frame copies them from the host
        self._taus = None if thresholds is None else write_taus(
            torch.empty(len(thresholds), dtype=torch.float32,
                        device=self._device), thresholds)
        self._refresh_every = refresh_every
        self._t = 0
        self._since_refresh = 0
        self._out_map = out_map
        self._collect_stats = collect_stats
        self._bind_params = bind_params
        self._n_packed = 0
        if pack_small_buffers > 0:
            self._arenas, self._n_packed = _make_state_packer(
                self._state, pack_small_buffers)
        self.graphs = _Graphs(8)

    @property
    def state(self):
        """The live state (updated in place; ``checkpoint.restore(...,
        like=..., in_place=True)`` writes a saved one into it)."""
        return self._state

    def reset(self):
        """Back to frame 0: init_state()'s values written into the existing
        tensors (rebinding them would strand the captured graphs)."""
        for dst, src in zip(_tensors(self._state),
                            _tensors(self._net.init_state())):
            dst.copy_(src)
        self._t = 0
        self._since_refresh = 0

    def _key(self, kind, frames, refresh):
        return (kind, tuple(frames.shape), frames.dtype, refresh,
                _addresses(self._params, self._state))

    def __call__(self, frame) -> Tuple[torch.Tensor, Any]:
        # refresh decisions key off _since_refresh (shared with
        # step_chunk) rather than _t % refresh_every, so mixing the two
        # entry points keeps the bounded-staleness contract
        refresh = self._t == 0 or (
            self._refresh_every is not None
            and self._since_refresh + 1 > self._refresh_every)
        frames = _as_frames(frame, self._device)[None]
        step = self._net.apply_refresh if refresh else self._net.apply

        def fn(fs):
            y, _, stats = step(self._params, self._state, fs[0], self._taus)
            if self._out_map is not None:
                y = self._out_map(y)
            if self._collect_stats == "packed":
                stats = pack_stats(stats, self._device)
            elif not self._collect_stats:
                stats = []
            return y, stats
        y, stats = self.graphs.run(self._key("frame", frames, refresh), fn,
                                   frames, meta={"frames": 1,
                                                 "refresh_start": refresh})
        self._since_refresh = 1 if refresh else self._since_refresh + 1
        self._t += 1
        return y, stats

    def step_chunk(self, frames) -> Tuple[torch.Tensor, Any]:
        """K consecutive frames ((K, H, W, C)) in one dispatch; returns
        ((K, ...) outputs, mean-form stats). The per-call overhead
        amortizes over K at the price of K-1 frames of added capture
        latency. The dense refresh runs as frame 0's prolog of the first
        chunk and of any chunk where ``refresh_every`` frames would
        otherwise elapse since the last refresh."""
        frames = _as_frames(frames, self._device)
        k = int(frames.shape[0])
        refresh = self._t == 0 or (
            self._refresh_every is not None
            and self._since_refresh + k > self._refresh_every)

        def fn(fs):
            ys, _, stats = scan_video(self._net, self._params, fs,
                                      self._state, collect_stats="mean",
                                      thresholds=self._taus,
                                      refresh_start=refresh,
                                      out_map=self._out_map)
            return ys, stats
        ys, stats = self.graphs.run(self._key("chunk", frames, refresh), fn,
                                    frames, meta={"frames": k,
                                                  "refresh_start": refresh})
        self._since_refresh = k if refresh else self._since_refresh + k
        self._t += k
        return ys, stats
