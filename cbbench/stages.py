"""The program's scopes in a profiled pass: each device activity of a CUDA
graph replay attributed to the (layer, stage) scope that launched it, and
the runner's host spans.

A replay runs no Python, so its activities carry no scope. The program
notes at capture which scope added each node of the graph (its stage map:
per node that runs on the card as one activity, in capture order, the
scope path, the kind and the kernel's demangled name), and keeps the maps
of its last captures (``cbinfer_tpu_torch.runner.stage_maps()``). This
module imports nothing of the program: ``program_maps`` finds that
function among the loaded modules, and the join takes the maps as plain
data. A program without it (an older one) gives no maps, and every reader
of them returns None.

The join goes by order, since a traced activity keeps its name and times
only (``trace.Activity``). A one-stream capture is a chain, so a replay
runs its nodes in capture order, one after another on the stream: a
replay is a run of consecutive activities whose kinds and names are a
map's nodes' (a kernel by its name; a copy and a fill by kind alone, and
either for the other, as the profiler names them unreliably). Where two
maps fit the same run and disagree, the run stays unattributed; nothing
is guessed. Between two replays lie the activities
the host launched between their two ``cudaGraphLaunch`` calls: where the
launches the host made there (a copy, a fill or a kernel each) match those
activities one for one, an activity whose launch lay inside a
``runner.copy_in`` or ``runner.copy_out`` span is the runner's.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import union

PROGRAM_RUNNER = "cbinfer_tpu_torch.runner"
# the innermost stage scope of a node's path -> its bucket
STAGE_BUCKET = {
    "detect": "detect", "accept_hinted": "detect", "compact": "compact",
    "delta_kernel": "kernel", "patch_conv": "kernel", "cached_conv": "kernel",
    "band_conv": "kernel", "out_pad": "kernel",
}
BUCKETS = ("detect", "compact", "kernel", "refresh", "none")
REFRESH = "refresh"
RUNNER = "runner"
COPY_SPANS = ("runner.copy_in", "runner.copy_out")
CALL_SPAN = "runner.call"
REPLAY_SPANS = ("runner.replay", "runner.replay.refresh")
GRAPH_LAUNCH = "cudaGraphLaunch"
# the host runtime calls that each put one activity on the device
LAUNCH_PREFIXES = ("cudaMemcpy", "cudaMemset", "cudaLaunch", "cuLaunch")


def program_maps() -> Optional[List[dict]]:
    """The stage maps the program under test kept (``runner.stage_maps()``
    of a loaded ``cbinfer_tpu_torch``), or None where it keeps none."""
    fn = getattr(sys.modules.get(PROGRAM_RUNNER), "stage_maps", None)
    return None if fn is None else list(fn())


def activity_kind(name: str) -> str:
    """``memcpy``, ``memset`` or ``kernel``: a copy or fill node may run as
    a copy kernel of CUDA's own (``Memcpy DtoD ...``, ``memcpy32_post``)."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _same_kind(a: str, b: str) -> bool:
    """Kinds that one node's activity may show: a kernel is a kernel; a
    copy and a fill pass for each other, since the profiler has been seen
    to name a copy node's activity ``Memset (Device)``."""
    return a == b or (a != "kernel" and b != "kernel")


def launch_kind(name: str) -> Optional[str]:
    """The kind of activity a host runtime call puts on the device, or
    None for a call that puts none (and for a graph launch)."""
    if not name.startswith(LAUNCH_PREFIXES):
        return None
    if "Memcpy" in name:
        return "memcpy"
    if "Memset" in name:
        return "memset"
    return "kernel"


def bucket(path: str) -> str:
    """A node's bucket: ``refresh`` anywhere under it, else its innermost
    stage's, else ``none`` (layer glue, dense layers, ``out_map``,
    ``stats``)."""
    parts = path.split("/")
    if REFRESH in parts:
        return REFRESH
    for p in reversed(parts):
        if p in STAGE_BUCKET:
            return STAGE_BUCKET[p]
    return "none"


def layer_of(path: str) -> str:
    """The layer part of a path: its scopes up to the last that is not a
    stage (``refresh/L0_conv``, ``L3_conv``), "" outside every layer."""
    parts = path.split("/")
    while parts and parts[-1] in STAGE_BUCKET:
        parts.pop()
    return "/".join(parts)


def stage_of(path: str) -> str:
    """The innermost stage scope of a path, or "" where it has none."""
    return next((p for p in reversed(path.split("/")) if p in STAGE_BUCKET),
                "")


class Join:
    """The pass's activities attributed. ``where[i]``: activity i's scope
    path from a map, ``RUNNER``, or None (unattributed); ``replays``: per
    replay found, (first activity, one past its last, the map's index or
    None where maps disagree)."""

    def __init__(self, acts, where, replays):
        self.acts, self.where, self.replays = acts, where, replays

    def seconds(self, key) -> Dict[str, float]:
        """Device seconds of the map-attributed activities by ``key(path)``
        (summed durations)."""
        out: Dict[str, float] = defaultdict(float)
        for a, w in zip(self.acts, self.where):
            if w is not None and w != RUNNER:
                out[key(w)] += a.end - a.start
        return dict(out)

    def total(self) -> float:
        return sum(a.end - a.start for a in self.acts)

    def runner_s(self) -> float:
        return sum(a.end - a.start for a, w in zip(self.acts, self.where)
                   if w == RUNNER)

    def unattributed_s(self) -> float:
        return sum(a.end - a.start for a, w in zip(self.acts, self.where)
                   if w is None)

    def replay_s(self) -> float:
        """Device seconds of every activity inside a replay found."""
        return sum(a.end - a.start for i, j, _ in self.replays
                   for a in self.acts[i:j])

    def idle_in_replays(self, t0: float, t1: float) -> Tuple[float, float]:
        """(idle seconds inside the replays, between a replay's first
        activity's start and its last one's end; idle seconds of [t0, t1]
        in all)."""
        inside = 0.0
        for i, j, _ in self.replays:
            span = self.acts[i:j]
            lo, hi = span[0].start, max(a.end for a in span)
            inside += (hi - lo) - union((a.start, a.end) for a in span)
        busy = union((max(a.start, t0), min(a.end, t1)) for a in self.acts)
        return inside, (t1 - t0) - busy


def _fits(nodes: Sequence, acts: Sequence, kinds: Sequence[str],
          i: int) -> bool:
    if i + len(nodes) > len(acts):
        return False
    for n, (_, kind, name) in enumerate(nodes):
        if not _same_kind(kinds[i + n], kind) or (
                name is not None and name != acts[i + n].name):
            return False
    return True


def _find_replays(acts: Sequence, maps: Sequence[dict]):
    """Runs of consecutive activities that are a map's nodes, in order:
    (first, one past the last, map index or None)."""
    kinds = [activity_kind(a.name) for a in acts]
    index = [k for k, m in enumerate(maps) if m.get("nodes")]
    out, i = [], 0
    while i < len(acts):
        fit = [k for k in index if _fits(maps[k]["nodes"], acts, kinds, i)]
        if not fit:
            i += 1
            continue
        lengths = {len(maps[k]["nodes"]) for k in fit}
        paths = {tuple(p for p, _, _ in maps[k]["nodes"]) for k in fit}
        n = min(lengths)
        out.append((i, i + n, fit[0] if len(paths) == 1 else None))
        i += n
    return out


def _pair(segment: List[int], launches: List[Tuple], acts, where,
          from_end: bool):
    """Activities ``segment`` (indices) against the host's launches
    (name, start, end, span) made between the same two graph launches, one
    for one in order, as long as kinds agree; an activity whose launch lay
    in a copy span is the runner's. ``from_end``: the host's first
    launches may lie before the traced window, so pair from the last."""
    if not from_end and len(segment) != len(launches):
        return
    pairs = zip(reversed(segment), reversed(launches)) if from_end \
        else zip(segment, launches)
    for i, (name, _, _, span) in pairs:
        if not _same_kind(launch_kind(name), activity_kind(acts[i].name)):
            return
        if span in COPY_SPANS:
            where[i] = RUNNER


def _enclosing(spans: List[Tuple], t: float) -> Optional[str]:
    """The name of the innermost span of ``spans`` holding time ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s, e)
    return best[0] if best else None


def join(acts: Sequence, host: Sequence[Tuple], maps: Sequence[dict]) -> Join:
    """Attribute the activities ``acts`` (``.name``, ``.start``, ``.end``,
    in start order) of a profiled pass by the stage ``maps`` (dicts with
    ``nodes``: (path, kind, name) per node) and the host events ``host``
    ((name, start, end))."""
    acts = sorted(acts, key=lambda a: a.start)
    where: List[Optional[str]] = [None] * len(acts)
    replays = _find_replays(acts, maps)
    for i, j, k in replays:
        if k is not None:
            for n, (path, _, _) in enumerate(maps[k]["nodes"]):
                where[i + n] = path
    spans = [h for h in host if h[0] in COPY_SPANS + REPLAY_SPANS]
    calls = sorted((h for h in host if h[0] == GRAPH_LAUNCH
                    or launch_kind(h[0]) is not None), key=lambda h: h[1])
    graph_at = [n for n, h in enumerate(calls) if h[0] == GRAPH_LAUNCH]
    if len(graph_at) == len(replays):
        # the segments between replays against the launches between the
        # host's graph launches
        bounds = [(0, 0)] + [(j, g + 1) for (_, j, _), g
                             in zip(replays, graph_at)]
        ends = [(i, g) for (i, _, _), g in zip(replays, graph_at)] + [
            (len(acts), len(calls))]
        for seg, ((a0, c0), (a1, c1)) in enumerate(zip(bounds, ends)):
            launches = [(h[0], h[1], h[2], _enclosing(spans, h[1]))
                        for h in calls[c0:c1]]
            _pair(list(range(a0, a1)), launches, acts, where, seg == 0)
    return Join(acts, where, replays)


def stage_seconds(j: Join) -> Dict[str, float]:
    """Device seconds of the map-attributed activities in each bucket."""
    got = j.seconds(bucket)
    return {b: got.get(b, 0.0) for b in BUCKETS}


def top_pairs(j: Join, frames: int, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` largest (layer, stage) pairs, ``layer:stage``, in device
    microseconds a frame."""
    got = j.seconds(lambda p: f"{layer_of(p)}:{stage_of(p)}")
    return [(k, v / frames * 1e6)
            for k, v in sorted(got.items(), key=lambda kv: -kv[1])[:n]]


def host_calls(host: Sequence[Tuple]) -> List[Tuple[float, float]]:
    """Per ``runner.call`` span that holds a replay: (seconds from its
    start to the start of its last ``runner.replay*`` span, the host's
    work before it launches the graph; seconds from that span's end to
    the call's end, the copy out and the return). The launch itself is
    left out of both: under the profiler's device tracing a
    ``cudaGraphLaunch`` costs the host many times what it costs
    untraced."""
    replays = sorted((h for h in host if h[0] in REPLAY_SPANS),
                     key=lambda h: h[1])
    out = []
    for _, s, e in sorted((h for h in host if h[0] == CALL_SPAN),
                          key=lambda h: h[1]):
        inside = [r for r in replays if r[1] >= s and r[2] <= e]
        if inside:
            out.append((inside[-1][1] - s, e - inside[-1][2]))
    return out


_CACHE: List = []  # [(slice, number of maps, Join)]: the last join


def of_ctx(ctx) -> Optional[Join]:
    """The join of a run's profiled pass (``ctx.slice``) by the program's
    maps, made once for all readers; None without a device trace or
    maps."""
    s = getattr(ctx, "slice", None)
    if s is None or not s.acts:
        return None
    maps = program_maps()
    if not maps:
        return None
    if _CACHE and _CACHE[0][0] is s and _CACHE[0][1] == len(maps):
        return _CACHE[0][2]
    got = join(s.acts, s.host, maps)
    _CACHE[:] = [(s, len(maps), got)]
    return got
