"""The program's scopes and spans, and the benchmark's join of a profiled
pass against the stage maps (``cbbench/stages.py``), on the CPU: the join
on synthetic activities and maps, the readers of the new per-layer
metrics on a synthetic run, the recorder driven by a stand-in node
counter over the w8 scene net, and the runner's host span in a CPU
profile. The card's side is ``tests/test_torch_gpu.py::
test_stage_map_attributes_a_profiled_replay``."""

import types

import pytest
import torch

from cbbench import spec, stages
from cbinfer_tpu_torch import layers, zoo
from cbinfer_tpu_torch.runner import FrameStepper, scan_video, scan_video_jit

H, W = 64, 128
K = "void k_{}<float>(int)"  # a kernel's demangled name


class Act:
    """A device activity as ``cbbench.trace`` keeps it."""

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end


def _map(refresh, nodes):
    return {"frames": 2, "refresh_start": refresh, "nodes": nodes}


STEADY = _map(False, [
    ("L0_conv/detect", "kernel", K.format("det")),
    ("L0_conv/compact", "memset", None),
    ("L0_conv/compact", "kernel", K.format("sort")),
    ("L0_conv/delta_kernel", "kernel", K.format("conv")),
    ("L0_conv", "kernel", K.format("glue")),
    ("out_map", "kernel", None),
])
REFRESH = _map(True, [
    ("refresh/L0_conv", "kernel", K.format("dense")),
    ("refresh/L0_conv/detect", "kernel", K.format("det")),
    ("out_map", "kernel", None),
])


def _replay(nodes, t, dur=1.0, gap=0.5, names=None):
    """Activities of one replay of ``nodes`` from time ``t``: each node
    ``dur`` long, ``gap`` apart."""
    out = []
    for n, (_, kind, name) in enumerate(nodes):
        nm = (names or {}).get(n) or name or {
            "kernel": "void other<int>()", "memcpy": "Memcpy DtoD (Device "
            "-> Device)", "memset": "Memset (Device)"}[kind]
        out.append(Act(nm, t, t + dur))
        t += dur + gap
    return out, t


def _pass(calls):
    """A synthetic traced pass: per call (its map, names to swap in), a
    host ``runner.call`` holding a copy in (its launch and the copy's
    activity), the replay's span and graph launch, and a copy out."""
    acts, host, t = [], [], 0.0
    for nodes, names in calls:
        c0 = t
        host += [("runner.copy_in", t, t + 1), ("cudaMemcpyAsync", t + .2,
                                                  t + .4)]
        acts.append(Act("Memcpy DtoD (Device -> Device)", t + .3, t + .8))
        span = "runner.replay.refresh" if nodes is REFRESH["nodes"] \
            else "runner.replay"
        host += [(span, t + 1, t + 2), ("cudaGraphLaunch", t + 1.1,
                                        t + 1.9)]
        replay, t = _replay(nodes, t + 2.0, names=names)
        acts += replay
        host += [("runner.copy_out", t, t + 1), ("cudaMemcpyAsync", t + .1,
                                                   t + .3)]
        acts.append(Act("Memcpy DtoD (Device -> Device)", t + .2, t + .7))
        t += 1.0
        host.append(("runner.call", c0, t))
        t += 3.0  # the host between calls: the card idles
    return acts, host, t


def test_join_attributes_every_activity_exactly():
    acts, host, _ = _pass([(REFRESH["nodes"], None),
                           (STEADY["nodes"], None),
                           (STEADY["nodes"], None)])
    j = stages.join(acts, host, [STEADY, REFRESH])
    assert [k for _, _, k in j.replays] == [1, 0, 0]
    assert j.unattributed_s() == 0 and j.runner_s() == pytest.approx(3.0)
    paths = [w for w in j.where if w not in (None, stages.RUNNER)]
    assert paths == [p for p, _, _ in REFRESH["nodes"]] + 2 * [
        p for p, _, _ in STEADY["nodes"]]
    got = stages.stage_seconds(j)
    assert got == {"detect": 2.0, "compact": 4.0, "kernel": 2.0,
                   "refresh": 2.0, "none": 5.0}
    assert sum(got.values()) == pytest.approx(j.replay_s())
    assert stages.top_pairs(j, 3, 2) == [("L0_conv:compact", 4 / 3 * 1e6),
                                        ("out_map:", 1e6)]


@pytest.mark.parametrize("path,want", [
    ("refresh/L0_conv/detect", "refresh"), ("refresh", "refresh"),
    ("L2_conv/compact", "compact"), ("L0_conv_patch_stem/patch_conv",
                                     "kernel"),
    ("L1_pool/accept_hinted", "detect"), ("L6_conv", "none"),
    ("out_map", "none"), ("stats", "none"), ("", "none")])
def test_refresh_takes_precedence_over_the_stage(path, want):
    assert stages.bucket(path) == want


def test_a_copy_node_may_show_as_a_fill():
    """The profiler has named a copy node's activity ``Memset (Device)``
    and a fill's ``Memset (Unknown)``; a copy or fill node matches either,
    a kernel node only its own name."""
    acts, host, _ = _pass([(STEADY["nodes"], {1: "Memcpy DtoD (Device -> "
                                               "Device)"}),
                           (STEADY["nodes"], {1: "memcpy32_post"})])
    j = stages.join(acts, host, [STEADY])
    assert [k for _, _, k in j.replays] == [0, 0]
    assert j.unattributed_s() == 0
    acts, host, _ = _pass([(STEADY["nodes"], {1: K.format("fill")})])
    assert stages.join(acts, host, [STEADY]).replays == []


def test_a_replay_that_fits_no_map_stays_unattributed():
    """A kernel name the map does not hold (or one node fewer) matches no
    map: the replay's activities stay unattributed, and the runner's
    copies around it too (the host's graph launch has no replay to pair
    with), and nothing is guessed."""
    acts, host, _ = _pass([(STEADY["nodes"], {3: K.format("other")}),
                           (STEADY["nodes"][:-1], None)])
    j = stages.join(acts, host, [STEADY, REFRESH])
    assert j.replays == [] and j.runner_s() == 0
    assert j.unattributed_s() == pytest.approx(j.total())


def test_maps_that_disagree_leave_the_replay_unattributed():
    other = _map(False, [("L9_conv",) + n[1:] for n in STEADY["nodes"]])
    acts, host, _ = _pass([(STEADY["nodes"], None)])
    j = stages.join(acts, host, [STEADY, other])
    assert [k for _, _, k in j.replays] == [None]
    assert j.unattributed_s() == pytest.approx(j.replay_s())
    assert stages.stage_seconds(j) == dict.fromkeys(stages.BUCKETS, 0.0)
    same = dict(STEADY, frames=4)  # another capture of the same graph
    assert [k for _, _, k in stages.join(acts, host, [STEADY, same])
            .replays] == [0]


def test_idle_inside_and_between_replays():
    acts, host, t = _pass([(STEADY["nodes"], None),
                           (STEADY["nodes"], None)])
    j = stages.join(acts, host, [STEADY])
    inside, idle = j.idle_in_replays(acts[0].start, acts[-1].end)
    n = len(STEADY["nodes"])
    assert inside == pytest.approx(2 * 0.5 * (n - 1))
    busy = stages.union((a.start, a.end) for a in acts)
    assert idle == pytest.approx(acts[-1].end - acts[0].start - busy)
    assert inside < idle  # the host's gaps between calls are the rest


def _ctx(acts, host, entry="chunk", frames=4):
    s = types.SimpleNamespace(acts=acts, host=host, frames=frames,
                              t0=acts[0].start if acts else 0.0,
                              t1=max(a.end for a in acts) if acts else 1.0)
    return types.SimpleNamespace(entry=entry, slice=s, host_call_s=[1e-4],
                                 ref_launches=None, ref_flops=None)


NEW = ["stage_us_per_frame.detect", "stage_us_per_frame.compact",
       "stage_us_per_frame.kernel", "stage_us_per_frame.refresh",
       "stage_us_per_frame.none", "idle_in_replay_pct", "unattributed_pct",
       "host_us_before_launch.live", "host_us_after_launch.live"]


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_without_maps_or_spans(monkeypatch, name):
    read = spec.reader(name)
    monkeypatch.setattr(stages, "program_maps", lambda: None)
    acts, host, _ = _pass([(STEADY["nodes"], None)])
    live = name.endswith(".live")
    assert read(_ctx([], [], "live" if live else "chunk")) is None
    if live:  # a program that opens no runner spans
        assert read(_ctx(acts, [h for h in host
                                if not h[0].startswith("runner.")],
                         "live")) is None
        assert read(_ctx(acts, host, "chunk")) is None
    else:  # a program that keeps no maps
        assert read(_ctx(acts, host)) is None
        monkeypatch.setattr(stages, "program_maps", lambda: [])
        assert read(_ctx(acts, host)) is None


@pytest.mark.parametrize("name,want", [
    ("stage_us_per_frame.detect", 2.0 / 4 * 1e6),
    ("stage_us_per_frame.compact", 4.0 / 4 * 1e6),
    ("stage_us_per_frame.kernel", 2.0 / 4 * 1e6),
    ("stage_us_per_frame.refresh", 2.0 / 4 * 1e6),
    ("stage_us_per_frame.none", 5.0 / 4 * 1e6),
    # the stray activity, launched before the host's trace began
    ("unattributed_pct", 100.0 * 1.0 / 19.0),
    # a call's replay span starts 1 s after its start and ends 1 s later;
    # then 1.5 s a node of the graph (3 on the refresh call, 6 on the
    # others) and 1 s of copy
    ("host_us_before_launch.live", 1.0 * 1e6),
    ("host_us_after_launch.live", (5.5 + 10.0 + 10.0) / 3 * 1e6)])
def test_readers_on_a_synthetic_run(monkeypatch, name, want):
    acts, host, _ = _pass([(REFRESH["nodes"], None),
                           (STEADY["nodes"], None),
                           (STEADY["nodes"], None)])
    acts.insert(0, Act("void stray<int>()", -2.0, -1.0))
    monkeypatch.setattr(stages, "program_maps", lambda: [STEADY, REFRESH])
    entry = "live" if name.endswith(".live") else "chunk"
    got = spec.reader(name)(_ctx(acts, host, entry, frames=4))
    assert got == pytest.approx(want)


def test_idle_in_replay_reader(monkeypatch):
    acts, host, _ = _pass([(STEADY["nodes"], None),
                           (STEADY["nodes"], None)])
    monkeypatch.setattr(stages, "program_maps", lambda: [STEADY])
    ctx = _ctx(acts, host)
    j = stages.join(acts, host, [STEADY])
    inside, idle = j.idle_in_replays(ctx.slice.t0, ctx.slice.t1)
    assert spec.reader("idle_in_replay_pct")(ctx) == pytest.approx(
        100.0 * inside / idle)
    assert 0 < 100.0 * inside / idle < 100


def test_host_calls_split_each_call_at_its_replay():
    host = [("runner.call", 0.0, 10.0), ("runner.key", 1.0, 2.0),
            ("runner.replay", 3.0, 4.0), ("runner.copy_out", 4.0, 9.0),
            ("runner.call", 20.0, 25.0),  # an eager call: no replay
            ("runner.call", 30.0, 34.0),
            ("runner.replay.refresh", 31.0, 33.0)]
    assert stages.host_calls(host) == [(3.0, 6.0), (1.0, 1.0)]


def test_the_new_metrics_are_declared_for_their_cells():
    bench = spec.bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    chunk_cells = next(m for m in bench["end_to_end"]
                       if m["name"] == "fps")["workloads"]
    for name in NEW:
        m = entries[name]
        live = name.endswith(".live")
        assert m["workloads"] == (["scene.live"] if live else chunk_cells)
        assert m["moves"] == ("frame_p95_ms" if live else "fps")
    # one block, in their order
    names = [m["name"] for m in bench["per_layer"]]
    at = names.index(NEW[0])
    assert names[at:at + len(NEW)] == NEW


# ------------------------------ the program ---------------------------------


@pytest.fixture(scope="module")
def scene():
    return zoo.load("scene", (H, W, 3), zoo.default_pipeline_config("cpu"),
                    width=8)


class Counter:
    """A stand-in for the capturing graph's node count: every PyTorch
    function the scopes run adds a node."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        return self.n


class CountOps(torch.overrides.TorchFunctionMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.counter.n += 1
        return func(*args, **(kwargs or {}))


def _record(net, params, frames, **kw):
    counter = Counter()
    rec = layers.StageRecorder(counter)
    with layers.recording(rec), CountOps(counter):
        scan_video(net, params, frames, net.init_state(), **kw)
    assert layers._RECORDER is None and rec.open == []
    return rec.paths(counter.n)


def test_recorder_maps_every_layer_and_its_stages(scene):
    frames = torch.rand((2, H, W, 3), generator=torch.Generator()
                        .manual_seed(5))
    paths = _record(scene.net, scene.params, frames, thresholds=scene.taus,
                    refresh_start=True, out_map=lambda y: y.argmax(-1))
    seen = set(paths)
    layer_paths = [f"L{k}_{s.kind}" + (f"_{s.backend}" if s.backend else "")
                   for k, s in enumerate(scene.net.specs)]
    assert layer_paths[0] == "L0_conv_patch_stem"
    for lp in layer_paths:
        assert lp in {stages.layer_of(p) for p in seen}, lp
        assert f"refresh/{lp}" in {stages.layer_of(p) for p in seen}, lp
    stem, pool, conv = layer_paths[0], layer_paths[1], layer_paths[2]
    assert {f"{stem}/detect", f"{stem}/compact", f"{stem}/patch_conv",
            pool, f"{pool}/compact", f"{pool}/delta_kernel",
            f"{conv}/detect", f"{conv}/compact", f"{conv}/delta_kernel",
            "out_map", "stats"} <= seen
    # frame 0 runs apply_refresh: all its nodes lie under refresh, then
    # the frame's out map; frame 1 has none under refresh
    first_out = paths.index("out_map")
    assert all(p == "refresh" or p.startswith("refresh/")
               for p in paths[:first_out] if p != "")
    assert not any(p.startswith("refresh")
                   for p in paths[first_out:])
    assert not any(stages.stage_of(p) for p in paths
                   if p.startswith("refresh/"))


def test_recorder_paths_follow_the_marks():
    counter = Counter()
    rec = layers.StageRecorder(counter)
    with layers.recording(rec):
        counter.n = 2
        with layers.stage("L0_conv"):
            counter.n = 3
            with layers.stage("detect"):
                counter.n = 5
            counter.n = 6
        assert isinstance(layers.stage("x"), layers._RecordedScope)
    assert isinstance(layers.stage("x"), type(layers._NO_SCOPE))
    assert rec.paths(7) == ["", "", "L0_conv", "L0_conv/detect",
                            "L0_conv/detect", "L0_conv", ""]


def test_frame_stepper_calls_run_in_the_runner_span(scene):
    """A CPU profile of ``FrameStepper`` (one frame a call, then a chunk)
    and of ``scan_video_jit``: each call is one ``runner.call`` range, the
    layers' scopes, ``refresh``, ``out_map`` and ``stats`` inside it. The
    CPU runs no graph, so the replay's spans show on the card only."""
    stepper = FrameStepper(scene.net, scene.params, thresholds=scene.taus,
                           out_map=lambda y: y.argmax(-1),
                           collect_stats="packed")
    run = scan_video_jit(scene.net)
    frames = torch.rand((3, H, W, 3), generator=torch.Generator()
                        .manual_seed(6))
    state = scene.net.init_state()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stepper(frames[0])
        stepper(frames[1])
        stepper.step_chunk(frames[1:])
        run(scene.params, frames, state, thresholds=scene.taus,
            refresh_start=True)
    events = [e for e in prof.events() if e.name.startswith(
        ("runner.", "L", "refresh", "out_map", "stats"))]
    calls = [e for e in events if e.name == "runner.call"]
    assert len(calls) == 4
    names = {e.name for e in events}
    assert {"refresh", "out_map", "stats", "L0_conv_patch_stem",
            "L6_conv"} <= names
    for e in events:
        if e.name != "runner.call":
            assert any(c.time_range.start <= e.time_range.start
                       and e.time_range.end <= c.time_range.end
                       for c in calls), e.name
