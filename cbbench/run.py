"""Run one cell of the benchmark of ``cbinfer_tpu_torch`` once, on the card.

    python3 -m cbbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up loads the cell's configuration through ``zoo.load`` (weights and
taus pinned by sha256), makes a ring of frames on the card from the seed,
and warms every graph the window replays (a pass over the ring). The
window then drives the cell's entry for ``--seconds``: ``chunk`` cells
replay ``runner.scan_video_jit`` over the ring's chunks, at most the
cell's ``in_flight`` chunks in flight; ``live`` cells step
``runner.FrameStepper`` one frame a call and synchronise after each.
Once the window has closed and its state is freed, the judged pass runs
the program once more over the ring, through ``runner.FrameStepper`` (K =
1) with the cell's refresh cadence, and after each frame hands its stored
state to the layer-wise judgement (``layerwise.py``): every CB node's
decisions and values, from the program's own inputs and caches. The
judged pass's answers must equal the window's at the same ring positions,
bit for bit, and are judged against the reference's last layer computed
from the program's own input to it. Cells whose limits name
``worst_gap`` also keep the free-running check: the plain reference
(``reference.py``) runs one pass of its own over the ring and every
output of the window is judged against it.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` profiles
one pass over the ring after the window (``torch.profiler``, events read
in memory) and prints the per-layer metrics, each from its own reader in
``layer_metrics/``. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``; ``check`` last: each number compared beside
its limit, which standard error's last lines repeat). Without a CUDA card
it prints no result and exits 3.
"""

import time

T_START = time.time()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import guard, netdef, spec  # noqa: E402

# build and kernel caches inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(spec.ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(spec.ROOT, "build", "torch_extensions"))


def out_map_of(output: dict):
    """The deployment output form: the argmax class map (uint8), or each
    heat channel's flat argmax (the last ``keypoints`` channels)."""
    import torch
    if output["kind"] == "class_map":
        def class_map(y):
            return y.argmax(-1).to(torch.uint8)
        return class_map
    k = int(output["keypoints"])

    def heat_argmax(y):
        h, w, c = y.shape
        return y[..., c - k:].reshape(h * w, k).argmax(dim=0)
    return heat_argmax


def prepare(cell: dict, config: dict, device: str,
            overrides: Optional[dict] = None):
    """The program under test, loaded and checked, and the run's sizes."""
    import torch
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    o = dict(overrides or {})
    shape = tuple(o.get("in_shape", config["in_shape"]))
    wpath = spec.pinned(config["weights"])
    tpath = spec.pinned(config["taus"])
    taus = [float(t) for t in spec.load_json(tpath)["thresholds"]]
    cfg = PipelineConfig(
        tile=TileConfig(*config["tile"], config["capacity_fraction"]),
        backend="cuda", compute_dtype=config["compute_dtype"],
        cache_dtype=config["cache_dtype"], device=device)
    wl = zoo.load(config["zoo"], shape, cfg)
    nodes = netdef.nodes_of(config)
    n_cb = sum(1 for n in nodes if n["cb"])
    want_fuse = bool(config.get("fuse_detect", False))
    if (wl.weights != "trained(npz)" or wl.tau_source != "tuned"
            or wl.warnings or wl.fuse_detect != want_fuse
            or len(wl.taus) != n_cb or len(taus) != n_cb
            or any(abs(a - b) > 0 for a, b in zip(wl.taus, taus))):
        raise RuntimeError(
            f"zoo.load({config['zoo']!r}) is not the pinned configuration: "
            f"{wl.weights} {wl.tau_source} {wl.warnings} fuse "
            f"{wl.fuse_detect} taus {wl.taus}")
    check_net(wl, nodes)
    chunk = int(o.get("chunk", cell["chunk"]))
    ring = int(o.get("ring_frames", cell["ring_frames"]))
    refresh = int(o.get("refresh_every_frames",
                        config["refresh_every_frames"]))
    if ring % refresh or (cell["entry"] == "chunk"
                          and (refresh % chunk or ring % chunk)):
        raise ValueError("the ring must hold whole refresh intervals of "
                         "whole chunks")
    return types.SimpleNamespace(
        torch=torch, wl=wl, shape=shape, chunk=chunk, ring_frames=ring,
        refresh=refresh, out_map=out_map_of(config["output"]),
        weights_path=wpath, taus=taus, device=device)


def check_net(wl, nodes):
    """The loaded net is the configuration's: as many nodes (a chain's
    layers, a DAG's nodes by name and inputs), each of the kind, width and
    kernel stated, CB where it says so."""
    if wl.kind == "graph":
        got = [(n.name, list(n.inputs), n.spec) for n in wl.net.nodes]
    else:
        got = [(str(i), [str(i - 1) if i else "input"], s)
               for i, s in enumerate(wl.net.specs)]
    if len(got) != len(nodes):
        raise RuntimeError(f"the loaded net has {len(got)} nodes, the "
                           f"configuration {len(nodes)}")
    for (name, inputs, sp), n in zip(got, nodes):
        kernel = getattr(sp, "kernel", None) or getattr(sp, "window", None)
        want = (n["name"], n["inputs"], n["kind"], bool(n["cb"]))
        have = (name, inputs, sp.kind, bool(getattr(sp, "use_cb", False)))
        if n["kind"] == "conv":
            want += (n["features"], (n["kernel"],) * 2,
                     (n["dilation"],) * 2)
            have += (sp.features, tuple(kernel), tuple(sp.dilation))
        elif n["kind"] == "pool":
            want += ((n["window"],) * 2,)
            have += (tuple(kernel),)
        if want != have:
            raise RuntimeError(f"node {n['name']}: the loaded net has "
                               f"{have}, the configuration {want}")


class ChunkEntry:
    """``runner.scan_video_jit`` over the ring's chunks, a refresh prolog
    at each refresh interval's first chunk."""

    def __init__(self, prep, ring):
        from cbinfer_tpu_torch.runner import scan_video_jit
        self.p, self.ring = prep, ring
        self.run = scan_video_jit(prep.wl.net)
        self.state = prep.wl.net.init_state()
        self.n = prep.ring_frames // prep.chunk
        self.k = 0

    def frames_per_call(self) -> int:
        return self.p.chunk

    def call(self):
        """Enqueue the next chunk; returns (ring position, outputs)."""
        p, i = self.p, self.k % self.n
        self.k += 1
        y = self.run(p.wl.params, self.ring[i * p.chunk:(i + 1) * p.chunk],
                     self.state, thresholds=p.wl.taus,
                     refresh_start=(i * p.chunk) % p.refresh == 0,
                     collect_stats=False, out_map=p.out_map)[0]
        return i * p.chunk, y

    def at_ring_start(self) -> bool:
        return self.k % self.n == 0

    def calls_per_pass(self) -> int:
        return self.n

    def close(self):
        del self.run, self.state


class LiveEntry:
    """``runner.FrameStepper`` one frame a call (K = 1), refreshing every
    interval (its own schedule, aligned with the ring)."""

    def __init__(self, prep, ring):
        from cbinfer_tpu_torch.runner import FrameStepper
        self.p, self.ring = prep, ring
        self.stepper = FrameStepper(prep.wl.net, prep.wl.params,
                                    thresholds=prep.wl.taus,
                                    refresh_every=prep.refresh,
                                    out_map=prep.out_map)
        self.n = prep.ring_frames
        self.k = 0

    def frames_per_call(self) -> int:
        return 1

    def call(self):
        i = self.k % self.n
        self.k += 1
        y, _ = self.stepper(self.ring[i])
        return i, y[None]

    def at_ring_start(self) -> bool:
        return self.k % self.n == 0

    def calls_per_pass(self) -> int:
        return self.n

    def close(self):
        del self.stepper


def drive(entry, seconds: float, live: bool, dev, in_flight: int):
    """The measured window: calls for ``seconds`` of wall time. Chunk
    cells keep at most ``in_flight`` calls in flight; live cells
    synchronise after each call and time it. Returns the window's record
    (``waits``: per chunk call, how long the host waited for a slot)."""
    outs, host, lat, waits = [], [], [], []
    events: List = []
    gc.collect()
    gc.disable()  # no collector pause inside the window
    try:
        dev.sync()
        t0 = time.perf_counter()
        while True:
            w0 = time.perf_counter()
            if not live and len(events) >= in_flight:
                events[-in_flight].synchronize()
            h0 = time.perf_counter()
            waits.append(h0 - w0)
            pos, y = entry.call()
            h1 = time.perf_counter()
            host.append(h1 - h0)
            if live:
                dev.sync()
                lat.append(time.perf_counter() - h0)
            else:
                events.append(dev.event())
            outs.append((pos, y))
            if h1 - t0 >= seconds:
                break
        dev.sync()
        t1 = time.perf_counter()
    finally:
        gc.enable()
    frames = len(outs) * entry.frames_per_call()
    return types.SimpleNamespace(outs=outs, host=host, lat=lat,
                                 waits=waits, frames=frames, wall=t1 - t0)


def profile_pass(entry, live: bool, dev):
    """One pass over the ring from its start, under the profiler. Returns
    (outputs, device activities, host events, t0, t1, frames): the traced
    window [t0, t1] runs from the pass's first device activity to its
    last (the pass starts on an idle card, after a synchronise, so the
    lead-in before its first launch is the pass's start, not the
    program's)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import trace
    while not entry.at_ring_start():
        entry.call()
    dev.sync()
    outs = []
    acts = [ProfilerActivity.CPU]
    if dev.cuda:
        acts.append(ProfilerActivity.CUDA)
    gc.collect()
    gc.disable()
    try:
        with profile(activities=acts) as prof:
            with record_function(trace.MARK):
                for _ in range(entry.calls_per_pass()):
                    outs.append(entry.call())
                    if live:
                        dev.sync()
                dev.sync()
    finally:
        gc.enable()
    acts, host = trace.device_activities(prof)
    marks = [h for h in host if h[0] == trace.MARK]
    if not marks:
        raise RuntimeError("the profiler lost the slice's marker")
    acts = [a for a in acts if a.end > marks[0][1] and a.start < marks[0][2]]
    if acts:
        t0, t1 = acts[0].start, max(a.end for a in acts)
    else:  # no device activity (the CPU rehearsal): the host's range
        t0, t1 = marks[0][1], marks[0][2]
    host = [h for h in host if h[2] > t0 and h[1] < t1]
    frames = len(outs) * entry.frames_per_call()
    return outs, acts, host, t0, t1, frames


def reference_pass(prep, config: dict, ring, storage: str = "bfloat16"):
    """The plain reference over one pass of the ring: per frame the
    output the program's is judged against (class maps: (R, H, W, C)
    logits; heat argmaxes: (R, K, H*W) heat)."""
    import numpy as np
    torch = prep.torch
    from .reference import Reference
    weights = dict(np.load(prep.weights_path))
    ref = Reference(config, weights, prep.taus, prep.device, storage)
    outs = []
    with torch.no_grad():
        for t in range(prep.ring_frames):
            y = ref.step(ring[t], refresh=t % prep.refresh == 0)
            outs.append(as_judged(y, config["output"]))
    return torch.stack(outs)


def as_judged(y, output: dict):
    """A reference's (C, H, W) output in the form answers are judged
    against: (H, W, C) logits of a class map; (K, H*W) heat of a heat
    argmax."""
    if output["kind"] == "class_map":
        return y.permute(1, 2, 0).contiguous()
    k = int(output["keypoints"])
    return y[-k:].reshape(k, -1)


def answers_of(judged, output: dict):
    """The answers a judged-form output gives (the reference's own, as the
    control's): its argmax."""
    a = judged.argmax(-1)
    return a.to(sys.modules["torch"].uint8) \
        if output["kind"] == "class_map" else a


def judged_pass(prep, config: dict, ring, control: bool = False,
                count: bool = False):
    """The program once more over one pass of the ring, one frame a call
    through ``runner.FrameStepper`` with the cell's refresh cadence, each
    frame's stored state judged node by node (``layerwise.LayerJudge``)
    and its answer against the reference's last layer computed from the
    program's own input to it. Returns the pass's answers and, per frame,
    its largest ``layer_gap``, its pixels outside the decision rule and
    its widest ``answer_gap`` (with ``control``, the control's answers and
    its two gaps too), and the judge (with ``count``, its launch counts:
    from the changed pixels the decision check holds the program's to)."""
    import numpy as np
    from cbinfer_tpu_torch.runner import FrameStepper
    from .layerwise import LayerJudge
    torch = prep.torch
    judge = LayerJudge(config, dict(np.load(prep.weights_path)), prep.taus,
                       prep.shape, prep.device, control, count)
    stepper = FrameStepper(prep.wl.net, prep.wl.params,
                           thresholds=prep.wl.taus,
                           refresh_every=prep.refresh, out_map=prep.out_map)
    state = stepper.state
    nodes = [n for n in judge.nodes if n["cb"]]
    cached = [n["name"] for n in nodes
              if not (n["kind"] == "pool" and n["forward"])]

    def of(name):
        return state[int(name)] if isinstance(state, list) else state[name]
    answers, rows, cans = [], [], []
    with torch.no_grad():
        for t in range(prep.ring_frames):
            refresh = t % prep.refresh == 0
            before = {} if refresh else {k: of(k).in_cache.clone()
                                         for k in cached}
            y, _ = stepper(ring[t])
            stored = {n["name"]: (before.get(n["name"]),
                                  of(n["name"]).in_cache,
                                  of(n["name"]).out_cache) for n in nodes}
            ref, ctl, gap, wrong, cgap = judge.frame(ring[t], refresh,
                                                     stored)
            r = as_judged(ref, config["output"])[None]
            row = [gap, wrong, gaps(r, 0, y[None]).amax()]
            if control:
                a = answers_of(as_judged(ctl, config["output"]),
                               config["output"])
                row += [cgap, gaps(r, 0, a[None]).amax()]
                cans.append(a)
            answers.append(y)
            rows.append(torch.stack([v.double() for v in row]))
            del before, stored
    del stepper, state
    cols = torch.stack(rows).T
    out = types.SimpleNamespace(
        answers=torch.stack(answers), layer_gap=cols[0],
        decisions=cols[1].long(), answer_gap=cols[2], judge=judge)
    if control:
        out.control_layer_gap, out.control_answer_gap = cols[3], cols[4]
        out.control_answers = torch.stack(cans)
    return out


def mismatched(outs, answers):
    """How many of the window's answers differ, in any bit, from the
    judged pass's at the same ring position."""
    torch = sys.modules["torch"]
    n = torch.zeros((), dtype=torch.int64, device=answers.device)
    for pos, y in outs:
        a = answers[pos:pos + y.shape[0]]
        n += (y != a).reshape(y.shape[0], -1).any(1).sum()
    return int(n)


def gaps(ref_out, pos: int, y):
    """Per answer of one call, how far below the reference's best the
    program's answer lies: per pixel of a class map (the reference's best
    logit less its logit of the program's class), per keypoint of a heat
    argmax (the reference's peak less its heat at the program's place)."""
    torch = sys.modules["torch"]
    r = ref_out[pos:pos + y.shape[0]]
    return r.amax(-1) - torch.gather(r, -1, y.long()[..., None])[..., 0]


def _runs(outs, ring: int):
    """Consecutive calls' outputs joined into runs of ring positions (a
    live cell's single frames judged a pass at a time)."""
    torch = sys.modules["torch"]
    start, run, n = 0, [], 0
    for pos, y in outs:
        if run and (pos != start + n or n + y.shape[0] > ring):
            yield start, torch.cat(run)
            run, n = [], 0
        if not run:
            start = pos
        run.append(y)
        n += y.shape[0]
    if run:
        yield start, torch.cat(run)


def judge(ref_out, outs, limits: Dict[str, float]):
    """Every output of the window against the reference pass. Returns
    (the compared number beside its limit, the frames whose own widest
    gap exceeds it). ``worst_gap``: the widest gap over every answer."""
    torch = sys.modules["torch"]
    worst = torch.zeros((), device=ref_out.device)
    failed = torch.zeros((), dtype=torch.int64, device=ref_out.device)
    limit = limits["worst_gap"]
    for pos, y in _runs(outs, ref_out.shape[0]):
        g = gaps(ref_out, pos, y)
        per_frame = g.reshape(g.shape[0], -1).amax(1)
        worst = torch.maximum(worst, per_frame.max())
        failed += (per_frame > limit).sum()
    check = {"worst_gap": {"value": float(worst), "limit": limit}}
    return check, int(failed)


def verdict(jp, outs, limits: Dict[str, float], ref_out=None):
    """What decides ``correct``: the judged pass's numbers beside their
    limits, and (with ``ref_out``, cells whose limits name ``worst_gap``)
    the free-running check's. Returns (the numbers compared, each beside
    its limit; the frames that fail them: a judged frame over a limit or
    outside the decision rule, a window's answer that differs from the
    judged pass's, a frame over ``worst_gap``; whether the outputs are
    correct). The exact comparisons have the limit 0."""
    bad = (jp.layer_gap > limits["layer_gap"]) | (jp.decisions > 0)
    check = {"layer_gap": {"value": float(jp.layer_gap.max()),
                           "limit": limits["layer_gap"]}}
    if "answer_gap" in limits:
        bad |= jp.answer_gap > limits["answer_gap"]
        check["answer_gap"] = {"value": float(jp.answer_gap.max()),
                               "limit": limits["answer_gap"]}
    n_mis = mismatched(outs, jp.answers)
    check["decisions"] = {"value": int(jp.decisions.sum()), "limit": 0}
    check["mismatched"] = {"value": n_mis, "limit": 0}
    failed = int(bad.sum()) + n_mis
    if ref_out is not None:
        c, f = judge(ref_out, outs, limits)
        check, failed = {**c, **check}, failed + f
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in check.values())
    return check, failed, correct


def free(dev):
    gc.collect()
    if dev.cuda:
        dev.torch.cuda.empty_cache()


def card(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query>`` of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def window_notes(win, cuda: bool) -> str:
    """What the window's host did, and the card's clocks right after it:
    for telling a slow host from a slow card when runs spread."""
    calls = sorted(win.host)
    note = (f"host call p50 {calls[len(calls) // 2] * 1e3:.3f} ms, max "
            f"{calls[-1] * 1e3:.3f} ms")
    if win.waits and not win.lat:
        late = sum(1 for w in win.waits if w < 1e-4)
        note += (f"; waits for a free slot {sum(win.waits):.3f} s, calls "
                 f"that found one free {late}/{len(win.waits)}")
    if cuda:
        note += "; card after the window: " + card(
            "clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
            "clocks_event_reasons.active")
    return note


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             bench: Optional[dict] = None) -> dict:
    """One run of a cell: set-up, window, optional profiled pass,
    reference, judgement. Returns the result object (without printing)."""
    from . import frames
    bench = bench or spec.bench()
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    prep = prepare(cell, config, device, overrides)
    torch = prep.torch
    h, w = prep.shape[:2]
    ring = frames.make_ring(cell["video"], prep.ring_frames, seed, h, w,
                            device)
    live = cell["entry"] == "live"
    entry = (LiveEntry if live else ChunkEntry)(prep, ring)
    dev = Device(torch, device)
    cuda = dev.cuda
    # warm-up: every graph the window replays, then a whole pass, timed
    for _ in range(entry.calls_per_pass()):
        entry.call()
    dev.sync()
    t_pass = time.perf_counter()
    for _ in range(entry.calls_per_pass()):
        _, like = entry.call()
    dev.sync()
    t_pass = time.perf_counter() - t_pass
    if cuda:  # the window keeps every output for the judgement
        reserve(like, 1.5 * seconds / t_pass * entry.calls_per_pass())
    setup_s = time.time() - T_START
    win = drive(entry, seconds, live, dev, int(cell.get("in_flight", 1)))
    notes = window_notes(win, cuda)
    outs = win.outs
    ctx = types.SimpleNamespace(entry=cell["entry"], host_call_s=win.host,
                                slice=None, maps=None, ref_launches=None,
                                ref_flops=None)
    if traced:
        from . import stages
        p_outs, acts, host, t0, t1, n = profile_pass(entry, live, dev)
        outs = outs + p_outs
        ctx.slice = types.SimpleNamespace(acts=acts, host=host, t0=t0,
                                          t1=t1, frames=n)
        ctx.maps = stages.program_maps()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.close()
    del entry
    free(dev)
    t_judge = time.perf_counter()
    jp = judged_pass(prep, config, ring, count=traced)
    del prep.wl
    free(dev)
    t_ref = time.perf_counter()
    ref_out = (reference_pass(prep, config, ring)
               if "worst_gap" in cell["limits"] else None)
    check, failed, correct = verdict(jp, outs, cell["limits"], ref_out)
    print(f"cbbench: set-up {setup_s:.3f} s, window {win.wall:.3f} s, "
          f"judged pass {t_ref - t_judge:.3f} s, free-running reference "
          f"{time.perf_counter() - t_ref:.3f} s; {notes}", file=sys.stderr)
    print(f"cbbench: answer_gap {float(jp.answer_gap.max())!r}; by node "
          "[layer_gap, decisions]: " + json.dumps(jp.judge.by_node()),
          file=sys.stderr)
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": peak,
                   "card": card() if cuda else "cpu"}
    result = {"correct": correct,
              "attempted": sum(y.shape[0] for _, y in outs),
              "failed": failed}
    if not traced:
        values = {"setup_s": setup_s, "fps": win.frames / win.wall}
        if win.lat:
            lat = sorted(win.lat)
            values["frame_p95_ms"] = lat[min(len(lat) - 1,
                                             int(0.95 * len(lat)))] * 1e3
        for name, m in spec.metrics_of(bench, cell_name, "end_to_end"):
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        from . import trace
        ctx.ref_launches = jp.judge.counter.launches.host()
        ctx.ref_flops = float(jp.judge.counter.flops)
        for name, m in spec.metrics_of(bench, cell_name, "per_layer"):
            v = spec.reader(name)(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": m["unit"]}
        s = ctx.slice
        device_info["busy_s"] = trace.union(
            (max(a.start, s.t0), min(a.end, s.t1)) for a in s.acts)
        device_info["window_s"] = s.t1 - s.t0
        result["breakdown"] = {
            "device_ops": trace.top_ops(s.acts),
            "idle_gaps": trace.idle_gaps(s.acts, s.host, s.t0, s.t1)}
    result["metrics"] = metrics
    result["device"] = device_info
    result["check"] = check
    return result


def reserve(like, calls: float):
    """Grow the card's caching allocator by ``calls`` outputs like
    ``like`` and hand them back to it, so that keeping the window's
    outputs makes no ``cudaMalloc`` inside the window."""
    torch = sys.modules["torch"]
    blocks = [torch.empty_like(like) for _ in range(int(calls) + 1)]
    del blocks


class Device:
    """The run's device: a synchronise and a recorded event on the card;
    on the CPU rehearsal (the plain versions, nothing asynchronous)
    neither waits."""

    def __init__(self, torch, device: str):
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def event(self):
        ev = self.torch.cuda.Event() if self.cuda else _Done()
        ev.record()
        return ev


class _Done:
    def record(self):
        pass

    def synchronize(self):
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.bench()
    cell = spec.cell(args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cbbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    found = guard.forbidden_modules(sys.modules)
    if found:
        print(f"cbbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for k, c in result["check"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
