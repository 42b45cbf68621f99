#!/usr/bin/env python3
"""Per-stage device time per frame from a ``torch.profiler`` trace of the
PyTorch port (the twin of ``scripts/profile_trace.py``).

    python3 scripts/torch_profile_trace.py [scene seg pose pose_graph]
        [--h 720] [--w 1280] [--t T] [--stats stack|mean|none]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

Each model as the reference builds it (the flagship specs, trained
weights and tuned taus through ``zoo.load`` without a backend policy;
``pose_graph`` with its policy, as ``zoo.load`` gives it), argmax to
uint8 maps except for the pose models' heatmaps, on the reference's clip
(seed 33; T = 12 for the pose models, 24 otherwise). After a warm chunk
(the eager first call and the capture of ``runner.scan_video_jit``'s
graph, then a replay), two rows of the same frames from the same state:

  graphed  one replay of the captured graph under the profiler; the
           device's activities classified by kernel name: the port's own
           kernels by their registry name (``KERNEL_STAGE``; the kernel
           functions are named after their source file, as
           ``torch_profile_scene.port_kernel`` reads them), the radix
           sorts (``torch.sort``'s, cub's) as ``compact``, everything
           else as ``glue``
  eager    the same chunk through the eager frame loop
           (``runner.scan_video``) under the profiler; the port's kernels
           by name as above, every other device activity by the innermost
           stage scope (``layers.stage``: the reference's
           ``jax.named_scope`` names, ``SCOPE_STAGE``) around the host
           call that launched it (by the launch's correlation id), else
           ``glue``

Stage times are SELF times (``self_times``, the reference's flame-graph
rule: nested children subtracted per track), so the stage sums are
additive; each row also reports the device's busy time (the union of the
intervals) and the ratio of the two, which the smoke holds within 2%. On
the CPU the host thread's operators take the place of the device's
activities (the plain versions; the flow only).

Writes PROFILE.json's ``stages`` section (``<model>`` the graphed row,
``<model>_eager`` the eager one; plus the device and the card's name and
power limit) to ``--out``, default ``chiprun_out/PROFILE_trace_torch.json``;
the reference's file is never written. ``trace`` is what
``chip_smoke.py``'s ``profile_trace`` phase calls.
"""

import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import KERNELS  # noqa: E402
from cbinfer_tpu_torch.runner import (_tensors, scan_video,  # noqa: E402
                                      scan_video_jit)
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

# the port's kernels by registry name -> the reference's stage names
KERNEL_STAGE = {
    "detect_sparse": "detect", "detect_full": "detect",
    "stem_detect": "detect", "accept_tiles": "detect",
    "delta_conv": "delta_conv", "delta_conv_detect": "delta_conv",
    "stem_conv": "delta_conv", "delta_pool": "delta_pool",
    "detect_pool_fused": "fused_pool",
    "tma_window_write": "glue", "tma_window_read": "glue",
}
# the stage scopes of layers.py -> stages, as the reference's scope table
# (scripts/profile_trace.py:286-294) bins its named scopes
SCOPE_STAGE = {
    "detect": "detect", "accept_hinted": "detect", "compact": "compact",
    "delta_kernel": "delta_conv", "patch_conv": "delta_conv",
    "band_conv": "band_conv", "cached_conv": "cached_conv",
    "out_pad": "cached_conv",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def self_times(evs):
    """(name, self_dur) of ``(name, ts, dur, pid, tid)`` events with nested
    children subtracted, per (pid, tid) track (the reference's
    ``self_times``, ``scripts/profile_trace.py:100-134``): sorted by
    (ts, -dur), each event's directly nested children are subtracted from
    its own duration, so sum(self) == sum(top-level durations)."""
    tracks = defaultdict(list)
    for nm, ts, dur, pid, tid in evs:
        tracks[(pid, tid)].append((ts, dur, nm))
    out = []

    def finish(fin, stack):
        end, dur, nm, child = fin
        out.append((nm, max(0.0, dur - child)))
        if stack:
            stack[-1][3] += dur

    for tr in tracks.values():
        tr.sort(key=lambda e: (e[0], -e[1]))
        stack = []  # [end, dur, name, child_dur_sum]
        for ts, dur, nm in tr:
            while stack and ts >= stack[-1][0] - 1e-6:
                finish(stack.pop(), stack)
            stack.append([ts + dur, dur, nm, 0.0])
        while stack:
            finish(stack.pop(), stack)
    return out


def port_kernel(fn_name):
    """The registry's kernel that a CUDA kernel function belongs to: its
    source is ``<stem>.cu`` and its functions are ``<stem>[_variant]_kernel``
    (the longest such stem), or None."""
    words = fn_name.split("<")[0].rsplit("::", 1)[-1].split("(")[0].split()
    fn = words[-1] if words else ""
    if not fn.endswith("_kernel"):
        return None
    stems = {os.path.splitext(os.path.basename(k.source))[0]: k.name
             for k in KERNELS}
    hits = [st for st in stems if fn.startswith(st)]
    if not hits:
        return None
    name = stems[max(hits, key=len)]
    if name.startswith("tma_window"):  # one source, two kernels
        name = "tma_window_read" if "read" in fn else "tma_window_write"
    return name


def kernel_stage(name):
    """A device activity's stage by its name alone (the graphed row), or
    None where the name does not decide it."""
    k = port_kernel(name)
    if k is not None:
        return KERNEL_STAGE[k]
    if "radixsort" in name.lower().replace("_", ""):
        return "compact"
    return None


def _union(spans):
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class _Scopes:
    """The stage scopes of one track, to find the innermost one around a
    time stamp: the latest-starting scope that still holds it."""

    def __init__(self, spans):
        self.spans = sorted(spans)  # (ts, end, name)
        self.starts = [s[0] for s in self.spans]
        self.longest = max((e - s for s, e, _ in self.spans), default=0.0)

    def innermost(self, ts):
        i = bisect.bisect_right(self.starts, ts)
        while i > 0 and self.spans[i - 1][0] >= ts - self.longest:
            i -= 1
            s, e, nm = self.spans[i]
            if e >= ts:
                return nm
        return None


def read_trace(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def stage_rows(events, frames, by_scope, on_device):
    """Per-frame stage self times (us), top activities, busy time and the
    attribution counts of one trace."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if on_device:
        acts = [e for e in xs if e.get("cat") in DEVICE_CATS]
    else:  # the host's operators on the thread that ran the frames
        ops = [e for e in xs if e.get("cat") == "cpu_op"]
        tid = max({e["tid"] for e in ops},
                  key=lambda t: sum(e["dur"] for e in ops if e["tid"] == t))
        acts = [e for e in ops if e["tid"] == tid]
    scopes = defaultdict(list)
    for e in xs:
        if e.get("name") in SCOPE_STAGE and e.get("cat") == "user_annotation":
            scopes[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    host = {k: _Scopes(v) for k, v in scopes.items()}
    launch = {e["args"]["correlation"]: e for e in xs
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    how = defaultdict(int)

    def stage_of(e):
        st = kernel_stage(e["name"]) if on_device else None
        if st is not None:
            how["by_name"] += 1
            return st
        if not by_scope:
            how["glue"] += 1
            return "glue"
        # a device activity by the host call that launched it
        at = launch.get(e.get("args", {}).get("correlation")) \
            if on_device else e
        sc = host.get((at["pid"], at["tid"])) if at else None
        nm = sc.innermost(at["ts"]) if sc else None
        how["by_launch" if nm else "glue"] += 1
        return SCOPE_STAGE[nm] if nm else "glue"

    keyed = [(f"{i}\x00{e['name']}", e["ts"], e["dur"], e["pid"], e["tid"])
             for i, e in enumerate(acts)]
    stage_by_key = {k[0]: stage_of(e) for k, e in zip(keyed, acts)}
    by_stage, by_name = defaultdict(float), defaultdict(float)
    for key, dur in self_times(keyed):
        by_stage[stage_by_key[key]] += dur
        by_name[key.split("\x00", 1)[1]] += dur
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in acts])
    total = sum(by_stage.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "per_frame_us": {k: v / frames for k, v in sorted(by_stage.items())},
        "top_ops_us_per_frame": [[nm[:120], d / frames, kernel_stage(nm)
                                  or ""] for nm, d in top],
        "busy_us_per_frame": busy / frames,
        "stage_sum_us_per_frame": total / frames,
        "stage_sum_over_busy": total / busy if busy else None,
        "activities_per_frame": len(acts) / frames,
        "attributed": dict(how),
    }


def _profile(fn, on_device, tmp):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_device:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if on_device:
            torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    return read_trace(path)


def trace(name, H=720, W=1280, T=None, stats="stack", device="cuda",
          width=None, log=print):
    """``{name: graphed row, name + "_eager": eager row}``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    T = T or (12 if name.startswith("pose") else 24)
    wl = zoo.load(name, (H, W, 3), zoo.default_pipeline_config(device),
                  apply_policy=name == "pose_graph", width=width)
    for msg in wl.warnings:
        log(f"{name}: WARNING {msg}")
    net, params, taus = wl.net, wl.params, wl.taus
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=max(24, H // 15),
        speed=4.0, noise_std=0.002, seed=33))
    warm = torch.from_numpy(video.clip(T)).to(dev)
    clip = torch.from_numpy(video.clip(T)).to(dev)
    out_map = None
    if not name.startswith("pose"):
        def out_map(y):
            return y.argmax(-1).to(torch.uint8)
    collect = {"stack": True, "mean": "mean", "none": False}[stats]
    kw = dict(thresholds=taus, collect_stats=collect, out_map=out_map)
    run = scan_video_jit(net)
    state = net.init_state()
    rows = {}
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        run(params, warm, state, **kw)  # eager first call + capture
        run(params, warm, state, **kw)
        saved = [t.clone() for t in _tensors(state)]
        forms = (("", lambda: run(params, clip, state, **kw), False),
                 ("_eager", lambda: scan_video(net, params, clip, state,
                                               **kw), True))
        for suffix, fn, by_scope in forms:
            for t, s in zip(_tensors(state), saved):
                t.copy_(s)
            if cuda:
                torch.cuda.synchronize()
            events = _profile(fn, cuda, tmp)
            row = stage_rows(events, T, by_scope, cuda)
            rows[name + suffix] = {
                "shape": [H, W], "frames": T, "tau_source": wl.tau_source,
                "weights": wl.weights, "stats": stats,
                "form": "eager" if suffix else "graphed", **row,
                "note": ("device-activity SELF times per frame (nested "
                         "children subtracted), classified by the port's "
                         "kernel names" + (" and, for the rest, by the "
                                           "innermost stage scope around "
                                           "the launch" if suffix else
                                           "; radix sorts as compact, "
                                           "the rest glue"))}
            log(f"{name + suffix}: " + json.dumps(
                {k: round(v, 2) for k, v in row["per_frame_us"].items()})
                + f" busy {row['busy_us_per_frame']:.1f} us/frame, sum/busy "
                f"{row['stage_sum_over_busy']}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("models", nargs="*",
                    default=["scene", "seg", "pose", "pose_graph"])
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=None)
    ap.add_argument("--stats", choices=("stack", "mean", "none"),
                    default="stack")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    stages = {}
    for name in args.models:
        stages.update(trace(name, args.h, args.w, args.t, args.stats,
                            args.device, args.width_mult,
                            log=lambda m: print(m, flush=True)))
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    rec = {"stages": stages, "device": args.device,
           **({"card": card()} if args.device == "cuda" else {})}
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "PROFILE_trace_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
