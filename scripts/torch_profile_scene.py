#!/usr/bin/env python3
"""Where the time goes: torch.profiler over the port's 720p paths.

    python3 scripts/torch_profile_scene.py [flagship|dense_stem|hintless|
                                            pose|pose_unfused|pose_fwd|
                                            seg|pose_graph|band_stem|
                                            flat_stem|torch_f32|torch_bf16]
                                           [--frames 32] [--graph]
                                           [--pan DY DX]

Builds one of chip_smoke.py's paths, trained weights and tuned taus through
zoo.load, bf16. Of the scene network (w128): ``flagship`` (the sparse
patch_stem stem, the default), ``dense_stem`` (the stem overridden to
dense_cached) or ``hintless`` (the plain converter with a dense stem). Of
the pose network (w64, on the pose profile's graded-dynamics video, the
18 heat-channel argmaxes as output): ``pose`` (zoo.load("pose"), 13 conv
pairs on the fused conv + consumer detect), ``pose_unfused`` (the same
without the fusion) or ``pose_fwd`` (layers 15, 16 and 20 forwarding their
producer's hint). ``seg`` (zoo.load("seg"), w64, on the seg profile's
video, the full-resolution uint8 class map as output: argmax, then the
nearest x4 of the stripped upsample) and ``pose_graph`` (zoo.load(
"pose_graph"), the OpenPose DAG, the 18 heat argmaxes) are the two other
workloads. ``band_stem`` and ``flat_stem`` are the scene flagship with the
stem on ``band_cached`` or ``dense_cached_flat``; ``torch_f32`` and
``torch_bf16`` the scene net on the capacity-bounded plain backend
(``"torch"``, no kernel) in float32 or bf16 (``chip_smoke.py``'s
``backends`` phase's forms). The clip is seeded with the constant SEED, so two source
trees are profiled on the same frames. It warms up, then profiles one chunk of CB frames (no refresh frame) and
the same frames through the dense path. Prints one JSON line per path: wall ms per frame (CUDA events),
the host thread's CPU ms per frame while enqueuing,
device-busy ms per frame (union of kernel intervals), the device's idle
share, the top kernels by device time per frame, and the device time and
launches per frame of each of the port's own kernels. ``--graph`` runs
the CB frames through ``runner.scan_video_jit`` instead: the profiled chunk
is one replay of a captured CUDA graph of the same frame loop (warmed by the
key's eager first call and one replay). ``--pan DY DX`` scrolls the
background by (DY, DX) pixels a frame under the sprites, as the change-rate
sweep's pan points do (``chip_smoke.py``'s ``changerate`` phase: pan_slow
1 2, pan_fast 4 8). Needs a CUDA GPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.convert import (convert, convert_flagship,  # noqa: E402
                                       num_cb_layers)
from cbinfer_tpu_torch.metrics import heat_argmax  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import KERNELS  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,  # noqa
                                     workload_video_kwargs)

H, W = 720, 1280
# of the profiled clip: fixed, so that two source trees (or two runs) are
# profiled on the same frames and their device time compares
SEED = 1


def port_kernel(fn_name):
    """The registry's kernel (``KERNELS``) that a CUDA kernel function
    belongs to: its source is ``<stem>.cu`` and its functions are named
    ``<stem>[_variant]_kernel``; the longest such stem, or None."""
    if not fn_name.endswith("_kernel"):
        return None
    stems = {os.path.splitext(os.path.basename(k.source))[0]: k.name
             for k in KERNELS}
    hits = [st for st in stems if fn_name.startswith(st)]
    return stems[max(hits, key=len)] if hits else None


def kernel_table(prof, n_frames, top):
    """Device-busy ms per frame (union of kernel intervals), device
    activities (kernels, copies, fills) per frame, the top kernels, and
    the port's own kernels."""
    # a record_function range (the layers' stage scopes) also shows on the
    # device's timeline, spanning its kernels: not an activity of its own
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the port's own kernels, by registry name, however far down they rank
    own = {}
    for k, (t, c) in rows:
        words = k.split("<")[0].rsplit("::", 1)[-1].split("(")[0].split()
        name = port_kernel(words[-1]) if words else None
        if name:
            d = own.setdefault(name, [0.0, 0])
            d[0] += t / 1e3 / n_frames
            d[1] += c / n_frames
    return busy / 1e3 / n_frames, len(kern) / n_frames, [
        {"kernel": k[:90], "ms_per_frame": v[0] / 1e3 / n_frames,
         "calls_per_frame": v[1] / n_frames} for k, v in rows[:top]], {
        k: {"ms_per_frame": t, "calls_per_frame": c}
        for k, (t, c) in own.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="flagship",
                    choices=("flagship", "dense_stem", "hintless", "pose",
                             "pose_unfused", "pose_fwd", "seg",
                             "pose_graph", "band_stem", "flat_stem",
                             "torch_f32", "torch_bf16"))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--graph", action="store_true",
                    help="CB frames as CUDA graph replays (scan_video_jit)")
    ap.add_argument("--pan", type=float, nargs=2, default=(0.0, 0.0),
                    metavar=("DY", "DX"),
                    help="camera pan, pixels a frame (default: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    is_pose = args.path.startswith("pose")
    workload = (args.path if args.path in ("seg", "pose_graph")
                else "pose" if is_pose else "scene")
    cfg = None
    if args.path.startswith("torch_"):
        dt = "float32" if args.path == "torch_f32" else "bfloat16"
        cfg = dataclasses.replace(zoo.default_pipeline_config(),
                                  backend="torch", compute_dtype=dt,
                                  cache_dtype=dt)
    wl = zoo.load(workload, (H, W, 3), cfg,
                  apply_policy=args.path != "pose_unfused")
    if wl.weights != "trained(npz)" or wl.tau_source != "tuned" \
            or wl.warnings:
        # zoo.load carries on with random weights or flat taus and only
        # records it: a profile of such a net is not the flagship's
        print(f"zoo.load: {wl.weights} {wl.tau_source} {wl.warnings}",
              file=sys.stderr)
        return 1
    net, params, taus = wl.net, wl.params, wl.taus
    stems = {"dense_stem": "dense_cached", "band_stem": "band_cached",
             "flat_stem": "dense_cached_flat"}
    if args.path in stems:
        net = convert_flagship(wl.specs, (H, W, 3), net.cfg,
                               extra_overrides={0: stems[args.path]})
    elif args.path == "hintless":
        net = convert(wl.specs, (H, W, 3), net.cfg,
                      dense_layers=(0, len(wl.specs) - 1))
        taus = [taus[0]] * num_cb_layers(net.specs)
    elif args.path == "pose_fwd":
        net = convert_flagship(
            wl.specs, (H, W, 3), net.cfg, fuse_detect=True,
            extra_overrides={k: "forward_hint" for k in (15, 16, 20)})
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=SEED, pan=tuple(args.pan),
        distinct_classes=is_pose,
        **workload_video_kwargs(workload)))
    warm, clip_t, clip_p = (torch.from_numpy(video.clip(args.frames)).cuda()
                            for _ in range(3))

    def out_u8(y):
        if is_pose:
            return heat_argmax(y)
        ids = y.argmax(-1).to(torch.uint8)
        if wl.upsample_scale is None:
            return ids
        sh, sw = wl.upsample_scale
        return ids.repeat_interleave(sh, 0).repeat_interleave(sw, 1)

    run = scan_video
    if args.graph:
        # imported here: a source tree from before the graph runner still
        # profiles its eager loop with this script
        from cbinfer_tpu_torch.runner import scan_video_jit
        jit = scan_video_jit(net)

        def run(net_, params_, ch, state, **kw):
            return jit(params_, ch, state, **kw)

    def cb(ch, state, refresh=False):
        return run(net, params, ch, state, collect_stats=False,
                   thresholds=taus, refresh_start=refresh,
                   out_map=out_u8)[1]

    def dense(ch):
        return torch.stack([out_u8(net.apply_dense(params, f)) for f in ch])

    state = cb(warm, net.init_state(), refresh=True)
    state = cb(warm, state)
    state = cb(warm, state)  # with --graph: the steady graph's first replay
    dense(warm)
    torch.cuda.synchronize()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    for name, fn in (("cb", lambda ch: cb(ch, state)), ("dense", dense)):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        c0 = time.thread_time()
        e0.record()
        fn(clip_t)  # unprofiled: the profiler slows the host side
        e1.record()
        host = (time.thread_time() - c0) * 1e3 / args.frames
        torch.cuda.synchronize()
        plain_wall = e0.elapsed_time(e1) / args.frames
        with torch.profiler.profile(activities=acts) as prof:
            e0.record()
            fn(clip_p)
            e1.record()
            torch.cuda.synchronize()
        wall = e0.elapsed_time(e1) / args.frames
        busy, n_kern, top, own = kernel_table(prof, args.frames, args.top)
        if name == "cb" and args.graph:
            name = "cb_graph"
        print(json.dumps({"path": name, "net": args.path, "seed": SEED,
                          "pan": list(args.pan),
                          "card": smi,
                          "frames": args.frames,
                          "wall_ms_per_frame": plain_wall,
                          "host_cpu_ms_per_frame": host,
                          "profiled_wall_ms_per_frame": wall,
                          "device_busy_ms_per_frame": busy,
                          "device_activities_per_frame": n_kern,
                          "idle_share_profiled": 1.0 - busy / wall,
                          "top": top, "port_kernels": own}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
