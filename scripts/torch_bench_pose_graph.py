#!/usr/bin/env python3
"""The pose DAG's headline row with the PyTorch port (the twin of
``scripts/bench_pose_graph.py``).

    python3 scripts/torch_bench_pose_graph.py [--sizes 360x640,720x1280]
        [--frames 12] [--chunks 2] [--tau T] [--seed S]
        [--device cuda|cpu] [--width-mult N] [--ckpt NPZ]
        [--tau-json PATH] [--out PATH]

``zoo.load("pose_graph")`` (the OpenPose DAG: trained weights, tuned
taus, its backend policy) at each size of ``--sizes`` (default the
reference's 360x640 and 720p): ``--chunks`` distinct clips of T frames
(at least the validated refresh cadence, ``zoo.load_refresh_cadence``)
after an untimed warm-up clip, CB through ``runner.scan_video_jit`` with
a refresh prolog on every cadence-th chunk and mean stats, dense as one
captured graph of the frame loop; each path timed in one pass over the
chunks by CUDA events around the replays. Per size: dense and CB fps,
their ratio, the effective-FLOP reduction over every timed chunk
(refresh frames included), PCK of CB against dense, and with trained
weights GT-PCK of both at alpha 0.05 and 0.02, and the overflow frames.
The clips come from ``--seed`` (default the clock, as the reference's).
Each row also names its weights and tau files and keeps the mean computed
tiles per CB node; ``--ckpt`` and ``--tau-json`` take another checkpoint
and tau file of the same architecture (an older one, to compare).

Writes ``{"rows": [...]}`` with the reference's ``pose_graph`` row keys
(plus the seed, the device and the card's name and power limit) to
``--out``, default ``chiprun_out/RESULTS_pose_graph_torch.json``; the
reference's ``RESULTS.json`` is never written. ``bench`` is what
``chip_smoke.py``'s ``pose_graph_bench`` phase calls.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import (card, concat_stats,  # noqa: E402
                                         device_ms, scalar_sync)
from cbinfer_tpu_torch.metrics import (_np, effective_flops_view,  # noqa: E402
                                       pck, pck_gt)
from cbinfer_tpu_torch.netview import NetView  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)


def bench(H=360, W=640, T=12, chunks=2, tau=None, seed=None,
          device="cuda", width=None, ckpt=None, tau_json=None, log=print):
    """One row at H x W (the module docstring's fields). ``ckpt`` and
    ``tau_json`` replace the shipped weights and tau file (an older
    checkpoint of the same architecture, say)."""
    dev = resolve_device(device)
    cfg = zoo.default_pipeline_config(device)
    entry = zoo.REGISTRY["pose_graph"]
    zoo.REGISTRY["pose_graph"] = dataclasses.replace(
        entry, npz=ckpt or entry.npz, tau_json=tau_json or entry.tau_json)
    try:
        wl = zoo.load("pose_graph", (H, W, 3), cfg, tau=tau, width=width)
    finally:
        zoo.REGISTRY["pose_graph"] = entry
    for msg in wl.warnings:
        log(f"pose_graph: WARNING {msg}")
    net, params = wl.net, wl.params
    cadence, cadence_src = zoo.load_refresh_cadence("pose_graph", T, H, W)
    chunks = max(chunks, cadence)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=3, sprite_size=32, speed=4.0,
        noise_std=0.002, distinct_classes=True, seed=seed,
        **workload_video_kwargs("pose_graph")))
    warm = torch.from_numpy(video.clip(T)).to(dev)
    clips, kps, valid = [], [], []
    for _ in range(chunks):
        f, k, v = video.clip_with_keypoints(T)
        clips.append(torch.from_numpy(f).to(dev))
        kps.append(k)
        valid.append(v)
    for c in clips + [warm]:
        scalar_sync(c)

    with torch.no_grad():
        dense = _Graphs(1)

        def dense_chunk(ch):
            return dense.run(("dense",), lambda fs: torch.stack(
                [net.apply_dense(params, f) for f in fs]), ch)

        scalar_sync(dense_chunk(warm))
        dense_outs = []
        dn_ms = device_ms(lambda: dense_outs.extend(
            dense_chunk(c) for c in clips), dev)

        run = scan_video_jit(net)
        state = net.init_state()
        kw = dict(thresholds=wl.taus, collect_stats="mean")
        scalar_sync(run(params, warm, state, refresh_start=True, **kw)[0])
        scalar_sync(run(params, warm, state, refresh_start=False, **kw)[0])
        cb = []
        cb_ms = device_ms(lambda: cb.extend(
            run(params, c, state, refresh_start=i % cadence == 0, **kw)
            for i, c in enumerate(clips)), dev)

    frames = chunks * T
    dense_fps, cb_fps = frames / (dn_ms / 1e3), frames / (cb_ms / 1e3)
    cb_np = np.concatenate([_np(ys) for ys, _, _ in cb])
    dn_np = np.concatenate([_np(d) for d in dense_outs])
    gt = {}
    if wl.weights == "trained(npz)":
        stride = zoo.output_stride(wl, H, W)
        k, v = np.concatenate(kps), np.concatenate(valid)
        p = {a: (pck_gt(dn_np, k, v, stride, alpha=a),
                 pck_gt(cb_np, k, v, stride, alpha=a)) for a in (0.05, 0.02)}
        gt = {"pck_gt_dense": p[0.05][0], "pck_gt_cb": p[0.05][1],
              "pck_degradation": p[0.05][0] - p[0.05][1],
              "pck02_gt_dense": p[0.02][0], "pck02_gt_cb": p[0.02][1],
              "pck02_degradation": p[0.02][0] - p[0.02][1]}
    stats = [s for _, _, s in cb]
    # mean-form overflow is a per-chunk share of frames: x T is the count
    overflows = int(round(sum(float(_np(s["overflow"])) * T
                              for cs in stats for s in cs.values() if s)))
    ef = effective_flops_view(NetView.from_nodes(wl.specs, (H, W, 3)),
                              concat_stats(stats), cfg.tile.tile_h,
                              cfg.tile.tile_w)
    computed = {n: float(np.mean([float(_np(cs[n]["computed_tiles"]))
                                  for cs in stats]))
                for n in stats[0] if stats[0][n]}
    row = {
        "model": "pose_graph", "resolution": f"{H}x{W}",
        "topology": "backbone -> 2 stages x {PAF, heatmap}, concat DAG",
        "weights": wl.weights, "tau": wl.tau_source,
        "refresh": (f"chunk-start prolog every {cadence} chunks, interval "
                    f"{cadence * T} ({cadence_src})"),
        "dense_fps": dense_fps, "cb_fps": cb_fps,
        "speedup": cb_fps / dense_fps,
        "flop_reduction": ef["flop_reduction"],
        "pck_vs_dense": float(pck(cb_np, dn_np)), **gt,
        "overflow_frames": overflows, "backend": cfg.backend,
        "backend_policy": wl.policy_source,
        "seed": seed, "frames_timed": frames, "device": str(dev),
        "weights_file": os.path.relpath(ckpt or entry.npz, REPO),
        "tau_file": os.path.relpath(tau_json or entry.tau_json, REPO),
        "computed_tiles_per_layer": computed,
        **({"card": card()} if dev.type == "cuda" else {}),
    }
    log(json.dumps(row))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="360x640,720x1280")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--tau", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--ckpt", default=None,
                    help="weights npz instead of the shipped one")
    ap.add_argument("--tau-json", default=None,
                    help="tau file instead of the shipped one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for size in args.sizes.split(","):
        H, W = (int(x) for x in size.split("x"))
        rows.append(bench(H, W, args.frames, args.chunks, args.tau,
                          args.seed, args.device, args.width_mult,
                          args.ckpt, args.tau_json,
                          log=lambda m: print(m, flush=True)))
        if rows[-1]["device"] != "cpu":
            torch.cuda.empty_cache()
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "RESULTS_pose_graph_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"rows": rows}, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
