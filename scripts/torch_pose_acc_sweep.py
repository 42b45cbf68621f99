#!/usr/bin/env python3
"""GT-PCK degradation over seeds, tau vectors and refresh cadences with the
PyTorch port (the twin of ``scripts/pose_acc_sweep.py``).

    python3 scripts/torch_pose_acc_sweep.py [--seeds 4]
        [--taus tuned,flat0.04,flat0.02] [--cadences 2,1] [--t 12]
        [--chunks 4] [--h 720] [--w 1280] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

The pose workload (``zoo.load``: trained weights, tuned taus; bf16 and
the kernel path on the card, as the reference ran its TPU; float32 and
the plain versions on the CPU) on the reference's protocol: per seed
(1000 + 77 s) a video of 4 sprites with keypoints, ``--chunks`` clips of
T frames, the dense network's GT-PCK per chunk; then per tau vector
(``tuned``, ``flat0.04``, ``flat0.02``) and refresh cadence (a refresh
prolog on every Nth chunk) the CB stream from a fresh state through
``runner.scan_video_jit`` (the state reset in place; the taus are run-
time values, so one graph serves every vector): GT-PCK per chunk, PCK
against dense, the mean and worst-chunk degradation. Accuracy only: no
timing.

Writes POSE_ACC.json's keys (plus the device and the card's name and
power limit) to ``--out``, default ``chiprun_out/POSE_ACC_torch.json``;
the reference's file is never written. ``sweep`` is what
``scripts/torch_graph_acc_sweep.py`` and ``chip_smoke.py``'s ``sweeps``
phase call.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card  # noqa: E402
from cbinfer_tpu_torch.metrics import _np, pck, pck_gt  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import (_Graphs, _tensors,  # noqa: E402
                                      scan_video_jit)
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

# the reference's video of each model's sweep, and its seed base
VIDEO = {"pose": dict(n_sprites=4, sprite_size=48, seed_base=1000),
         "pose_graph": dict(n_sprites=3, sprite_size=32, seed_base=2000)}
TAU_NAMES = ("tuned", "flat0.04", "flat0.02")


def tau_vectors(wl, names=TAU_NAMES):
    n = len(wl.taus)
    return {k: (list(wl.taus) if k == "tuned"
                else [float(k[len("flat"):])] * n) for k in names}


def sweep(wl, H=720, W=1280, T=12, chunks=4, n_seeds=4, taus=TAU_NAMES,
          cadences=(2, 1), log=print):
    """The record's rows for the loaded pose workload ``wl`` (its params'
    device runs everything)."""
    net, params = wl.net, wl.params
    dev = _tensors(params)[0].device
    stride = zoo.output_stride(wl, H, W)
    v = VIDEO[wl.name]
    run = scan_video_jit(net)
    dense = _Graphs(1)
    state = net.init_state()
    fresh = [t.clone() for t in _tensors(state)]
    rows = []
    with torch.no_grad():
        for s in range(n_seeds):
            seed = v["seed_base"] + 77 * s
            video = SpriteVideo(SpriteVideoConfig(
                height=H, width=W, n_sprites=v["n_sprites"],
                sprite_size=v["sprite_size"], speed=4.0, noise_std=0.002,
                distinct_classes=True, seed=seed))
            clips, kps, valids = [], [], []
            for _ in range(chunks):
                f, k, vv = video.clip_with_keypoints(T)
                clips.append(torch.from_numpy(f).to(dev))
                kps.append(k)
                valids.append(vv)
            dense_outs = [_np(dense.run(("dense",), lambda fs: torch.stack(
                [net.apply_dense(params, f) for f in fs]), c))
                for c in clips]
            d_pck = [pck_gt(d, k, vv, stride)
                     for d, k, vv in zip(dense_outs, kps, valids)]
            for name, tv in tau_vectors(wl, taus).items():
                for cad in cadences:
                    for dst, src in zip(_tensors(state), fresh):
                        dst.copy_(src)
                    per_chunk, agree = [], []
                    for i, c in enumerate(clips):
                        ys = run(params, c, state, thresholds=tv,
                                 refresh_start=i % cad == 0,
                                 collect_stats=False)[0]
                        y = _np(ys)
                        per_chunk.append(pck_gt(y, kps[i], valids[i],
                                                stride))
                        agree.append(pck(y, dense_outs[i]))
                    row = {
                        "seed": seed, "taus": name, "cadence": cad,
                        "pck_gt_dense": d_pck, "pck_gt_cb": per_chunk,
                        "agreement": agree,
                        "degradation_mean": float(np.mean(d_pck)
                                                  - np.mean(per_chunk)),
                        "degradation_worst_chunk": float(max(
                            d - c for d, c in zip(d_pck, per_chunk))),
                    }
                    rows.append(row)
                    log(json.dumps(row))
    return rows


def run_sweep(model, argv, default_t):
    """The command line of this script and of its DAG twin."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--taus", default=",".join(TAU_NAMES))
    ap.add_argument("--cadences", default="2,1")
    ap.add_argument("--t", type=int, default=default_t)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    wl = zoo.load(model, (args.h, args.w, 3),
                  zoo.default_pipeline_config(args.device),
                  width=args.width_mult)
    rows = sweep(wl, args.h, args.w, args.t, args.chunks, args.seeds,
                 args.taus.split(","),
                 [int(c) for c in args.cadences.split(",")],
                 log=lambda m: print(m, flush=True))
    rec = {"H": args.h, "W": args.w, "T": args.t, "chunks": args.chunks,
           "rows": rows, "weights": wl.weights, "device": str(dev),
           **({"card": card()} if dev.type == "cuda" else {})}
    name = "POSE_ACC" if model == "pose" else "GRAPH_ACC"
    out = args.out or os.path.join(REPO, "chiprun_out", f"{name}_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return rec


def main(argv=None):
    run_sweep("pose", argv, 12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
