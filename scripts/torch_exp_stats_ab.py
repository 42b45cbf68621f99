#!/usr/bin/env python3
"""Same-process interleaved A/B of the timed scan's stats forms with the
PyTorch port (the twin of ``scripts/exp_stats_ab.py``).

    python3 scripts/torch_exp_stats_ab.py [scene] [--reps 5] [--chunks 6]
        [--t T] [--seed S] [--h 720] [--w 1280] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

The workload of ``zoo.load`` (trained weights, tuned taus, its policy)
through ``runner.scan_video_jit`` with ``collect_stats="mean"`` (the
stats the deployment keeps) against ``collect_stats=False``: each arm a
runner and a state of its own (``benchmark.ABArm``), timed over the SAME
device-resident chunks in interleaved reps, medians. A rep resets the
arm's state in place, runs chunk 0 as the refresh prolog (untimed), then
times the other chunks by CUDA events around their replays. The outputs
of the two arms are the same frames through the same kernels, so they
must be equal bit for bit (``outputs_identical``).

The reference's ingest arms (``mean+ingest``, ``none+ingest``: the flat4
clip staging, ``scan_video(ingest=True)``) have no port: the port's stem
reads the HWC frames themselves. The record keeps the reference's arm
names ``mean+classic`` and ``none+classic`` and says so.

Writes EXP_stats_ab.json's keys (``models`` by name; ``speedup_vs_shipped``
against ``mean+classic``, the port's shipped form; plus the device and the
card's name and power limit) to ``--out``, default
``chiprun_out/EXP_stats_ab_torch.json``; the reference's file is never
written. ``stats_ab`` is what ``chip_smoke.py``'s ``stats_ab`` phase
calls.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import ABArm, card  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

ARMS = {"mean+classic": "mean", "none+classic": False}
NOT_PORTED = ("mean+ingest", "none+ingest")


def out_form(name):
    """The deployment's output form: argmax to uint8 class maps, raw
    heatmaps for the pose models (the reference's ``out_u8``)."""
    if name.startswith("pose"):
        return None

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)
    return out_u8


def stats_ab(wl, name, H, W, T, reps=5, n_chunks=6, seed=None, log=print):
    """The model's section of the record (the module docstring's)."""
    dev = torch.device(wl.net.cfg.device)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, distinct_classes=name.startswith("pose"),
        seed=seed))
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    out_map = out_form(name)
    times = {k: [] for k in ARMS}
    outs = {}
    with torch.no_grad():
        arms = {k: ABArm(wl.net, wl.params, wl.taus, out_map, stats)
                for k, stats in ARMS.items()}
        for arm in arms.values():
            arm.warm(chunks)
        for r in range(reps):
            for k, arm in arms.items():
                ms, o = arm.rep(chunks)
                times[k].append(ms)
                outs[k] = [ys for ys, _ in o]
            log(f"rep{r} " + "  ".join(
                f"{k} {times[k][-1]:.2f} ms" for k in arms))
        graphs = {k: a.run.graphs.captures for k, a in arms.items()}
    identical = all(torch.equal(a, b) for a, b in
                    zip(outs["mean+classic"], outs["none+classic"]))
    frames = (n_chunks - 1) * T
    med = {k: float(np.median(v)) for k, v in times.items()}
    base = med["mean+classic"]
    return {
        "model": name, "reps": reps, "seed": seed, "T": T,
        "chunks": n_chunks,
        "ms_per_frame": {k: m / frames for k, m in med.items()},
        "speedup_vs_shipped": {k: base / m for k, m in med.items()},
        "all_s": {k: [t / 1e3 for t in v] for k, v in times.items()},
        "outputs_identical": identical, "graph_captures": graphs,
        "not_ported": {k: "flat4 ingest staging (scan_video(ingest=True))"
                          " is not ported: the port's stem reads the HWC "
                          "frames" for k in NOT_PORTED},
        "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="scene")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--t", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    T = args.t or (12 if args.model.startswith("pose") else 32)
    wl = zoo.load(args.model, (args.h, args.w, 3),
                  zoo.default_pipeline_config(args.device),
                  width=args.width_mult)
    row = stats_ab(wl, args.model, args.h, args.w, T, args.reps, args.chunks,
                   args.seed, log=lambda m: print(m, flush=True))
    print(json.dumps({k: row[k] for k in ("model", "ms_per_frame",
                                          "speedup_vs_shipped",
                                          "outputs_identical")}), flush=True)
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "EXP_stats_ab_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"experiment": __doc__.split("\n")[0] + " "
                   + __doc__.split("\n")[1].strip(),
                   "models": {args.model: row}}, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
