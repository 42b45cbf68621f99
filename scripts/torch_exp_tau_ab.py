#!/usr/bin/env python3
"""Controlled tau A/B with the PyTorch port (the twin of
``scripts/exp_tau_ab.py``).

    python3 scripts/torch_exp_tau_ab.py [scene] [--t 32] [--reps 3]
        [--chunks 4] [--h 720] [--w 1280] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

The workload of ``zoo.load`` (trained weights, its policy) under the tuned
tau vector and the flat vectors 0.07, 0.045, 0.02 and 0.01. Thresholds are
runtime values in the port's graphs (``runner.scan_video_jit`` writes them
into a device vector before each replay), so ONE captured graph runs every
vector: the timed form (no stats) and the stats form are one graph each,
and the record counts the captures. The state is one set of tensors,
reset in place from a pristine copy before each pass (a new state would
be new addresses, so a new graph).

Per vector, untimed: the cold-start chunk, then a stats chunk whose
per-layer mean changed tiles are recorded. Timed: ``--reps`` passes per
vector in a rotating order (no vector always runs first after anything),
each the cold-start chunk untimed, then the other ``--chunks`` - 1 chunks
timed by CUDA events around their replays (``benchmark.device_ms``;
chunks made on the device beforehand); best of the reps.

Writes EXP_tau_ab.json's keys (plus the captures, the device and the
card's name and power limit) to ``--out``, default
``chiprun_out/EXP_tau_ab_torch.json``; the reference's file is never
written. ``tau_ab`` is what ``chip_smoke.py``'s ``tau_ab`` phase calls.
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
from cbinfer_tpu_torch.benchmark import card, device_ms  # noqa: E402
from cbinfer_tpu_torch.metrics import _np  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _tensors, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

FLAT = (0.07, 0.045, 0.02, 0.01)


def mean_changed_tiles(stats):
    """Per CB layer (keyed by its index, as the reference's record) the
    mean changed tiles of a stacked-stats chunk; layers without counters
    (dense ones) are skipped."""
    return {str(k): float(np.mean(_np(v["changed_tiles"]).astype(np.float64)))
            for k, v in enumerate(stats) if v and "changed_tiles" in v}


def tau_ab(wl, name, H, W, T=32, reps=3, n_chunks=4, log=print):
    """The record (the module docstring's) for one loaded workload."""
    net, params = wl.net, wl.params
    dev = _tensors(params)[0].device
    n = len(wl.taus)
    vectors = {"tuned": [float(t) for t in wl.taus]}
    for t in FLAT:
        vectors[f"flat{t}"] = [t] * n
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=5, distinct_classes=name.startswith("pose"),
        **workload_video_kwargs(name)))
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    run = scan_video_jit(net)
    state = net.init_state()
    pristine = [t.clone() for t in _tensors(state)]

    def reset():
        for dst, src in zip(_tensors(state), pristine):
            dst.copy_(src)

    def chunk(ch, tv, stats=False):
        return run(params, ch, state, thresholds=tv, collect_stats=stats)

    results = {k: {"thresholds": v, "times_ms": []} for k, v in
               vectors.items()}
    with torch.no_grad():
        for vname, tv in vectors.items():
            reset()
            chunk(chunks[0], tv)
            _, _, stats = chunk(chunks[1], tv, stats=True)
            results[vname]["mean_changed_tiles_per_layer"] = \
                mean_changed_tiles(stats)
        order = list(vectors)
        for rep in range(reps):
            r = rep % len(order)
            for vname in order[r:] + order[:r]:
                tv = vectors[vname]
                reset()
                chunk(chunks[0], tv)  # cold start, untimed
                ms = device_ms(lambda: [chunk(c, tv) for c in chunks[1:]],
                               dev)
                results[vname]["times_ms"].append(ms)
                frames = (n_chunks - 1) * T
                log(f"rep{rep} {vname:<10} {ms / frames:7.3f} ms/frame "
                    f"({frames / (ms / 1e3):7.1f} fps)")
    frames = (n_chunks - 1) * T
    rows = []
    for vname, r in results.items():
        best = min(r["times_ms"])
        rows.append({
            "taus": vname, "thresholds": r["thresholds"],
            "best_fps": frames / (best / 1e3),
            "all_fps": [frames / (t / 1e3) for t in r["times_ms"]],
            "best_ms_per_frame": best / frames,
            "mean_changed_tiles_per_layer":
                r["mean_changed_tiles_per_layer"]})
    return {"model": name, "H": H, "W": W, "T": T, "chunks": n_chunks,
            "reps": reps, "rows": rows,
            "graph_captures": run.graphs.captures,
            "graphs": run.graphs.info(),
            "weights": wl.weights, "tau_source": wl.tau_source,
            "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {}),
            "note": ("one scan_video_jit runner for every vector: the taus "
                     "are written into a device vector before each replay, "
                     "so the timed form and the stats form are one captured "
                     "graph each (graph_captures); times by CUDA events "
                     "around the timed chunks' replays")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="scene")
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    wl = zoo.load(args.model, (args.h, args.w, 3),
                  zoo.default_pipeline_config(args.device),
                  width=args.width_mult)
    rec = tau_ab(wl, args.model, args.h, args.w, args.t, args.reps,
                 args.chunks, log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "EXP_tau_ab_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
