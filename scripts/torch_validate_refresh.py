#!/usr/bin/env python3
"""Measured refresh-cadence validation with the PyTorch port (the twin of
``scripts/validate_refresh.py``).

    python3 scripts/torch_validate_refresh.py [scene|seg|pose|...]
        [--cadences 2,4,8,0] [--chunks 12] [--seeds 0,1] [--t T]
        [--h 720] [--w 1280] [--budget 0.005] [--tau TAU]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

The accepted-value rule lets a cache drift up to tau from the exactly
computed value for as long as a stream runs, so deployments refresh (a
dense prolog on every R-th chunk of T frames). This measures, per cadence
R (0 = never, the unbounded-drift reference), the ground-truth degradation
(mIoU or GT-PCK of dense minus that of CB) and the CB-vs-dense agreement
per chunk over a long horizon on fixed seeds, as the horizon mean and the
worst chunk, and picks the largest cadence whose worst chunk stays within
the budget on every seed. The deployment configuration: the workload from
``zoo.load`` (trained weights, tuned taus, its backend policy), bf16 on the
card (float32 on the CPU), 8x8 tiles, capacity 0.375.

Writes a record with the keys of ``REFRESH_<model>.json`` (plus the seeds,
the device and, on the card, its name and power limit) to ``--out``,
default ``chiprun_out/REFRESH_<model>_torch.json``. The reference's
``REFRESH_*.json`` files, which ``zoo.load_refresh_cadence`` reads, are
never written. The scan is the eager loop (this measures accuracy, not
time). ``--width-mult`` builds the architecture at another width with
random weights (small CPU runs).
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
from cbinfer_tpu_torch.metrics import (_np, iu_counts, merge_iu,  # noqa: E402
                                       pck, pck_gt)
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)


def validate(model: str, h: int, w: int, t: int, chunks: int, cadences,
             seeds, budget: float, tau=None, device: str = "cuda",
             width=None, log=print):
    """The measurement; returns the record (rows included)."""
    dev = resolve_device(device)
    entry = zoo.REGISTRY[model]
    metric = entry.metric
    classes = entry.model_kwargs.get("num_classes", 8)
    cfg = zoo.default_pipeline_config(device)
    wl = zoo.load(model, (h, w, 3), cfg, tau=tau, width=width)
    net, params, taus = wl.net, wl.params, wl.taus
    stride = zoo.output_stride(wl, h, w)
    # the video of the bench that reads the cadence (eval_headline: 4
    # sprites of 48 px; the DAG's bench: 3 of 32), scaled with the height
    n_spr, spr = (3, 32) if wl.kind == "graph" else (4, 48)
    spr = max(8, spr * h // 720)

    def gt_of(ys, lab):
        if metric == "miou":
            return merge_iu(*(_np(v).astype(np.int64) for v in iu_counts(
                ys.argmax(-1), lab, classes)))
        kps, valid = lab
        return pck_gt(_np(ys), kps, valid, stride)

    def agree_of(ys, dn):
        if metric == "miou":
            return merge_iu(*(_np(v).astype(np.int64) for v in iu_counts(
                ys.argmax(-1), dn.argmax(-1), classes)))
        return pck(_np(ys), _np(dn))

    rows = []
    with torch.no_grad():
        for seed in seeds:
            video = SpriteVideo(SpriteVideoConfig(
                height=h, width=w, n_sprites=n_spr, sprite_size=spr,
                speed=4.0, noise_std=0.002,
                distinct_classes=(metric == "pck"), seed=seed,
                **workload_video_kwargs(model)))
            clips, labels = [], []
            for _ in range(chunks):
                if metric == "pck":
                    f, k, v = video.clip_with_keypoints(t)
                    labels.append((k, v))
                else:
                    f, lab = video.clip_with_labels(t)
                    labels.append(torch.from_numpy(np.ascontiguousarray(
                        lab[:, ::stride, ::stride])).to(dev))
                clips.append(torch.from_numpy(f).to(dev))
            dense = [torch.stack([net.apply_dense(params, x) for x in c])
                     for c in clips]
            dense_gt = [gt_of(d, lab) for d, lab in zip(dense, labels)]
            for cad in cadences:
                state = net.init_state()
                per_chunk = []
                for i, (c, lab) in enumerate(zip(clips, labels)):
                    ys, state, _ = scan_video(
                        net, params, c, state, collect_stats=False,
                        thresholds=taus,
                        refresh_start=cad > 0 and i % cad == 0)
                    per_chunk.append({
                        "chunk": i,
                        "degradation": dense_gt[i] - gt_of(ys, lab),
                        "agreement": agree_of(ys, dense[i])})
                worst = max(per_chunk, key=lambda r: r["degradation"])
                row = {
                    "seed": seed, "cadence": cad,
                    "interval_frames": cad * t if cad else None,
                    "horizon_frames": chunks * t,
                    "mean_degradation": float(np.mean(
                        [r["degradation"] for r in per_chunk])),
                    "worst_chunk_degradation": float(worst["degradation"]),
                    "worst_chunk": worst["chunk"],
                    "min_agreement": float(min(r["agreement"]
                                               for r in per_chunk)),
                }
                rows.append(row)
                log(json.dumps(row))
    worst_by = {cad: max(r["worst_chunk_degradation"] for r in rows
                         if r["cadence"] == cad) for cad in cadences}
    # the largest finite interval within budget on every seed; "never"
    # (0) is not chosen: an unbounded stream keeps some bound
    finite = sorted(c for c, v in worst_by.items() if v <= budget and c > 0)
    return {
        "model": model, "metric": metric, "T": t, "shape": [h, w],
        "chunks": chunks, "budget": budget,
        "worst_by_cadence": {str(k): v for k, v in worst_by.items()},
        "refresh_every_chunks": finite[-1] if finite else None,
        "rows": rows,
        "note": ("cadence R = refresh prolog every R-th T-frame chunk; "
                 "worst_chunk_degradation is the max over the horizon "
                 "(drift peaks just before a refresh); cadence 0 = cold "
                 "start only (unbounded drift reference)"),
        "seeds": list(seeds), "tau_source": wl.tau_source,
        "weights": wl.weights, "policy": wl.policy_source,
        "device": str(dev), "dtype": cfg.cache_dtype,
        **({"card": card()} if dev.type == "cuda" else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="pose",
                    choices=tuple(zoo.names()))
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=None,
                    help="frames per chunk (default 12 for pose, else 32)")
    ap.add_argument("--chunks", type=int, default=12)
    ap.add_argument("--cadences", default="2,4,8,0")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--budget", type=float, default=0.005)
    ap.add_argument("--tau", type=float, default=None,
                    help="a flat tau instead of the tuned vector")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    t = args.t or (12 if args.model.startswith("pose") else 32)
    result = validate(args.model, args.h, args.w, t, args.chunks,
                      [int(c) for c in args.cadences.split(",")],
                      [int(s) for s in args.seeds.split(",")], args.budget,
                      args.tau, args.device, args.width_mult)
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}),
          flush=True)
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   f"REFRESH_{args.model}_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
