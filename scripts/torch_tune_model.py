#!/usr/bin/env python3
"""Tune a workload's per-layer thresholds with the PyTorch port (the twin
of ``scripts/tune_model.py``).

    python3 scripts/torch_tune_model.py [scene|seg|pose|...] [budget]
        [--stress-only] [--h 720] [--w 1280] [--t 192] [--refresh 32]
        [--skip 8] [--grid 0.015,0.02,...] [--device cuda|cpu]
        [--width-mult N] [--out-tau PATH] [--out-tune PATH]

``tuner.tune`` at the repo's budget (0.005 of ground-truth mIoU or GT-PCK
against the dense network) on a calibration set of two clips (seeds 7 and
11) disjoint from the bench clips, under the deployment's refresh (every
32 frames) and configuration (``zoo.load``'s flagship, bf16 on the card,
8x8 tiles, capacity 0.375); then ``tuner.stress_validate`` of the tuned
vector, its 0.7x and 0.5x scalings and flat fallbacks on two fresh seeds
(101, 203), which picks the vector to ship. ``--stress-only`` skips the
sweep and validates the raw tuned vector of an earlier record (``--prior``,
default the workload's shipped tau file, read only).

Writes the tau record (the keys of ``ckpts/<model>_tau.json``) to
``--out-tau`` (default ``chiprun_out/<model>_tau_torch.json``) and the
Pareto curve and sweep (the keys of ``TUNE_<model>.json``) to
``--out-tune`` (default ``chiprun_out/TUNE_<model>_torch.json``). The
shipped ``ckpts/*_tau.json`` and ``TUNE_*.json``, which ``zoo.load``
reads, are never written. ``--width-mult`` builds the architecture at
another width with random weights (small CPU runs).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from cbinfer_tpu_torch import tuner, zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card  # noqa: E402
from cbinfer_tpu_torch.checkpoint import save_thresholds  # noqa: E402
from cbinfer_tpu_torch.metrics import (miou_labels,  # noqa: E402
                                       miou_labels_device, pck_gt,
                                       pck_gt_device)
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

CALIB_SEEDS = (7, 11)
STRESS_SEEDS = (101, 203)
GRIDS = {"pose": (0.02, 0.03, 0.045, 0.07, 0.1),
         "other": (0.015, 0.02, 0.03, 0.045, 0.07, 0.1, 0.15)}
BUDGETS = (0.001, 0.002, 0.005, 0.01, 0.02)
CLASSES = 8


def clips_and_labels(name: str, h: int, w: int, t: int, seeds, stride: int,
                     pose: bool):
    """Host clips and their ground truth at the output stride: class ids
    (scene, seg) or packed keypoints [y, x, valid] (pose)."""
    vk = workload_video_kwargs(name)
    clips, labels = [], []
    for s in seeds:
        video = SpriteVideo(SpriteVideoConfig(
            height=h, width=w, n_sprites=4, sprite_size=max(24, h // 15),
            speed=4.0, noise_std=0.002,
            distinct_classes=pose, seed=s, **vk))
        if pose:
            f, k, v = video.clip_with_keypoints(t)
            labels.append(np.concatenate(
                [k, v[..., None].astype(np.float32)], axis=-1))
        else:
            f, lab = video.clip_with_labels(t)
            labels.append(np.ascontiguousarray(lab[:, ::stride, ::stride]))
        clips.append(f)
    return clips, labels


def metric_fns(pose: bool, stride: int):
    """(host, device) metrics: 1 - (GT(dense) - GT(cb))."""
    if pose:
        def host(cb, dn, lab):
            lab = np.asarray(lab).reshape(-1, lab.shape[-2], 3)
            kps, valid = lab[..., :2], lab[..., 2] > 0.5
            return 1.0 - (pck_gt(dn, kps, valid, stride)
                          - pck_gt(cb, kps, valid, stride))

        def device(cb, dn, lab):
            return 1.0 - (pck_gt_device(dn, lab, stride)
                          - pck_gt_device(cb, lab, stride))
        return host, device

    def host(cb, dn, lab):
        return 1.0 - (miou_labels(dn, lab, CLASSES)
                      - miou_labels(cb, lab, CLASSES))

    def device(cb, dn, lab):
        return 1.0 - (miou_labels_device(dn, lab, CLASSES)
                      - miou_labels_device(cb, lab, CLASSES))
    return host, device


def prior_tuned(path: str):
    """--stress-only: the raw tuned vector of an earlier record (its stress
    rows' "tuned" row), else its thresholds, and its metadata."""
    with open(path) as f:
        d = json.load(f)
    md = d.get("metadata", {})
    rows = (md.get("stress_validation") or {}).get("rows") or []
    tuned = next((r["thresholds"] for r in rows if r.get("name") == "tuned"),
                 None)
    return (tuned or d["thresholds"], md.get("metric", float("nan")),
            md.get("flop_reduction", float("nan")))


def run(name: str, budget: float, stress_only: bool, h: int, w: int,
        t: int, refresh: int, skip: int, grid, device: str, width=None,
        prior=None, log=print):
    """The sweep (unless ``stress_only``) and the stress validation;
    returns (tau record, TuneResult or None)."""
    dev = resolve_device(device)
    pose = name.startswith("pose")
    wl = zoo.load(name, (h, w, 3), zoo.default_pipeline_config(device),
                  width=width)
    net, params = wl.net, wl.params
    stride = zoo.output_stride(wl, h, w)
    host_fn, dev_fn = metric_fns(pose, stride)
    grid = tuple(grid or GRIDS["pose" if pose else "other"])
    t0 = time.perf_counter()
    res = None
    if stress_only:
        taus, metric, flop_red = prior_tuned(prior or zoo.REGISTRY[name]
                                             .tau_json)
    else:
        calib, labels = clips_and_labels(name, h, w, t, CALIB_SEEDS, stride,
                                         pose)
        res = tuner.tune(net, params, np.stack(calib), host_fn,
                         device_metric_fn=dev_fn, labels=np.stack(labels),
                         tau_grid=grid, budgets=BUDGETS, budget=budget,
                         skip_frames=skip, refresh_every=refresh,
                         verbose=False)
        taus, metric, flop_red = res.thresholds, res.metric, \
            res.flop_reduction
        log(f"selected taus: {taus}; calib metric {metric:.5f}; flop "
            f"reduction {flop_red:.2f}x; {res.evaluations} evaluations")
    tune_s = time.perf_counter() - t0
    cands = {"tuned": list(taus)}
    for s in (0.7, 0.5):
        cands[f"tuned_x{s}"] = [float(x) * s for x in taus]
    tmax = max(taus)
    for flat in (0.07, 0.045, 0.03, 0.02, 0.015):
        if flat < tmax:
            cands[f"flat{flat}"] = [flat] * len(taus)
    vclips, vlabels = clips_and_labels(name, h, w, t, STRESS_SEEDS, stride,
                                       pose)
    t1 = time.perf_counter()
    stress = tuner.stress_validate(net, params, cands, vclips,
                                   metric_fn=host_fn, labels=vlabels,
                                   device_metric_fn=dev_fn, budget=budget,
                                   skip_frames=skip, refresh_every=refresh)
    if stress.source != "tuned":
        log(f"WARNING: the tuned vector failed the stress validation; "
            f"shipping {stress.source}")
    record = {"thresholds": [float(x) for x in stress.thresholds],
              "metadata": {
                  "budget": budget, "metric": metric,
                  "stress_validation": {
                      "resolution": f"{h}x{w}", "T": t,
                      "seeds": list(STRESS_SEEDS), "source": stress.source,
                      "passed": stress.passed, "rows": stress.rows},
                  "metric_def": (
                      "1 - (pck_gt(dense) - pck_gt(cb)); gt = sprite "
                      "keypoints" if pose else
                      "1 - (miou_gt(dense) - miou_gt(cb)); gt = sprite "
                      "labels at output stride"),
                  "resolution": f"{h}x{w}", "flop_reduction": flop_red,
                  "calib": f"sprites seeds 7+11 T={t} {h}x{w}",
                  "refresh_every": refresh, "weights": wl.weights,
                  "device": str(dev), "dtype": net.cfg.cache_dtype,
                  "tune_seconds": tune_s,
                  "stress_seconds": time.perf_counter() - t1,
                  **({"card": card()} if dev.type == "cuda" else {})}}
    return record, res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="scene",
                    choices=tuple(zoo.names()))
    ap.add_argument("budget", nargs="?", type=float, default=0.005)
    ap.add_argument("--stress-only", action="store_true")
    ap.add_argument("--prior", default=None,
                    help="--stress-only's tau record (default: the "
                    "workload's shipped one, read only)")
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=192,
                    help="frames per clip: one light cycle of the graded "
                    "video profiles")
    ap.add_argument("--refresh", type=int, default=32)
    ap.add_argument("--skip", type=int, default=8)
    ap.add_argument("--grid", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out-tau", default=None)
    ap.add_argument("--out-tune", default=None)
    args = ap.parse_args(argv)
    grid = None if args.grid is None else [float(g) for g in
                                           args.grid.split(",")]
    record, res = run(args.model, args.budget, args.stress_only, args.h,
                      args.w, args.t, args.refresh, args.skip, grid,
                      args.device, args.width_mult, args.prior)
    out_dir = os.path.join(REPO, "chiprun_out")
    out_tau = args.out_tau or os.path.join(
        out_dir, f"{args.model}_tau_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_tau)), exist_ok=True)
    save_thresholds(out_tau, record["thresholds"], record["metadata"])
    print(json.dumps({"thresholds": record["thresholds"],
                      "source": record["metadata"]["stress_validation"]
                      ["source"]}), flush=True)
    print(f"wrote {out_tau}", flush=True)
    if res is not None:
        out_tune = args.out_tune or os.path.join(
            out_dir, f"TUNE_{args.model}_torch.json")
        os.makedirs(os.path.dirname(os.path.abspath(out_tune)),
                    exist_ok=True)
        with open(out_tune, "w") as f:
            f.write(res.to_json())
        print(f"wrote {out_tune}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
