#!/usr/bin/env python3
"""Headline evaluation with the PyTorch port: fps, accuracy and FLOPs at
720p on the card (the twin of ``scripts/eval_headline.py``).

    python3 scripts/torch_eval_headline.py [scene|scene_f32cache|
        scene_hard|seg|pose|all] [--h 720] [--w 1280] [--t T]
        [--chunks 2] [--seed 0] [--device cuda|cpu] [--width-mult N]
        [--out PATH]

Per workload (``zoo.load``: trained weights, tuned taus, its backend
policy; bf16 on the card, float32 on the CPU; 8x8 tiles, capacity 0.375):
dense fps, CB fps, their ratio, the effective-FLOP reduction, the
agreement with the dense network's own output and the ground-truth
metric of both (mIoU, at full resolution where a trailing upsample was
stripped; GT-PCK at alpha 0.05 and 0.02 for pose). The CB path chains its
state over ``chunks`` distinct clips of T frames with a refresh prolog on
every R-th chunk (R from ``zoo.load_refresh_cadence``); both paths are
timed as replays of CUDA graphs of the frame loop (the dense one as
``benchmark.bench_network`` builds it, the CB one through
``runner.scan_video_jit``; the eager loop would time the host), in one
pass each after an untimed warm-up clip, with the deployment's output map
(argmax to uint8, then the stripped upsample) inside both. The clips come
from ``--seed``, and the row names it. ``scene`` gives two rows: the tuned
taus and a flat 0.02.

Writes ``{"rows": [...], "note": ...}`` with the reference's row keys
(plus the seed, the device and the card's name and power limit) to
``--out``, default ``chiprun_out/RESULTS_torch.json``; the reference's
``RESULTS.json`` is never written. ``bench_model`` is what
``chip_smoke.py``'s ``headline`` phase calls.
"""

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import (_Graphs, card,  # noqa: E402
                                         concat_stats, measure_sync_overhead,
                                         scalar_sync, time_chunked)
from cbinfer_tpu_torch.metrics import (_np, effective_flops,  # noqa: E402
                                       miou_labels, pck, pck_gt)
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

FAMILIES = ("scene", "scene_f32cache", "scene_hard", "seg", "pose")


def class_map(up_scale):
    """The deployment output map of a class-map workload: argmax to uint8,
    then the stripped nearest upsample of the map (argmax-transparent)."""
    def out_map(y):
        ids = y.argmax(-1).to(torch.uint8)
        if up_scale is not None:
            ids = ids.repeat_interleave(up_scale[0], -2) \
                .repeat_interleave(up_scale[1], -1)
        return ids
    return out_map


def bench_model(name, H=720, W=1280, T=32, tau=None, chunks=2,
                cache_dtype=None, device="cuda", seed=0, width=None,
                log=print):
    """One row: dense and CB fps from graphed replays, the FLOP
    reduction, the agreement with dense and the GT metric of both."""
    dev = resolve_device(device)
    entry = zoo.REGISTRY[name]
    metric = entry.metric
    classes = entry.model_kwargs.get("num_classes", 8)
    cfg = zoo.default_pipeline_config(device)
    if cache_dtype is not None:
        cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    wl = zoo.load(name, (H, W, 3), cfg, tau=tau, width=width)
    for msg in wl.warnings:
        log(f"eval: WARNING {name}: {msg}")
    net, params = wl.net, wl.params
    out_map = class_map(wl.upsample_scale) if metric == "miou" else None
    cadence, cadence_src = zoo.load_refresh_cadence(name, T, H, W)
    chunks = max(chunks, cadence)
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=max(8, 48 * H // 720),
        speed=4.0, noise_std=0.002, distinct_classes=(metric == "pck"),
        seed=seed, **workload_video_kwargs(name)))
    warm = torch.from_numpy(video.clip(T)).to(dev)
    clips, labels = [], []
    for _ in range(chunks):
        if metric == "pck":
            f, k, v = video.clip_with_keypoints(T)
            labels.append((k, v))
        else:
            f, lab = video.clip_with_labels(T)
            labels.append(lab)
        clips.append(torch.from_numpy(f).to(dev))
    for c in clips + [warm]:
        scalar_sync(c)
    sync_overhead = measure_sync_overhead(device=dev)

    with torch.no_grad():
        dense_graphs = _Graphs(1)

        def dense_frames(fs):
            return torch.stack([
                net.apply_dense(params, f) if out_map is None
                else out_map(net.apply_dense(params, f)) for f in fs])

        scalar_sync(dense_graphs.run(("dense",), dense_frames, warm))
        dense_outs = []

        def dense_chunk(i, ch):
            d = dense_graphs.run(("dense",), dense_frames, ch)
            dense_outs.append(d)
            return d

        dense_fps = time_chunked(dense_chunk, clips, T, sync_overhead)

        run = scan_video_jit(net)
        state = net.init_state()
        kw = dict(thresholds=wl.taus, collect_stats="mean", out_map=out_map)
        # both keys captured on the untimed clip, the refresh one first
        scalar_sync(run(params, warm, state, refresh_start=True, **kw)[0])
        scalar_sync(run(params, warm, state, refresh_start=False, **kw)[0])
        cb_outs, cb_stats = [], []

        def cb_chunk(i, ch):
            ys, _, stats = run(params, ch, state,
                               refresh_start=i % cadence == 0, **kw)
            cb_outs.append(ys)
            cb_stats.append(stats)
            return ys

        cb_fps = time_chunked(cb_chunk, clips, T, sync_overhead)

    stats = concat_stats(cb_stats)
    cb_np = np.concatenate([_np(y) for y in cb_outs])
    dn_np = np.concatenate([_np(d) for d in dense_outs])
    stride = zoo.output_stride(wl, H, W)
    if metric == "miou":
        labs = np.concatenate(labels)
        if wl.upsample_scale is None:
            labs = labs[:, ::stride, ::stride]
        mval = miou_labels(cb_np, dn_np, classes)  # agreement of the maps
        m_cb = miou_labels(cb_np, labs, classes)
        m_dn = miou_labels(dn_np, labs, classes)
        gt = {"miou_gt_dense": m_dn, "miou_gt_cb": m_cb,
              "miou_degradation": m_dn - m_cb}
    else:
        mval = pck(cb_np, dn_np)
        kps = np.concatenate([k for k, _ in labels])
        valid = np.concatenate([v for _, v in labels])
        p = {a: (pck_gt(dn_np, kps, valid, stride, alpha=a),
                 pck_gt(cb_np, kps, valid, stride, alpha=a))
             for a in (0.05, 0.02)}
        gt = {"pck_gt_dense": p[0.05][0], "pck_gt_cb": p[0.05][1],
              "pck_degradation": p[0.05][0] - p[0.05][1],
              "pck02_gt_dense": p[0.02][0], "pck02_gt_cb": p[0.02][1],
              "pck02_degradation": p[0.02][0] - p[0.02][1]}
    ef = effective_flops(stats, net.specs, (H, W, 3), 8, 8)
    row = {
        "model": name, "resolution": f"{H}x{W}",
        "tau": wl.tau_source if tau is None else tau,
        "thresholds": [float(t) for t in wl.taus],
        "weights": wl.weights, "cache_dtype": cfg.cache_dtype,
        "refresh": (f"chunk-start prolog every {cadence} chunks, interval "
                    f"{cadence * T} ({cadence_src})"),
        "dense_fps": dense_fps, "cb_fps": cb_fps,
        "speedup": cb_fps / dense_fps,
        "flop_reduction": ef["flop_reduction"],
        metric + "_vs_dense": mval, **gt,
        "overflow_frames": int(sum(np.sum(_np(s["overflow"]) > 0)
                                   for s in stats if s)),
        "seed": seed, "frames_timed": chunks * T, "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
    }
    if wl.upsample_scale is not None:
        row["grid_caveat"] = (
            "trailing nearest upsample executed as argmax-then-upsample "
            "inside both timed loops; GT mIoU scored at full resolution")
    if wl.policy_source != "none":
        row["backend_policy"] = wl.policy_source
    log(json.dumps(row))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", default="scene",
                    choices=FAMILIES + ("all",))
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=None,
                    help="frames per chunk (default 12 for pose, else 32)")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kw = dict(H=args.h, W=args.w, chunks=args.chunks, device=args.device,
              seed=args.seed, width=args.width_mult)
    rows = []
    for fam in (FAMILIES if args.which == "all" else (args.which,)):
        t = args.t or (12 if fam == "pose" else 32)
        if fam == "scene":
            rows.append(bench_model("scene", T=t, **kw))
            rows.append(bench_model("scene", T=t, tau=0.02, **kw))
        elif fam == "scene_f32cache":
            rows.append(bench_model("scene", T=t, tau=0.02,
                                    cache_dtype="float32", **kw))
        else:
            rows.append(bench_model(fam, T=t, **kw))
    out = args.out or os.path.join(REPO, "chiprun_out", "RESULTS_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"rows": rows, "note": (
            "CB against dense on identical synthetic clips, the PyTorch "
            "port on one card (name and power limit in each row); "
            "<metric>_vs_dense is the agreement with the dense network's "
            "own output, *_gt_* the ground-truth metric; fps from CUDA "
            "graph replays, one pass over the chunks after a warm-up "
            "clip")}, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
