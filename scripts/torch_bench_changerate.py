#!/usr/bin/env python3
"""Throughput and accuracy over the change rate with the PyTorch port (the
twin of ``scripts/bench_changerate.py``).

    python3 scripts/torch_bench_changerate.py [--seed S] [--points a,b]
        [--chunks 4] [--pairs 2] [--t 32] [--h 720] [--w 1280]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

The scene flagship (``zoo.load``: trained weights, tuned taus) over the
seven POINTS of the reference script, from a few slow sprites to a
panning camera. Per point, on ``--chunks`` distinct clips of T frames
(chunk 0 refreshes and is the warm-up; the rest are timed): graphed CB
(``runner.scan_video_jit``) against graphed dense in ``--pairs``
alternating pairs, CUDA events around each unit; the stem's changed-tile
share and the overflow rate; and the accuracy of the timed chunks:

  agreement_miou    mean over chunks of mIoU(CB map, dense map), the
                    reference script's number (recorded, not gated: a
                    class with a handful of pixels in one map and none in
                    the other scores 0 and drops it by 1/8 of a chunk)
  pixel_agreement   share of pixels where the two maps agree
  class_iou         per chunk and class: IoU of the two maps and the
                    class's pixel count in each
  miou_gt_*         GT-mIoU of CB and of dense against the video's labels
                    over the timed chunks, and ``miou_degradation`` =
                    dense - CB: the repo's 0.5% budget (``gate``)

On the card every point's replayed chunk is first held bit for bit
against the eager loop. Then the break-even changed share, interpolated
as the reference does. The clip seed is ``--seed`` (default: the clock,
as the reference's), and the record names it.

Writes CHANGERATE.json's keys (plus the device and the card's name and
power limit) to ``--out``, default ``chiprun_out/CHANGERATE_torch.json``;
the reference's file is never written. ``sweep``, ``point`` and ``gate``
are what ``chip_smoke.py``'s ``changerate`` phase and
``scripts/torch_changerate_seeds.py`` call.
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
from cbinfer_tpu_torch.benchmark import card, device_ms  # noqa: E402
from cbinfer_tpu_torch.layers import CBLayerState  # noqa: E402
from cbinfer_tpu_torch.metrics import _np, miou_labels  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import (_Graphs, _items,  # noqa: E402
                                      scan_video, scan_video_jit)
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

NUM_CLASSES = 8
GT_BUDGET = 0.005     # the repo's budget: GT-mIoU of dense minus that of CB
# the reference's POINTS, unchanged: sprite-driven change rates, then a
# global camera pan (the background scrolls every frame)
POINTS = [
    ("sprites1", dict(n_sprites=1, sprite_size=48, speed=4.0)),
    ("sprites4", dict(n_sprites=4, sprite_size=48, speed=4.0)),
    ("sprites8", dict(n_sprites=8, sprite_size=48, speed=6.0)),
    ("sprites16", dict(n_sprites=16, sprite_size=64, speed=8.0)),
    ("sprites24", dict(n_sprites=24, sprite_size=80, speed=10.0)),
    ("pan_slow", dict(n_sprites=4, sprite_size=48, speed=4.0,
                      pan=(1.0, 2.0))),
    ("pan_fast", dict(n_sprites=4, sprite_size=48, speed=4.0,
                      pan=(4.0, 8.0))),
]


def clock_seed():
    return int(time.time() * 1e3) % 100000


def make_chunks(seed, over, H, W, T, chunks):
    """``chunks`` clips of T frames of one point and their labels (host
    numpy). Below 720 rows the sprites shrink with the frame."""
    over = dict(over, sprite_size=max(8, over["sprite_size"] * H // 720))
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, noise_std=0.002, seed=seed,
        **workload_video_kwargs("scene"), **over))
    return [video.clip_with_labels(T) for _ in range(chunks)]


def _clone_state(state):
    return [None if s is None else CBLayerState(s.in_cache.clone(),
                                                s.out_cache.clone())
            for s in state]


def _restore(dst, src):
    """Write a saved state into the live tensors (graphs stay bound)."""
    for a, b in zip(dst, src):
        if a is not None:
            a.in_cache.copy_(b.in_cache)
            a.out_cache.copy_(b.out_cache)


def _same_run(a, b, what):
    """Outputs, stats and every cache of two runs, bit for bit."""
    (ya, sa, ta), (yb, sb, tb) = a, b
    same = torch.equal(ya, yb) and all(
        x.keys() == y.keys() and all(torch.equal(torch.as_tensor(x[k]),
                                                 torch.as_tensor(y[k]))
                                     for k in x)
        for x, y in zip(ta, tb)) and all(
        x is None or (torch.equal(x.in_cache, y.in_cache)
                      and torch.equal(x.out_cache, y.out_cache))
        for x, y in zip(sa, sb))
    if not same:
        raise AssertionError(f"{what}: the replay differs from the eager "
                             "loop")


def map_accuracy(cb_maps, dense_maps, labels, num_classes=NUM_CLASSES):
    """The accuracy fields of a point's row from its timed chunks' uint8
    class maps (CB, dense) and their labels at the output's grid: the
    agreement per chunk and its mean, pixel agreement, per-class IoU of
    the two maps with each map's pixel count, and GT-mIoU of both."""
    agree, pix, classes = [], [], []
    for c, d in zip(cb_maps, dense_maps):
        agree.append(miou_labels(c, d, num_classes))
        pix.append(float(np.mean(c == d)))
        rows = []
        for k in range(num_classes):
            pc, pd = c == k, d == k
            union = int(np.sum(pc | pd))
            rows.append({"cls": k, "cb_pixels": int(np.sum(pc)),
                         "dense_pixels": int(np.sum(pd)),
                         "iou": (float(np.sum(pc & pd)) / union
                                 if union else None)})
        classes.append(rows)
    cb, dn, lab = (np.concatenate(x) for x in (cb_maps, dense_maps, labels))
    m_cb = miou_labels(cb, lab, num_classes)
    m_dn = miou_labels(dn, lab, num_classes)
    return dict(
        agreement_miou=float(np.mean(agree)), agreement_miou_chunks=agree,
        pixel_agreement=float(np.mean(pix)), pixel_agreement_chunks=pix,
        class_iou=classes,
        miou_gt_cb=m_cb, miou_gt_dense=m_dn, miou_degradation=m_dn - m_cb,
        miou_gt_cb_chunks=[miou_labels(c, l, num_classes)
                           for c, l in zip(cb_maps, labels)],
        miou_gt_dense_chunks=[miou_labels(d, l, num_classes)
                              for d, l in zip(dense_maps, labels)])


def gate(row, budget=GT_BUDGET):
    """The point holds the repo's budget: GT-mIoU(dense) - GT-mIoU(CB) <=
    ``budget`` over its timed chunks (the agreement mIoU is not gated)."""
    return row["miou_degradation"] <= budget


def point(wl, cadence, label, over, chunks, labels, *, pairs=2,
          log=print):
    """One point: ``chunks`` (device clips of T frames; 0 refreshes) and
    ``labels`` (host class ids at the output's grid) through the
    workload's net. The row as the module docstring says."""
    net, params, taus = wl.net, wl.params, wl.taus
    dev = chunks[0].device
    T = int(chunks[0].shape[0])

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)

    run = scan_video_jit(net)
    dense = _Graphs(1)
    state = net.init_state()
    n = len(chunks)

    def cb(i):
        return run(params, chunks[i], state, thresholds=taus,
                   refresh_start=i % cadence == 0, collect_stats="mean",
                   out_map=out_u8)

    def dn(i):
        return dense.run(("dense",), lambda fs: torch.stack(
            [out_u8(net.apply_dense(params, f)) for f in fs]), chunks[i])

    # warm: a refresh and a steady chunk (eager, then captured), the dense
    # chunk; then chunk 2 replayed against the eager loop from a copy
    cb(0)
    after0 = _clone_state(state)
    cb(1)
    dn(0)
    if n > 2:
        s_eager = _clone_state(state)
        eager = scan_video(net, params, chunks[2], s_eager,
                           collect_stats="mean", thresholds=taus,
                           refresh_start=2 % cadence == 0, out_map=out_u8)
        _same_run(eager, cb(2), f"changerate {label}")
        del eager, s_eager
    last = {}

    def cb_unit():
        _restore(state, after0)
        last["cb"] = [cb(i) for i in range(1, n)]

    def dense_unit():
        last["dense"] = [dn(i) for i in range(1, n)]

    frames = (n - 1) * T
    series = {"cb": [], "dense": []}
    for kind in ["cb", "dense", "dense", "cb"] * max(1, pairs // 2):
        ms = device_ms(cb_unit if kind == "cb" else dense_unit, dev)
        series[kind].append(ms / frames)
    ratio = [d / c for c, d in zip(series["cb"], series["dense"])]
    stats = [c[2] for c in last["cb"]]
    layers = [[d for _, d in _items(s) if d] for s in stats]
    stem = [ls[0] for ls in layers]
    changed = float(np.mean([float(s["changed_tiles"] / s["n_tiles"])
                             for s in stem]))
    overflow = max(float(np.mean([float(d["overflow"]) for d in ds]))
                   for ds in zip(*layers))
    cb_ms, dn_ms = (float(np.median(series[k])) for k in ("cb", "dense"))
    acc = map_accuracy([_np(c[0]) for c in last["cb"]],
                       [_np(d) for d in last["dense"]], labels[1:])
    row = dict(point=label, config={k: list(v) if isinstance(v, tuple)
                                    else v for k, v in over.items()},
               changed_tile_frac_layer0=changed, overflow_rate=overflow,
               cb_fps=1e3 / cb_ms, dense_fps=1e3 / dn_ms,
               speedup=float(np.median(ratio)),
               speedup_spread=[min(ratio), max(ratio)], **acc,
               within_budget=gate(acc),
               stem_computed_tiles=float(np.mean(
                   [float(s["computed_tiles"]) for s in stem])),
               stem_n_tiles=float(stem[0]["n_tiles"]),
               ms_per_frame=series,
               graph_identical_to_eager=dev.type == "cuda" and n > 2)
    log(json.dumps({"changerate_point": {
        k: v for k, v in row.items() if k != "class_iou"}}))
    return row


def break_even(rows):
    """The changed share where CB's speedup crosses 1, interpolated
    linearly over the sorted points (the reference's)."""
    pts = sorted((r["changed_tile_frac_layer0"], r["speedup"]) for r in rows)
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if (y0 - 1.0) * (y1 - 1.0) <= 0 and y0 != y1:
            return x0 + (1.0 - y0) * (x1 - x0) / (y1 - y0)
    return None


def load_scene(H, W, T, device="cuda", width=None):
    """The scene workload and its refresh cadence in chunks."""
    wl = zoo.load("scene", (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    cadence, _ = zoo.load_refresh_cadence("scene", T, H, W)
    return wl, cadence


def sweep(seed, H=720, W=1280, T=32, chunks=4, pairs=2, points=None,
          device="cuda", width=None, log=print):
    """Every point of ``points`` (labels; default all seven) on clips from
    ``seed``; the frames of all points are made in threads first (the
    numpy generator releases the interpreter lock in its heavy parts),
    each point's moved to the device once its turn comes."""
    from concurrent.futures import ThreadPoolExecutor
    dev = resolve_device(device)
    wl, cadence = load_scene(H, W, T, device, width)
    stride = zoo.output_stride(wl, H, W)
    todo = [(k, v) for k, v in POINTS if points is None or k in points]
    t0 = time.perf_counter()
    rows = []
    with ThreadPoolExecutor(len(todo)) as pool:
        made = [pool.submit(make_chunks, seed, over, H, W, T, chunks)
                for _, over in todo]
        for k, (label, over) in enumerate(todo):
            got = made[k].result()
            made[k] = None  # the host copy goes
            clips = [torch.from_numpy(f).to(dev) for f, _ in got]
            labs = [lab[:, ::stride, ::stride] for _, lab in got]
            rows.append(point(wl, cadence, label, over, clips, labs,
                              pairs=pairs, log=log))
            del clips
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    be = break_even(rows)
    return {"model": "scene", "resolution": f"{H}x{W}", "chunks": chunks,
            "frames_per_chunk": T, "reps": pairs, "seed": seed,
            "refresh_cadence_chunks": cadence, "rows": rows,
            "break_even_changed_tile_frac": be,
            "gt_budget": GT_BUDGET,
            "points_over_budget": [r["point"] for r in rows
                                   if not r["within_budget"]],
            "seconds_with_frames": time.perf_counter() - t0,
            "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {}),
            "note": ("speedup = graphed CB ms / graphed dense ms per pair, "
                     "median over pairs, same process; agreement_miou is "
                     "CB's mIoU against dense (recorded), miou_degradation "
                     "the GT-mIoU of dense minus CB's (the 0.5% budget). "
                     "pan_* rows break the static-camera premise: the "
                     "stem overflows its capacity and every tile is "
                     "recomputed.")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="clip seed (default: from the clock)")
    ap.add_argument("--points", default=None,
                    help="comma-separated point labels (default: all)")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    seed = clock_seed() if args.seed is None else args.seed
    rec = sweep(seed, args.h, args.w, args.t, args.chunks, args.pairs,
                None if args.points is None else args.points.split(","),
                args.device, args.width_mult,
                log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "CHANGERATE_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
