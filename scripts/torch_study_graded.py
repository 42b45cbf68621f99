#!/usr/bin/env python3
"""Does the graded-change video make detection non-binary? The PyTorch
port's twin of ``scripts/study_graded.py``.

    python3 scripts/torch_study_graded.py [--h 240] [--w 320] [--t 48]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

A study at reduced size: per-layer mean changed-tile counts and
GT-mIoU across the tau grid on three arms, (a) the benign sprite video
and (b) ``video.GRADED_DYNAMICS`` scored with the trained seg net, and
(c) the graded dynamics on the hard palette scored with the trained
``scene_hard`` net. Each net is the flagship conversion without a backend
policy (``zoo.load(..., apply_policy=False)``) in the reference's study
configuration, on any device: float32 on the capacity-bounded plain
backend (``"torch"``, the twin of the reference's ``"jnp"``), every CB
layer at one tau, a refresh every 32 frames, mean stats, through
``runner.scan_video``; the first 8 frames are skipped in the GT-mIoU of
CB and dense. Then per arm the total changed tiles at the lowest tau over
those at the highest: the curve must bend on (b) for the threshold to
trade anything.

The counts do not depend on the hardware. Writes STUDY_graded.json's
keys (plus the device, and on the card its name and power limit) to
``--out``, default
``chiprun_out/STUDY_graded_torch.json``; the reference's file is never
written.
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
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig  # noqa: E402
from cbinfer_tpu_torch.metrics import _np, miou_labels  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video  # noqa: E402
from cbinfer_tpu_torch.video import (GRADED_DYNAMICS,  # noqa: E402
                                     SpriteVideo, SpriteVideoConfig)

NUM_CLASSES = 8
TAUS = (0.015, 0.02, 0.03, 0.045, 0.07, 0.1, 0.15)
SKIP = 8              # cold frames left out of the GT-mIoU


def study(H=240, W=320, T=48, device="cuda", width=None, log=print):
    """STUDY_graded.json's record (the module docstring's arms)."""
    dev = resolve_device(device)
    cfg = PipelineConfig(tile=TileConfig(8, 8, capacity_fraction=0.375),
                         backend="torch", device=device)
    base = dict(height=H, width=W, n_sprites=4,
                sprite_size=max(16, H // 15), speed=4.0, noise_std=0.002,
                seed=5)
    arms = {
        "benign": (base, "seg"),
        "graded": ({**base, **GRADED_DYNAMICS}, "seg"),
        "graded_hard": ({**base, **GRADED_DYNAMICS, "palette": "hard"},
                        "scene_hard"),
    }
    out = {"H": H, "W": W, "T": T, "graded": GRADED_DYNAMICS, "arms": {}}
    with torch.no_grad():
        for arm, (vk, name) in arms.items():
            wl = zoo.load(name, (H, W, 3), cfg, apply_policy=False,
                          width=width)
            net, params = wl.net, wl.params
            stride = zoo.output_stride(wl, H, W)
            n_cb = len(wl.taus)
            frames, labels = SpriteVideo(SpriteVideoConfig(
                **vk)).clip_with_labels(T)
            clip = torch.from_numpy(frames).to(dev)
            lab = labels[:, ::stride, ::stride]
            dense = np.stack([_np(net.apply_dense(params, f))
                              for f in clip])
            d_miou = miou_labels(np.argmax(dense[SKIP:], -1), lab[SKIP:],
                                 NUM_CLASSES)
            rows = []
            for tau in TAUS:
                ys, _, stats = scan_video(net, params, clip,
                                          thresholds=[tau] * n_cb,
                                          refresh_every=32,
                                          collect_stats="mean")
                cb_miou = miou_labels(np.argmax(_np(ys)[SKIP:], -1),
                                      lab[SKIP:], NUM_CLASSES)
                per_layer = [float(_np(s["changed_tiles"]))
                             for s in stats if s]
                rows.append({"tau": tau, "gt_miou_cb": cb_miou,
                             "degradation": d_miou - cb_miou,
                             "mean_changed_tiles": per_layer})
                log(f"{arm:11s} tau={tau:<5} deg={d_miou - cb_miou:+.4f} "
                    f"tiles={[round(x, 1) for x in per_layer]}")
            lo = sum(rows[0]["mean_changed_tiles"])
            hi = sum(rows[-1]["mean_changed_tiles"])
            out["arms"][arm] = {"gt_miou_dense": d_miou, "rows": rows,
                                "weights": wl.weights,
                                "tiles_ratio_lo_over_hi": lo / max(hi, 1e-9)}
            log(f"{arm}: total tiles tau={TAUS[0]} -> {lo:.0f}, "
                f"tau={TAUS[-1]} -> {hi:.0f} (ratio "
                f"{lo / max(hi, 1e-9):.2f}x)")
    out["device"] = str(dev)
    if dev.type == "cuda":
        out["card"] = card()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--t", type=int, default=48)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = study(args.h, args.w, args.t, args.device, args.width_mult,
                log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "STUDY_graded_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
