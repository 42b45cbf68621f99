#!/usr/bin/env python3
"""End to end: a pretrained torch CNN converted to change-based inference
with the PyTorch port (the twin of ``scripts/demo_torch_import.py``).

    python3 scripts/torch_demo_import.py [--h 144] [--w 192] [--steps 30]
                                         [--device cuda|cpu] [--out PATH]

Builds a small torch scene CNN, "pretrains" it (Adam steps on the sprite
task, so its weights carry structure), walks it into the layer-spec IR with
``convert.specs_from_torch``, converts it with ``convert_flagship`` and
streams a clip through ``runner.scan_video_jit`` (on the card a CUDA graph
of the frame loop, on the CPU the eager loop), checking the CB output
against the dense forward of the same imported weights (argmax mIoU at
least 0.98 at tau 0.04). Prints one JSON line; ``--out`` also writes it.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from cbinfer_tpu_torch.config import PipelineConfig, TileConfig  # noqa: E402
from cbinfer_tpu_torch.convert import (convert_flagship,  # noqa: E402
                                       num_cb_layers, specs_from_torch)
from cbinfer_tpu_torch.metrics import _np, miou  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig  # noqa

K = 8          # classes
TAU = 0.04
MIN_MIOU = 0.98


def torch_model(seed: int) -> nn.Sequential:
    """The user's model; its structure mirrors ``scene``."""
    torch.manual_seed(seed)
    return nn.Sequential(
        nn.Conv2d(3, 32, 3, padding=1), nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Conv2d(32, 64, 3, padding=1), nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Conv2d(64, 64, 3, padding=1), nn.ReLU(),
        nn.Conv2d(64, 64, 3, padding=1), nn.ReLU(),
        nn.Conv2d(64, K, 1),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=144)
    ap.add_argument("--w", type=int, default=192)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA
    H, W = args.h, args.w

    model = torch_model(args.seed).to(dev)
    video = SpriteVideo(SpriteVideoConfig(height=H, width=W, n_sprites=3,
                                          sprite_size=max(8, H // 6),
                                          seed=1))
    frames, labels = video.clip_with_labels(8)
    x_t = torch.from_numpy(frames.transpose(0, 3, 1, 2)).to(dev)   # NCHW
    y_t = torch.from_numpy(labels[:, ::4, ::4].astype(np.int64)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    loss = torch.zeros(())
    for _ in range(args.steps):
        opt.zero_grad()
        loss = nn.functional.cross_entropy(model(x_t), y_t)
        loss.backward()
        opt.step()
    model.eval()

    specs, params = specs_from_torch(model, device=dev)
    cfg = PipelineConfig(tile=TileConfig(8, 8, capacity_fraction=0.5),
                         device=args.device)
    net = convert_flagship(specs, (H, W, 3), cfg)
    taus = [TAU] * num_cb_layers(net.specs)
    clip = torch.from_numpy(video.clip(args.frames)).to(dev)
    run = scan_video_jit(net)
    state = net.init_state()
    with torch.no_grad():
        ys, state, stats = run(params, clip, state, thresholds=taus)
        dense = torch.stack([net.apply_dense(params, f) for f in clip])
    m = miou(_np(ys), _np(dense), K)
    frac = float(np.mean([
        np.mean(_np(s["computed_tiles"]) / np.max(_np(s["n_tiles"])))
        for s in stats if s]))
    out = {"shape": [H, W], "device": str(dev), "train_steps": args.steps,
           "final_loss": float(loss.detach()),
           "specs": [type(s).__name__ for s in specs],
           "backends": [getattr(s, "backend", None) for s in net.specs],
           "tau": TAU, "miou_vs_dense": m,
           "mean_recompute_fraction": frac, "ok": m >= MIN_MIOU}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if not out["ok"]:
        raise SystemExit(f"CB-vs-dense mIoU {m} below {MIN_MIOU}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
