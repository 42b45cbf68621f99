#!/usr/bin/env python3
"""A digest of one workload's run with the PyTorch port, to hold two
source trees bit for bit against each other on the same card.

    python3 scripts/torch_run_digest.py [scene|seg|pose|pose_graph]
        [--chunks 4] [--t 32] [--seed 0] [--h 720] [--w 1280]
        [--device cuda|cpu] [--width-mult N]

``zoo.load``'s workload (trained weights, tuned taus, its policy) over
``--chunks`` chunks of its video (``--seed``) through
``runner.scan_video_jit``, a refresh prolog on the first chunk, stacked
stats: prints one JSON line with the SHA-256 of every chunk's outputs, of
its stats and of the state's caches after the run (the graphs' replays
from the second call of each key on). Run it from the root of each tree
(e.g. the parent commit unpacked under ``build/parent``) and compare the
lines.
"""

import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _tensors, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                 else b"")
    return h.hexdigest()


def digest(name, H=720, W=1280, T=32, chunks=4, seed=0, device="cuda",
           width=None):
    """{outputs, stats, caches}: SHA-256 hex digests of the run."""
    dev = resolve_device(device)
    wl = zoo.load(name, (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=seed, distinct_classes=name.startswith("pose"),
        **workload_video_kwargs(name)))
    run = scan_video_jit(wl.net)
    state = wl.net.init_state()
    outs, stats = [], []
    with torch.no_grad():
        for i in range(chunks):
            ys, _, st = run(wl.params, torch.from_numpy(video.clip(T)).to(dev),
                            state, thresholds=wl.taus, refresh_start=i == 0)
            outs.append(ys)
            stats.extend(t if isinstance(t, torch.Tensor)
                         else torch.tensor(t) for t in _stat_leaves(st))
    return {"workload": name, "chunks": chunks, "T": T, "seed": seed,
            "outputs": _sha(outs), "stats": _sha(stats),
            "caches": _sha(_tensors(state)),
            "graph_captures": run.graphs.captures}


def _stat_leaves(stats):
    items = stats.values() if isinstance(stats, dict) else stats
    for d in items:
        for k in sorted(d):
            yield d[k]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", nargs="?", default="scene")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    args = ap.parse_args(argv)
    print(json.dumps(digest(args.workload, args.h, args.w, args.t,
                            args.chunks, args.seed, args.device,
                            args.width_mult)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
