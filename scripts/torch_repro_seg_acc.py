#!/usr/bin/env python3
"""The seg accuracy repro with the PyTorch port (the twin of
``scripts/repro_seg_acc.py``).

    python3 scripts/torch_repro_seg_acc.py [--seed 65601]
        [--cache-dtype bfloat16|float32] [--warm] [--chunks 2] [--t 32]
        [--h 720] [--w 1280] [--device cuda|cpu] [--width-mult N]
        [--out PATH]

The reference's eval protocol at a fixed seed: the seg net (w64, trained
weights ``ckpts/seg_w64.npz``, tuned taus, the flagship converter without
a backend policy, its trailing upsample stripped; bf16 compute on the
card, float32 on the CPU; caches in ``--cache-dtype``) over ``--chunks``
clips of T frames through ``runner.scan_video_jit`` with a refresh
prolog on every 2nd chunk. ``--warm`` first runs a separate warm-up clip
that advances the video and leaves its state to the timed chunks, as the
headline evaluation does (the refresh prolog must erase it). Prints per
chunk the dense and CB GT-mIoU (labels at the output's stride), their
difference and CB's agreement mIoU with dense, and writes them to
``--out``, default ``chiprun_out/SEG_REPRO_torch.json`` (the reference
writes no file).
"""

import argparse
import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card  # noqa: E402
from cbinfer_tpu_torch.metrics import _np, miou, miou_labels  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)


def repro(seed=65601, cache_dtype=None, warm=False, H=720, W=1280, T=32,
          chunks=2, device="cuda", width=None, log=print):
    """The per-chunk rows (the module docstring's fields)."""
    dev = resolve_device(device)
    cfg = zoo.default_pipeline_config(device)
    if cache_dtype is not None:
        cfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
    wl = zoo.load("seg", (H, W, 3), cfg, apply_policy=False, width=width)
    net, params, taus = wl.net, wl.params, wl.taus
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=seed))
    stride = zoo.output_stride(wl, H, W)
    run = scan_video_jit(net)
    dense = _Graphs(1)
    state = net.init_state()

    def dense_chunk(fs):
        return dense.run(("dense",), lambda x: torch.stack(
            [net.apply_dense(params, f) for f in x]), fs)

    rows = []
    with torch.no_grad():
        if warm:
            clip = torch.from_numpy(video.clip(T)).to(dev)
            run(params, clip, state, thresholds=taus, refresh_start=True)
            run(params, clip, state, thresholds=taus)
            dense_chunk(clip)
        for i in range(chunks):
            f, lab = video.clip_with_labels(T)
            fs = torch.from_numpy(f).to(dev)
            dn = _np(dense_chunk(fs))
            ys = _np(run(params, fs, state, thresholds=taus,
                         refresh_start=i % 2 == 0)[0])
            labs = lab[:, ::stride, ::stride]
            md, mc = miou_labels(dn, labs, 8), miou_labels(ys, labs, 8)
            row = {"chunk": i, "miou_gt_dense": md, "miou_gt_cb": mc,
                   "delta": md - mc, "agreement_miou": miou(ys, dn, 8)}
            rows.append(row)
            log(f"seed {seed} device {dev.type} cache {cfg.cache_dtype} "
                f"chunk {i}: dense {md:.4f} cb {mc:.4f} delta "
                f"{md - mc:+.4f} agree {row['agreement_miou']:.4f}")
    return {"seed": seed, "shape": [H, W], "T": T, "warm": warm,
            "compute_dtype": cfg.compute_dtype,
            "cache_dtype": cfg.cache_dtype, "weights": wl.weights,
            "tau_source": wl.tau_source, "rows": rows, "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=65601)
    ap.add_argument("--cache-dtype", default=None,
                    choices=("bfloat16", "float32"))
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = repro(args.seed, args.cache_dtype, args.warm, args.h, args.w,
                args.t, args.chunks, args.device, args.width_mult,
                log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "SEG_REPRO_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
