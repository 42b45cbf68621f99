#!/usr/bin/env python3
"""Conv mask-forwarding policies on a real workload with the PyTorch port
(the twin of ``scripts/exp_forward.py``).

    python3 scripts/torch_exp_forward.py [seg|pose|scene] [--h 720]
        [--w 1280] [--t 32] [--chunks 2] [--seed S] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

Forwarding (``ConvSpec.forward_hint``) replaces a conv's detect by its
producer's hint dilated over the receptive field and a tile copy of the
hinted input (B9 on the card): no tau, a conservative superset of the
recompute that grows with depth. The variants, by the reference's rule:

  base      the flagship (re-detection everywhere)
  fwd_deep  forwarding on the CB convs whose input is at most half the
            frame's height
  fwd_all   forwarding on every CB conv but the stem and the classifier

Each variant is the model's specs (trained weights, tuned taus; the
trailing upsample stripped) through ``convert.convert_flagship`` at 8x8
tiles with no backend policy and no fused detect, as the reference
builds it. Per variant: an untimed warm clip (the cold start; the eager
first call and the graph capture), then ``--chunks`` distinct clips of T
frames through ``runner.scan_video_jit`` with stacked stats, timed by CUDA
events around their replays: ``cb_fps``; ``flop_reduction`` over every
timed chunk's stats. A layer that the kernels' gate refuses (a hinted or
forwarding conv on a map of fewer than 8 rows or columns off the 8 grid)
makes the variant's row name the layer and the refusal; nothing falls
back to plain ops.

Writes EXP_forward.json's keys (``<model>_<H>x<W>`` -> variant -> row, plus
the seed, the device and the card's name and power limit) to ``--out``,
default ``chiprun_out/EXP_forward_torch.json``; the reference's file is
never written. ``forward`` is what ``chip_smoke.py``'s ``forward`` phase
calls.
"""

import argparse
import dataclasses
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import (card, concat_stats,  # noqa: E402
                                         device_ms)
from cbinfer_tpu_torch.config import ConvSpec, TileConfig  # noqa: E402
from cbinfer_tpu_torch.convert import convert_flagship  # noqa: E402
from cbinfer_tpu_torch.metrics import effective_flops  # noqa: E402
from cbinfer_tpu_torch.network import out_shapes, resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

VARIANTS = ("base", "fwd_deep", "fwd_all")


def variant_specs(specs, H, W, mode):
    """The reference's rule (``scripts/exp_forward.py:75-84``)."""
    shapes = [(H, W, 3)] + list(out_shapes(specs, (H, W, 3)))
    out = []
    for i, s in enumerate(specs):
        if (isinstance(s, ConvSpec) and 0 < i < len(specs) - 1
                and s.use_cb):
            deep = shapes[i][0] <= H // 2
            if mode == "fwd_all" or (mode == "fwd_deep" and deep):
                s = dataclasses.replace(s, forward_hint=True)
        out.append(s)
    return out


def refused_layers(specs, H, W, msg):
    """The spec indexes whose input map is the one a refusal names."""
    m = re.search(r"got \((\d+), (\d+)\)", msg)
    if not m:
        return []
    shape = (int(m.group(1)), int(m.group(2)))
    shapes = [(H, W, 3)] + list(out_shapes(specs, (H, W, 3)))
    return [i for i, s in enumerate(specs)
            if isinstance(s, ConvSpec) and s.use_cb
            and tuple(shapes[i][:2]) == shape]


def forward(name, H=720, W=1280, T=32, n_chunks=2, seed=None,
            device="cuda", width=None, cfg=None, params=None, log=print):
    """Per variant ``{cb_fps, flop_reduction}``, or the refusal. ``cfg``
    replaces the deployment's pipeline config (its tile is the reference's
    8x8 at full capacity either way), ``params`` the loaded weights."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or zoo.default_pipeline_config(device),
                              tile=TileConfig(8, 8))
    wl = zoo.load(name, (H, W, 3), cfg, apply_policy=False, width=width)
    for msg in wl.warnings:
        log(f"{name}: WARNING {msg}")
    if params is not None:
        wl = dataclasses.replace(wl, params=params)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=seed))
    warm = torch.from_numpy(video.clip(T)).to(dev)
    clips = [torch.from_numpy(video.clip(T)).to(dev)
             for _ in range(n_chunks)]
    results = {}
    with torch.no_grad():
        for mode in VARIANTS:
            vs = variant_specs(wl.specs, H, W, mode)
            net = convert_flagship(vs, (H, W, 3), cfg)
            run = scan_video_jit(net)
            state = net.init_state()
            kw = dict(thresholds=wl.taus, collect_stats=True)
            try:
                run(wl.params, warm, state, **kw)
            except (NotImplementedError, ValueError) as exc:
                results[mode] = {"refused": {
                    "layers": refused_layers(vs, H, W, str(exc)),
                    "error": f"{type(exc).__name__}: {exc}"}}
                log(f"{mode} refused: {results[mode]['refused']}")
                continue
            stats = []
            ms = device_ms(lambda: stats.extend(
                run(wl.params, c, state, **kw)[2] for c in clips), dev)
            ef = effective_flops(concat_stats(stats), net.specs, (H, W, 3),
                                 8, 8)
            results[mode] = {"cb_fps": n_chunks * T / (ms / 1e3),
                             "flop_reduction": ef["flop_reduction"],
                             "forwarding_layers": [
                                 i for i, s in enumerate(vs)
                                 if getattr(s, "forward_hint", False)
                                 and isinstance(s, ConvSpec)]}
            log(f"{mode} {results[mode]}")
            del run, state
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return {"variants": results, "seed": seed, "weights": wl.weights,
            "tau_source": wl.tau_source, "T": T, "chunks": n_chunks,
            "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="seg")
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = forward(args.model, args.h, args.w, args.t, args.chunks, args.seed,
                  args.device, args.width_mult,
                  log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "EXP_forward_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    merged = {}
    if os.path.exists(out):
        with open(out) as f:
            merged = json.load(f)
    merged[f"{args.model}_{args.h}x{args.w}"] = {
        **rec["variants"], "_run": {k: v for k, v in rec.items()
                                    if k != "variants"}}
    with open(out, "w") as f:
        json.dump(merged, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
