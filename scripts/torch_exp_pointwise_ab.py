#!/usr/bin/env python3
"""Same-process interleaved A/B of the trailing pointwise conv as a conv
against a matmul with the PyTorch port (the twin of
``scripts/exp_pointwise_ab.py``).

    python3 scripts/torch_exp_pointwise_ab.py [scene] [--reps 5]
        [--chunks 6] [--t T] [--seed S] [--h 720] [--w 1280]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

``network.POINTWISE_DOT`` is the gate: ``convert.dense_conv_on_feature``
(the CB path's dense trailing 1x1 classifier) runs a matmul on the layer's
storage under True (the default) and ``network.dense_conv`` on the cropped
map under False. A captured CUDA graph holds the form it was captured
under, so each arm (``conv``: False, ``dot``: True) builds its own CB
runner (``benchmark.ABArm``) and dense graph and runs the eager first call
and the capture of every key while the flag holds its value (and holds it
again around the arm's reps, for the CPU's eager loop); the shipped
default is restored in ``finally``. The dense baseline (``apply_dense``)
never reads the flag: both arms replay the same dense work, so
``dense_speedup_dot_vs_conv`` is the measurement's noise floor.

Timed over the SAME device-resident chunks in interleaved reps: per rep
and arm, the CB state reset in place, chunk 0 as the refresh prolog
(untimed), the other chunks' replays by CUDA events; then the dense
graph over the same chunks. Medians. ``argmax_agreement`` is the share
of pixels (of heatmap argmaxes for the pose models) where the two CB arms'
last-rep outputs agree: bf16 conv and matmul sum in another order.

Writes EXP_pointwise_ab.json's keys (``models`` by name, plus the
agreement, the device and the card's name and power limit) to
``--out``, default ``chiprun_out/EXP_pointwise_ab_torch.json``; the
reference's file is never written. ``pointwise_ab`` is what
``chip_smoke.py``'s ``pointwise_ab`` phase calls.
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

from cbinfer_tpu_torch import network, zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import ABArm, card, device_ms  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

ARMS = {"conv": False, "dot": True}


def out_form(name):
    """argmax to uint8 class maps; the pose models' raw heatmaps."""
    if name.startswith("pose"):
        return None

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)
    return out_u8


def agreement(a, b) -> float:
    """Share of pixels whose class (or heatmap argmax) agrees."""
    if a.dtype != torch.uint8:
        a, b = a.float().argmax(-1), b.float().argmax(-1)
    return float((a == b).float().mean())


def pointwise_ab(wl, name, H, W, T, reps=5, n_chunks=6, seed=None,
                 log=print):
    """The model's section of the record (the module docstring's)."""
    dev = torch.device(wl.net.cfg.device)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, distinct_classes=name.startswith("pose"),
        seed=seed))
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    out_map = out_form(name)
    net, params = wl.net, wl.params

    def build(dot):
        """The arm's CB runner and dense graph, warmed and captured while
        the flag holds ``dot``."""
        network.POINTWISE_DOT = dot
        arm = ABArm(net, params, wl.taus, out_map, False)
        arm.warm(chunks)
        dense = _Graphs(1)

        def dense_chunk(fs):
            return dense.run(("dense",), lambda x: torch.stack(
                [(out_map or (lambda y: y))(net.apply_dense(params, f))
                 for f in x]), fs)
        dense_chunk(chunks[0])
        dense_chunk(chunks[0])
        return arm, dense_chunk

    cb_times = {k: [] for k in ARMS}
    dn_times = {k: [] for k in ARMS}
    outs = {}
    with torch.no_grad():
        orig = network.POINTWISE_DOT
        try:
            arms = {k: build(dot) for k, dot in ARMS.items()}
            for r in range(reps):
                for k, (arm, dense_chunk) in arms.items():
                    # a replay holds its captured form; the eager loop on
                    # the CPU reads the flag at each call
                    network.POINTWISE_DOT = ARMS[k]
                    ms, o = arm.rep(chunks)
                    cb_times[k].append(ms)
                    outs[k] = [ys for ys, _ in o]
                    dn_times[k].append(device_ms(
                        lambda: [dense_chunk(c) for c in chunks[1:]], dev))
                log(f"rep{r} " + "  ".join(
                    f"{k} cb {cb_times[k][-1]:.2f} dense "
                    f"{dn_times[k][-1]:.2f} ms" for k in arms))
        finally:
            network.POINTWISE_DOT = orig  # the shipped default
        agree = min(agreement(a, b) for a, b in zip(outs["conv"],
                                                    outs["dot"]))
        graphs = {k: a.run.graphs.captures for k, (a, _) in arms.items()}
    frames = (n_chunks - 1) * T
    med = {k: float(np.median(v)) for k, v in cb_times.items()}
    dmed = {k: float(np.median(v)) for k, v in dn_times.items()}
    return {
        "model": name, "reps": reps, "seed": seed, "T": T,
        "chunks": n_chunks,
        "cb_ms_per_frame": {k: m / frames for k, m in med.items()},
        "dense_ms_per_frame": {k: m / frames for k, m in dmed.items()},
        "cb_speedup_dot_vs_conv": med["conv"] / med["dot"],
        "dense_speedup_dot_vs_conv": dmed["conv"] / dmed["dot"],
        "all_cb_s": {k: [t / 1e3 for t in v] for k, v in cb_times.items()},
        "all_dense_s": {k: [t / 1e3 for t in v]
                        for k, v in dn_times.items()},
        "argmax_agreement": agree, "graph_captures": graphs,
        "pointwise_dot_default": network.POINTWISE_DOT,
        "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="scene")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--t", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    T = args.t or (12 if args.model.startswith("pose") else 32)
    wl = zoo.load(args.model, (args.h, args.w, 3),
                  zoo.default_pipeline_config(args.device),
                  width=args.width_mult)
    row = pointwise_ab(wl, args.model, args.h, args.w, T, args.reps,
                       args.chunks, args.seed,
                       log=lambda m: print(m, flush=True))
    print(json.dumps({k: row[k] for k in (
        "model", "cb_ms_per_frame", "dense_ms_per_frame",
        "cb_speedup_dot_vs_conv", "dense_speedup_dot_vs_conv",
        "argmax_agreement")}), flush=True)
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "EXP_pointwise_ab_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"experiment": "Same-process interleaved A/B: pointwise "
                   "conv as F.conv2d vs matmul (the port).",
                   "models": {args.model: row}}, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
