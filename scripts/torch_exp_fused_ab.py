#!/usr/bin/env python3
"""Same-process interleaved A/B of the fused consumer detect, on against
off, with the PyTorch port (the twin of ``scripts/exp_fused_ab.py``).

    python3 scripts/torch_exp_fused_ab.py [pose|pose_graph] [--reps 5]
        [--chunks 6] [--t 32] [--seed S] [--h 720] [--w 1280]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

Both forms of one workload (``zoo.load``: trained weights, tuned taus),
each a runner and a state of its own (``benchmark.ABArm``), timed over the
SAME device-resident chunks in interleaved reps, medians. A rep resets
the arm's state in place, runs chunk 0 as the refresh prolog (untimed),
then times the other chunks (``collect_stats="mean"``, the outputs of the
deployment) by CUDA events around their replays. A sequential net's arms
are ``strip_fused(net)`` and ``with_fused`` of it (the shared static gate,
``layers.fuse_next_gate``, over the converted specs); the DAG's are both
built through ``graph.convert_graph_flagship`` with ``fuse_detect`` off
and on, as the reference builds them. The fused kernel runs the
consumer's detect on the tiles its producer computes, so the arms'
outputs and stats must be equal (``outputs_identical``).

Writes the reference's JSON line's keys (plus the fused layers by index
or node name, the device and the card's name and power limit) to
``--out``, default ``chiprun_out/EXP_fused_ab_<model>_torch.json``; the
reference's EXP_fused_ab.json is never written. ``fused_ab`` is what
``chip_smoke.py``'s ``fused_ab`` phase calls.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import ABArm, card  # noqa: E402
from cbinfer_tpu_torch.config import ConvSpec  # noqa: E402
from cbinfer_tpu_torch.layers import fuse_next_gate  # noqa: E402
from cbinfer_tpu_torch.netview import NetView  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _tensors  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)


def strip_fused(net):
    """The same net with every ``fuse_next_detect`` flag cleared."""
    if hasattr(net, "nodes"):
        nodes = tuple(
            dataclasses.replace(
                n, spec=dataclasses.replace(n.spec, fuse_next_detect=False))
            if isinstance(n.spec, ConvSpec) else n for n in net.nodes)
        return dataclasses.replace(net, nodes=nodes)
    specs = tuple(dataclasses.replace(s, fuse_next_detect=False)
                  if isinstance(s, ConvSpec) else s for s in net.specs)
    return dataclasses.replace(net, specs=specs)


def with_fused(net):
    """A sequential net opted INTO the fused consumer detect wherever the
    shared static gate holds (``layers.fuse_next_gate``)."""
    assert not hasattr(net, "nodes"), "sequential nets only"
    view = NetView.from_specs(net.specs, net.in_shape, net.cfg)
    specs = list(net.specs)
    for i in range(len(specs) - 1):
        if fuse_next_gate(specs[i], specs[i + 1], view.rows[i].in_shape,
                          net.cfg):
            specs[i] = dataclasses.replace(specs[i], fuse_next_detect=True)
    return dataclasses.replace(net, specs=tuple(specs))


def fused_layers(net):
    """The producers marked ``fuse_next_detect``: spec indexes of a
    sequential net, node names of a DAG."""
    if hasattr(net, "nodes"):
        return [n.name for n in net.nodes
                if getattr(n.spec, "fuse_next_detect", False)]
    return [i for i, s in enumerate(net.specs)
            if getattr(s, "fuse_next_detect", False)]


def arms_of(wl, name, H, W):
    """(unfused net, fused net) of a loaded workload."""
    if name == "pose_graph":
        from cbinfer_tpu_torch.graph import convert_graph_flagship
        cfg = wl.net.cfg
        return tuple(convert_graph_flagship(
            list(wl.specs), (H, W, 3), cfg, output=wl.net.output,
            fuse_detect=f) for f in (False, True))
    net_u = strip_fused(wl.net)
    return net_u, with_fused(net_u)


def _same(a, b) -> bool:
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def fused_ab(wl, name, H=720, W=1280, T=32, reps=5, n_chunks=6, seed=None,
             log=print):
    """The record (the module docstring's) for one loaded workload."""
    dev = torch.device(wl.net.cfg.device)
    net_u, net_f = arms_of(wl, name, H, W)
    layers = fused_layers(net_f)
    if not layers:
        raise ValueError(f"{name}: no fused layers, nothing to A/B")
    out_map = None
    if not name.startswith("pose"):
        def out_map(y):
            return y.argmax(-1).to(torch.uint8)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=seed))
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    times = {"fused": [], "unfused": []}
    outs = {}
    with torch.no_grad():
        arms = {k: ABArm(net, wl.params, wl.taus, out_map, "mean")
                for k, net in (("fused", net_f), ("unfused", net_u))}
        for arm in arms.values():
            arm.warm(chunks)
        for r in range(reps):
            for k, arm in arms.items():
                ms, outs[k] = arm.rep(chunks)
                times[k].append(ms)
            log(f"rep{r} fused {times['fused'][-1]:.2f} ms  unfused "
                f"{times['unfused'][-1]:.2f} ms")
    identical = all(_same(a, b) for a, b in zip(outs["fused"],
                                                outs["unfused"]))
    frames = (n_chunks - 1) * T
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {
        "model": name, "fused_layers": len(layers),
        "fused_layer_ids": layers, "reps": reps,
        "fused_ms": med["fused"] / frames,
        "unfused_ms": med["unfused"] / frames,
        "fused_fps": frames / (med["fused"] / 1e3),
        "unfused_fps": frames / (med["unfused"] / 1e3),
        "speedup": med["unfused"] / med["fused"],
        "all_fused_s": [t / 1e3 for t in times["fused"]],
        "all_unfused_s": [t / 1e3 for t in times["unfused"]],
        "seed": seed, "T": T, "chunks": n_chunks,
        "outputs_identical": identical,
        "graph_captures": {k: a.run.graphs.captures
                           for k, a in arms.items()},
        "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="pose")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    wl = zoo.load(args.model, (args.h, args.w, 3),
                  zoo.default_pipeline_config(args.device),
                  width=args.width_mult)
    rec = fused_ab(wl, args.model, args.h, args.w, args.t, args.reps,
                   args.chunks, args.seed, log=lambda m: print(m, flush=True))
    print(json.dumps({k: v for k, v in rec.items()
                      if not k.startswith("all_")}), flush=True)
    out = args.out or os.path.join(
        REPO, "chiprun_out", f"EXP_fused_ab_{args.model}_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
