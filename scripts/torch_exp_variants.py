#!/usr/bin/env python3
"""Stem-policy, output-form and tile-size variants of the 720p scene net
with the PyTorch port (the twin of ``scripts/exp_variants.py``).

    python3 scripts/torch_exp_variants.py [stem|sparse|out|out_dense|tile|
                                           all] [--t 32] [--chunks 2]
        [--reps 2] [--h 720] [--w 1280] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

The scene net's specs and trained weights (``zoo.load("scene")``) under
named configurations, each timed on the same seed-0 clips: the CB scan
through ``runner.scan_video_jit`` at the tuned operating point (tau 0.15
on every CB layer), no stats; an untimed cold-start pass over chunk 0
(the eager first call and the graph capture), then the best of
``--reps`` passes over the chunks, the state carried, by CUDA events
around the replays. ms per frame, under the reference's row names:

  stem      ``stem=dense`` (the stem dense, the first pool detecting the
            full map), ``stem=dense_cached``, ``stem=cb_banded`` (the
            plain converter: the stem a CB conv on the default backend),
            ``stem=band_cached cap=F`` for F in 0.25, 0.375, 0.5
  sparse    ``stem=jnp cap=F`` for F in 0.1, 0.15, 0.25: the reference's
            bounded XLA tile stem, here the port's bounded ``"torch"``
            stem backend (plain PyTorch ops, a dense fallback past the
            capacity); and both with the classifier dense
  out       the flagship with its logits stacked (``out=logits``) or
            argmax to uint8 maps (``out=argmax_u8``)
  out_dense the dense baseline in both output forms, one captured graph
            of the frame loop, each timed pass on fresh clips
  tile      the flagship at tiles 8x8, 8x16, 8x32, 16x16 and 16x32

A configuration that a kernel refuses on the card (its wrapper raises)
is recorded under ``refused`` with the kernel's name and its message;
nothing falls back to plain ops.

Writes EXP_variants.json's keys (``weights``, ``ms_per_frame`` merged
across modes; plus ``refused``, ``notes``, the device and the card's name
and power limit) to ``--out``, default
``chiprun_out/EXP_variants_torch.json``; the reference's file is never
written. ``variants`` is what ``chip_smoke.py``'s ``variants`` phase
calls.
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
from cbinfer_tpu_torch.benchmark import card, device_ms  # noqa: E402
from cbinfer_tpu_torch.config import TileConfig  # noqa: E402
from cbinfer_tpu_torch.convert import (convert, convert_flagship,  # noqa
                                       num_cb_layers)
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

MODES = ("stem", "sparse", "out", "out_dense", "tile")
TAU = 0.15            # the tuned operating point on every CB layer
TILES = ((8, 8), (8, 16), (8, 32), (16, 16), (16, 32))
NOTES = {
    "stem=jnp": "the reference's bounded XLA tile stem (backend 'jnp') is "
                "the port's bounded 'torch' stem backend: plain PyTorch "
                "ops over TileConfig.capacity tiles, a dense fallback past "
                "it",
    "stem=cb_banded": "the plain converter's stem: a CB conv on the "
                      "default backend ('cuda'), as the reference's "
                      "convert() builds it",
}


def _u8(y):
    return y.argmax(-1).to(torch.uint8)


def _kernel_of(exc) -> str:
    """The kernel wrapper a refusal came from: its message's prefix."""
    msg = str(exc)
    head = msg.split(":", 1)[0]
    return head if head.replace("_", "").isalnum() else type(exc).__name__


def variants(modes=MODES, H=720, W=1280, T=32, n_chunks=2, reps=2,
             device="cuda", width=None, log=print):
    """The record (the module docstring's) for the modes asked."""
    dev = resolve_device(device)
    base_cfg = zoo.default_pipeline_config(device)
    wl = zoo.load("scene", (H, W, 3), base_cfg, apply_policy=False,
                  width=width)
    specs, params = list(wl.specs), wl.params
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=0))
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    frames = n_chunks * T

    def cfg_for(th=8, tw=8, capacity=0.375):
        return dataclasses.replace(base_cfg, tile=TileConfig(th, tw,
                                                             capacity))

    ms_rows, refused = {}, {}

    def run(name, build, out_map=None):
        try:
            net = build()
            taus = [TAU] * num_cb_layers(net.specs)
            scan = scan_video_jit(net)
            state = net.init_state()
            kw = dict(thresholds=taus, collect_stats=False, out_map=out_map)
            scan(params, chunks[0], state, **kw)  # cold start + capture
            scan(params, chunks[0], state, **kw)
        except (ValueError, NotImplementedError) as exc:
            refused[name] = {"kernel": _kernel_of(exc),
                             "error": f"{type(exc).__name__}: {exc}"}
            log(f"{name:<40} refused by {refused[name]['kernel']}")
            return
        best = min(device_ms(lambda: [scan(params, c, state, **kw)
                                      for c in chunks], dev)
                   for _ in range(reps))
        ms_rows[name] = best / frames
        log(f"{name:<40} {best / frames:7.3f} ms/frame "
            f"({frames / (best / 1e3):7.1f} fps)")
        del scan, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def run_dense(name, out_map=None):
        net = convert_flagship(specs, (H, W, 3), cfg_for())
        f = out_map or (lambda y: y)
        graphs = _Graphs(1)

        def dense(fs):
            return graphs.run(("dense",), lambda x: torch.stack(
                [f(net.apply_dense(params, fr)) for fr in x]), fs)
        # each timed pass on clips it has not seen (the reference's rule
        # against a runtime that memoizes a stateless dispatch)
        fresh = [torch.from_numpy(video.clip(T)).to(dev)
                 for _ in range(reps * n_chunks + 1)]
        dense(fresh[0])
        dense(fresh[0])
        best = min(device_ms(lambda: [dense(c) for c in fresh[
            1 + r * n_chunks:1 + (r + 1) * n_chunks]], dev)
                   for r in range(reps))
        ms_rows[name] = best / frames
        log(f"{name:<40} {best / frames:7.3f} ms/frame")

    shape = (H, W, 3)
    last = len(specs) - 1
    with torch.no_grad():
        if "stem" in modes:
            run("stem=dense", lambda: convert(specs, shape, cfg_for(),
                                              dense_layers=[0]))
            run("stem=dense_cached", lambda: convert(
                specs, shape, cfg_for(),
                backend_overrides={0: "dense_cached"}))
            run("stem=cb_banded", lambda: convert(specs, shape, cfg_for()))
            for cap in (0.25, 0.375, 0.5):
                run(f"stem=band_cached cap={cap}", lambda: convert(
                    specs, shape, cfg_for(capacity=cap),
                    backend_overrides={0: "band_cached"}))
        if "sparse" in modes:
            for cap in (0.10, 0.15, 0.25):
                run(f"stem=jnp cap={cap}", lambda: convert(
                    specs, shape, cfg_for(capacity=cap),
                    backend_overrides={0: "torch"}))
            run("stem=jnp cap=0.15 + dense classifier", lambda: convert(
                specs, shape, cfg_for(capacity=0.15),
                backend_overrides={0: "torch"}, dense_layers=[last]))
            run("stem=dense_cached + dense classifier", lambda: convert(
                specs, shape, cfg_for(),
                backend_overrides={0: "dense_cached"}, dense_layers=[last]))
        if "out" in modes:
            run("out=logits", lambda: convert_flagship(specs, shape,
                                                       cfg_for()))
            run("out=argmax_u8", lambda: convert_flagship(specs, shape,
                                                          cfg_for()), _u8)
        if "out" in modes or "out_dense" in modes:
            run_dense("out=dense_logits")
            run_dense("out=dense_argmax_u8", _u8)
        if "tile" in modes:
            for th, tw in TILES:
                run(f"tile={th}x{tw}", lambda: convert_flagship(
                    specs, shape, cfg_for(th, tw)))
    return {"weights": wl.weights, "ms_per_frame": ms_rows,
            "refused": refused,
            "notes": {k: v for k, v in NOTES.items()
                      if any(r.startswith(k) for r in ms_rows)
                      or any(r.startswith(k) for r in refused)},
            "modes": list(modes), "T": T, "chunks": n_chunks, "reps": reps,
            "tau": TAU, "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="all",
                    choices=MODES + ("all",))
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    modes = MODES if args.mode == "all" else (args.mode,)
    rec = variants(modes, args.h, args.w, args.t, args.chunks, args.reps,
                   args.device, args.width_mult,
                   log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "EXP_variants_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # merge, as the reference does: a mode's rows never erase another's
    if os.path.exists(out):
        with open(out) as f:
            prev = json.load(f)
        rec["ms_per_frame"] = {**prev.get("ms_per_frame", {}),
                               **rec["ms_per_frame"]}
        rec["refused"] = {**prev.get("refused", {}), **rec["refused"]}
        rec["notes"] = {**prev.get("notes", {}), **rec["notes"]}
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
