#!/usr/bin/env python3
"""Many streams on one card with the PyTorch port (the twin of
``scripts/bench_multistream.py``).

    python3 scripts/torch_bench_multistream.py [--streams 4,8] [--h 720]
        [--w 1280] [--t 16] [--chunks 2] [--reps 3] [--seed S]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

The scene flagship (``zoo.load``: trained weights, tuned taus; argmax to
uint8 maps, no stats, as the reference's deployment form) serving S
streams, each with its own clip (seeds ``seed + s``). Arms, each with its
own graphs and states, over the SAME device-resident (S, T, H, W, 3)
chunks:

  sequential        the S clips back to back, each through a
                    ``runner.scan_video_jit`` of its own (one stream at a
                    time)
  batched           ``parallel.MultiStreamRunner.run_clip`` (one
                    dispatch per stream in waves, outputs gathered into
                    one (S, T, ...) tensor)
  batched_nogather  the same runner with ``gather_outputs=False`` (a list
                    of per-stream outputs, the sequential arm's form)
  side_streams      the sequential arm's graphs, each stream's replay on a
                    side CUDA stream of its own, joined to the current
                    stream by events (``parallel.replay_on_side_streams``:
                    not a runner form, the baseline the runner on side
                    streams will be judged by; the card only)

Every arm warms on an untimed chunk (the cold start; the eager first call
and the capture of each stream's graph). Then ``--reps`` rounds, the arms
in a rotating order, each a pass over the ``--chunks`` timed chunks (the
states carried) timed by CUDA events around its replays
(``benchmark.device_ms``). Frames per second per card from the best pass.

Writes the reference's ``multistream`` row keys per S (plus the side-
stream arm, every pass's rate, the seed, the device and the card's name
and power limit) as ``{"rows": [...]}`` to ``--out``, default
``chiprun_out/MULTISTREAM_torch.json``; the reference's ``RESULTS.json``
is never written. ``run`` is what ``chip_smoke.py``'s
``multistream_bench`` phase calls.
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
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.parallel import (MultiStreamRunner,  # noqa: E402
                                        make_stream_mesh,
                                        replay_on_side_streams)
from cbinfer_tpu_torch.runner import scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

def out_u8(y):
    return y.argmax(-1).to(torch.uint8)


def bench(wl, S, chunks, warm, reps=3, log=print):
    """One row for S streams (the module docstring's arms)."""
    dev = warm.device
    cuda = dev.type == "cuda"
    T = int(warm.shape[1])
    net, params, taus = wl.net, wl.params, wl.taus
    mesh = make_stream_mesh(1, dev.type)
    kw = dict(thresholds=taus, collect_stats=False, out_map=out_u8)
    alone = [scan_video_jit(net) for _ in range(S)]
    states = [net.init_state() for _ in range(S)]
    runners = {g: MultiStreamRunner(net, params, n_streams=S, mesh=mesh,
                                    thresholds=taus, out_map=out_u8,
                                    collect_stats=False, gather_outputs=g)
               for g in (True, False)}
    side = [torch.cuda.Stream(dev) for _ in range(S)] if cuda else None

    def sequential(ch):
        return [alone[s](params, ch[s], states[s], **kw)[0]
                for s in range(S)]

    units = {"sequential": sequential,
             "batched": lambda ch: runners[True].run_clip(ch[:S])[0],
             "batched_nogather":
                 lambda ch: runners[False].run_clip(ch[:S])[0]}
    if cuda:
        units["side_streams"] = lambda ch: replay_on_side_streams(
            alone, params, ch, states, side, **kw)
    with torch.no_grad():
        for unit in units.values():  # cold start, eager calls, captures
            unit(warm)
        if cuda:
            torch.cuda.synchronize()
        ms = {k: [] for k in units}
        order = list(units)
        for r in range(reps):
            k0 = r % len(order)
            for k in order[k0:] + order[:k0]:
                ms[k].append(device_ms(
                    lambda: [units[k](c) for c in chunks], dev))
            log(f"S={S} rep{r} " + "  ".join(
                f"{k} {ms[k][-1]:.1f} ms" for k in units))
    frames = len(chunks) * S * T
    fps = {k: [frames / (t / 1e3) for t in v] for k, v in ms.items()}
    best = {k: max(v) for k, v in fps.items()}
    seq = best["sequential"]
    row = {
        "model": "scene", "mode": "multistream",
        "resolution": f"{int(warm.shape[2])}x{int(warm.shape[3])}",
        "streams": S, "weights": wl.weights, "tau_source": wl.tau_source,
        "sequential_fps_per_chip": seq,
        "batched_fps_per_chip": best["batched"],
        "batched_vs_sequential": best["batched"] / seq,
        "batched_nogather_fps_per_chip": best["batched_nogather"],
        "batched_nogather_vs_sequential": best["batched_nogather"] / seq,
        "side_streams_fps_per_chip": best.get("side_streams"),
        "side_streams_vs_sequential": (best["side_streams"] / seq
                                       if "side_streams" in best else None),
        "all_fps": fps, "T": T, "chunks": len(chunks), "reps": reps,
        "devices": len(mesh),
        "graphs_live": sum(len(a.graphs.info()) for a in alone)
        + sum(len(g) for r in runners.values() for g in r.graphs()),
    }
    if cuda:
        row["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return row


def make_chunks(H, W, T, S, n, seed, dev):
    """``n`` + 1 chunks of (S, T, H, W, 3) frames, stream s from its own
    video (``seed + s``), on the device; the first is the warm chunk."""
    videos = [SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=3, sprite_size=32, speed=4.0,
        noise_std=0.002, seed=seed + s)) for s in range(S)]
    return [torch.from_numpy(np.stack([v.clip(T) for v in videos])).to(dev)
            for _ in range(n + 1)]


def run(streams=(4, 8), H=720, W=1280, T=16, n_chunks=2, reps=3, seed=None,
        device="cuda", width=None, log=print):
    """The record: one row per stream count."""
    dev = resolve_device(device)
    seed = int(time.time() * 1e3) % 100000 if seed is None else seed
    wl = zoo.load("scene", (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    rows = []
    for S in streams:
        chunks = make_chunks(H, W, T, S, n_chunks, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        row = bench(wl, S, chunks[1:], chunks[0], reps, log)
        log(json.dumps({k: v for k, v in row.items() if k != "all_fps"}))
        rows.append(row)
        del chunks
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"rows": rows, "seed": seed, "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {}),
            "note": ("frames/s per card, best of the reps; every arm over "
                     "the same device-resident chunks, CUDA events around "
                     "each pass's replays; side_streams runs the "
                     "sequential arm's graphs on a side CUDA stream each "
                     "(the card only)")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", default="4,8")
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--t", type=int, default=16)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = run(tuple(int(s) for s in args.streams.split(",")), args.h,
              args.w, args.t, args.chunks, args.reps, args.seed,
              args.device, args.width_mult,
              log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "MULTISTREAM_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
