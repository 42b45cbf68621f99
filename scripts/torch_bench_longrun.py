#!/usr/bin/env python3
"""One long stream with the PyTorch port (the twin of
``scripts/bench_longrun.py``).

    python3 scripts/torch_bench_longrun.py [--chunks 64] [--win 8]
        [--seed 424242] [--t 32] [--h 720] [--w 1280]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

The scene flagship (``zoo.load``: trained weights, tuned taus) over one
continuous stream of ``--chunks`` chunks of T frames (64 x 32 = 2048 by
default) through ``runner.scan_video_jit``: the state carried from chunk
to chunk, a refresh prolog on every chunk whose index is a multiple of
the validated cadence (``zoo.load_refresh_cadence``), argmax to uint8
inside, no stats. The reference's protocol: a throwaway chunk warms every
graph first (then the state is reset in place); each window of ``--win``
chunks is made on the host and moved to the device before its timed
span, never inside it. Per window:

  cb_fps                frames over the device time of its replays (CUDA
                        events around the window)
  miou_gt_cb, _dense    GT-mIoU of the CB maps and of the dense network's
                        (a graphed dense chunk, untimed) against the
                        video's labels, from per-class counts summed over
                        the window; degradation = dense - CB
  memory_*_mib          device memory allocated after the window once
                        its frames, labels and outputs are freed and the
                        collector has run (``memory_allocated_mib``, with
                        the live blocks), while they are still held
                        (``memory_with_window_mib``), and the peak within
                        the window; graphs live and captured so far (a
                        leak or a growing graph pool would show here)

Then the first, last, least and most fps, their drift, and the worst
window's degradation against the repo's 0.5% budget.

Writes LONGRUN.json's keys (plus the seed, the device, the budget and
the card's name and power limit) to ``--out``, default
``chiprun_out/LONGRUN_torch.json``; the reference's file is never
written. ``longrun`` is what ``chip_smoke.py``'s ``longrun`` phase
calls.
"""

import argparse
import gc
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card, device_ms  # noqa: E402
from cbinfer_tpu_torch.metrics import iu_maps_device, merge_iu  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import (_Graphs, _tensors,  # noqa: E402
                                      scan_video_jit)
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

NUM_CLASSES = 8
GT_BUDGET = 0.005
MIB = 2.0 ** 20


def longrun(net, params, taus, cadence, H=720, W=1280, T=32, chunks=64,
            win=8, seed=424242, stride=4, log=print):
    """The stream's record (the module docstring's fields) for one net on
    the device of its params."""
    dev = _tensors(params)[0].device
    cuda = dev.type == "cuda"
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=seed))

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)

    run = scan_video_jit(net)
    dense = _Graphs(1)
    state = net.init_state()
    kw = dict(thresholds=taus, collect_stats=False, out_map=out_u8)

    def dense_chunk(fs):
        return dense.run(("dense",), lambda x: torch.stack(
            [out_u8(net.apply_dense(params, f)) for f in x]), fs)

    with torch.no_grad():
        # warm every graph on a throwaway chunk (it advances the video as
        # the reference's does), then reset the state in place
        warm = torch.from_numpy(video.clip(T)).to(dev)
        run(params, warm, state, refresh_start=True, **kw)
        run(params, warm, state, refresh_start=False, **kw)
        dense_chunk(warm)
        del warm
        for dst, src in zip(_tensors(state), _tensors(net.init_state())):
            dst.copy_(src)
        windows = []
        for w0 in range(0, chunks, win):
            w1 = min(w0 + win, chunks)
            staged = []
            for _ in range(w0, w1):
                f, lab = video.clip_with_labels(T)
                staged.append((torch.from_numpy(f).to(dev),
                               torch.from_numpy(
                                   np.ascontiguousarray(
                                       lab[:, ::stride, ::stride])).to(dev)))
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            outs = []

            def window():
                for j, (f, _) in enumerate(staged):
                    outs.append(run(params, f, state,
                                    refresh_start=(w0 + j) % cadence == 0,
                                    **kw)[0])

            ms = device_ms(window, dev)
            iu = {"cb": [0, 0], "dense": [0, 0]}
            for (f, lab), ys in zip(staged, outs):
                for k, maps in (("cb", ys), ("dense", dense_chunk(f))):
                    i, u = iu_maps_device(maps, lab, NUM_CLASSES)
                    iu[k][0] = iu[k][0] + i.long()
                    iu[k][1] = iu[k][1] + u.long()
            m_cb, m_dn = (merge_iu(iu[k][0].cpu().numpy(),
                                   iu[k][1].cpu().numpy())
                          for k in ("cb", "dense"))
            row = {"window_chunks": [w0, w1], "frames": [w0 * T, w1 * T],
                   "cb_fps": (w1 - w0) * T / (ms / 1e3),
                   "miou_gt_cb": m_cb, "miou_gt_dense": m_dn,
                   "degradation": m_dn - m_cb,
                   "graphs_live": len(run.graphs.info()),
                   "graph_captures": run.graphs.captures}
            if cuda:
                # the stream's own memory: read once the window's frames,
                # labels and outputs are gone and the collector has run
                row["memory_with_window_mib"] = \
                    torch.cuda.memory_allocated() / MIB
                row["memory_peak_mib"] = \
                    torch.cuda.max_memory_allocated() / MIB
            del staged, outs, window, iu, f, lab, ys, maps, i, u
            gc.collect()
            if cuda:
                row["memory_allocated_mib"] = \
                    torch.cuda.memory_allocated() / MIB
                row["memory_blocks"] = torch.cuda.memory_stats().get(
                    "active.all.current", 0)
            windows.append(row)
            log(json.dumps(row))
    fps = [w["cb_fps"] for w in windows]
    degs = [w["degradation"] for w in windows]
    return {
        "model": "scene", "resolution": f"{H}x{W}",
        "horizon_frames": chunks * T, "refresh_cadence_chunks": cadence,
        "fps_first_window": fps[0], "fps_last_window": fps[-1],
        "fps_min": min(fps), "fps_max": max(fps),
        "fps_drift_last_vs_first": fps[-1] / fps[0],
        "worst_window_degradation": max(degs),
        "mean_degradation": float(np.mean(degs)),
        "gt_budget": GT_BUDGET,
        "within_budget": max(degs) <= GT_BUDGET,
        "windows": windows, "seed": seed, "device": str(dev),
        **({"card": card()} if cuda else {}),
        "note": ("one continuous stream through runner.scan_video_jit "
                 "(the state carried, a refresh prolog at the validated "
                 "cadence); windows made on the host before their timed "
                 "span; cb_fps by CUDA events around each window's "
                 "replays; per-window GT-mIoU of both paths and device "
                 "memory: drift or a leak would show as a trend across "
                 "windows"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--win", type=int, default=8)
    ap.add_argument("--seed", type=int, default=424242)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    H, W, T = args.h, args.w, args.t
    wl = zoo.load("scene", (H, W, 3), zoo.default_pipeline_config(
        args.device), width=args.width_mult)
    cadence, _ = zoo.load_refresh_cadence("scene", T, H, W)
    rec = longrun(wl.net, wl.params, wl.taus, cadence, H, W, T,
                  args.chunks, args.win, args.seed,
                  zoo.output_stride(wl, H, W),
                  log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out", "LONGRUN_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "windows"}),
          flush=True)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
