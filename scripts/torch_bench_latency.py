#!/usr/bin/env python3
"""Single-frame deployment latency per workload with the PyTorch port (the
twin of ``scripts/bench_latency.py``).

    python3 scripts/torch_bench_latency.py [model ...] [--frames 96]
        [--pipe-k 64] [--windows 7]
        [--h 720] [--w 1280] [--device cuda|cpu] [--width-mult N]
        [--out PATH]

A live camera hands over one frame at a time: ``runner.FrameStepper``
steps each in one dispatch (a replay of a captured CUDA graph on the
card), its state carried, the dense refresh at the validated cadence
(``zoo.load_refresh_cadence``; interval = cadence x T, T 12 for the pose
workloads, else 32), no stats (the deployment form), the class-map
workloads' argmax to uint8 inside. Frames are on the device before any
timing. Per model (default ``scene seg pose pose_graph``):

  wall_ms_p50/p95      host wall time of one call and its sync, as a live
                       caller sees it, over ``--frames`` steady frames
                       (a refresh frame is stepped untimed)
  device_ms_pipelined  K = 64 (--pipe-k) one-frame dispatches enqueued
                       back to back, CUDA events around the window, in 7
                       (--windows) windows; the
                       median of window / K (a window about to cross a
                       refresh first steps that frame untimed)
  dense_ms_pipelined   the same protocol on the dense network (one
                       graphed dense forward a frame, K / 4 a window);
                       live_speedup_vs_dense = dense / CB
  device_ms_chunkK     FrameStepper.step_chunk: K = 4 and 8 frames a
                       dispatch, 64 / K dispatches a window
  refresh_ms_p50       host wall time of a refreshing call (a stepper
                       whose every frame refreshes), median of 5
  scan_ms_per_frame    runner.scan_video_jit over T-frame chunks (the
                       batch form), CUDA events around each replay,
                       median over the steady chunks after the first

``sync_overhead_ms`` (``benchmark.measure_sync_overhead``) is the
card's host round trip, measured and recorded: on the card there is no
tunnel between host and device, so wall time is the host's dispatch plus
the device's work, and nothing is subtracted from it. On the CPU every
time is the host's.

Writes LATENCY.json's keys (plus the device and the card's name and
power limit) to ``--out``, default ``chiprun_out/LATENCY_torch.json``;
the reference's file is never written.
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
from cbinfer_tpu_torch.benchmark import (card, device_ms,  # noqa: E402
                                         measure_sync_overhead, scalar_sync)
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import (FrameStepper, _Graphs,  # noqa: E402
                                      scan_video_jit)
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

MODELS = ("scene", "seg", "pose", "pose_graph")
WARM = 8
PIPE_K = 64           # one-frame dispatches per pipelined window
PIPE_WINDOWS = 7
REFRESH_SAMPLES = 5
SCAN_CHUNKS = 3       # T-frame chunks of the scan form (the first warms)


def _sync(dev, y):
    if dev.type == "cuda":
        torch.cuda.synchronize()
    else:
        scalar_sync(y)


def bench(name, H=720, W=1280, frames=96, device="cuda", width=None,
          pipe_k=PIPE_K, windows=PIPE_WINDOWS, log=print):
    """One model's row (the module docstring's fields)."""
    dev = resolve_device(device)
    wl = zoo.load(name, (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    net, params = wl.net, wl.params
    T = 12 if name.startswith("pose") else 32
    cadence, _ = zoo.load_refresh_cadence(name, T, H, W)
    interval = cadence * T
    out_map = None
    if wl.metric == "miou":
        def out_map(y):
            return y.argmax(-1).to(torch.uint8)
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=17,
        distinct_classes=name.startswith("pose"),
        **workload_video_kwargs(name)))
    n = max(WARM + frames, SCAN_CHUNKS * T)
    clip = torch.from_numpy(video.clip(n)).to(dev)
    scalar_sync(clip)

    def frame(i):
        return clip[i % n]

    def stepper(refresh_every=interval):
        return FrameStepper(net, params, thresholds=wl.taus,
                            refresh_every=refresh_every, out_map=out_map,
                            collect_stats=False)

    with torch.no_grad():
        # cold start and warm-up: both graphs (refresh, steady) captured
        st = stepper()
        for t in range(WARM):
            y, _ = st(frame(t))
        _sync(dev, y)

        # live caller: one blocking call per frame
        wall = []
        for t in range(WARM, WARM + frames):
            refresh = st._since_refresh + 1 > interval
            t0 = time.perf_counter()
            y, _ = st(frame(t))
            _sync(dev, y)
            if not refresh:
                wall.append((time.perf_counter() - t0) * 1e3)

        # pipelined: K one-frame dispatches, events around the window
        fi = WARM + frames

        def window(fn, k):
            nonlocal fi
            base = fi
            fi += k
            return device_ms(lambda: [fn(frame(base + j))
                                      for j in range(k)], dev) / k

        pipe = []
        for _ in range(windows):
            if st._since_refresh + pipe_k >= interval:
                y, _ = st(frame(fi))  # the refresh, untimed
                fi += 1
            pipe.append(window(st, pipe_k))

        # the dense network, the same protocol
        dense = _Graphs(1)

        def dense_frame(fs):
            y = net.apply_dense(params, fs[0])
            return y if out_map is None else out_map(y)

        def dense_step(f):
            return dense.run(("dense",), dense_frame, f[None])

        _sync(dev, dense_step(frame(0)))
        dpipe = [window(dense_step, max(1, pipe_k // 4))
                 for _ in range(windows)]

        # micro-batches: step_chunk of K frames a dispatch
        micro = {}
        for K in (4, 8):
            mb = stepper()
            nwin = max(1, pipe_k // K)

            def stack(i):
                j = (i * K) % (n - K)
                return clip[j:j + K]

            mb.step_chunk(stack(0))
            ys, _ = mb.step_chunk(stack(1))
            _sync(dev, ys)
            si = 2
            vals = []
            for _ in range(windows):
                if mb._since_refresh + nwin * K >= interval:
                    mb.step_chunk(stack(si))  # the refresh, untimed
                    si += 1
                base = si
                si += nwin
                vals.append(device_ms(lambda: [
                    mb.step_chunk(stack(base + j)) for j in range(nwin)],
                    dev) / (nwin * K))
            micro[f"device_ms_chunk{K}"] = float(np.median(vals))
            del mb

        # the refresh: a stepper whose every frame refreshes
        rs = stepper(refresh_every=1)
        _sync(dev, rs(frame(0))[0])
        refresh_wall = []
        for i in range(REFRESH_SAMPLES):
            t0 = time.perf_counter()
            y, _ = rs(frame(i + 1))
            _sync(dev, y)
            refresh_wall.append((time.perf_counter() - t0) * 1e3)
        del rs

        # the batch form: scan_video_jit over T-frame chunks
        run = scan_video_jit(net)
        state = net.init_state()
        kw = dict(thresholds=wl.taus, collect_stats=False, out_map=out_map)
        run(params, clip[:T], state, refresh_start=True, **kw)
        run(params, clip[:T], state, refresh_start=False, **kw)
        scan = [device_ms(lambda: run(params, clip[c * T:(c + 1) * T],
                                      state, refresh_start=False, **kw),
                          dev) / T for c in range(1, SCAN_CHUNKS)]

    wall = np.asarray(wall)
    cb_pipe, dn_pipe = float(np.median(pipe)), float(np.median(dpipe))
    row = {
        "model": name, "resolution": f"{H}x{W}",
        "frames": int(wall.size), "refresh_interval_frames": interval,
        "wall_ms_p50": float(np.percentile(wall, 50)),
        "wall_ms_p95": float(np.percentile(wall, 95)),
        "device_ms_pipelined": cb_pipe, "dense_ms_pipelined": dn_pipe,
        "live_speedup_vs_dense": dn_pipe / cb_pipe,
        "live_form": "collect_stats=False", **micro,
        "refresh_ms_p50": float(np.median(refresh_wall)),
        "scan_ms_per_frame": float(np.median(scan)),
        "weights": wl.weights, "tau_source": wl.tau_source,
        "output_form": "argmax_u8" if out_map is not None else "logits",
        "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
    }
    log(json.dumps(row))
    return row


def measure(models=MODELS, H=720, W=1280, frames=96, device="cuda",
            width=None, pipe_k=PIPE_K, windows=PIPE_WINDOWS, log=print):
    """LATENCY.json's record over ``models``."""
    dev = resolve_device(device)
    sync_ms = measure_sync_overhead(device=dev) * 1e3
    rows = []
    for m in models:
        rows.append(bench(m, H, W, frames, device, width, pipe_k, windows,
                          log))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"sync_overhead_ms": sync_ms, "rows": rows,
            "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {}),
            "note": (
                "Per-frame FrameStepper latency (one graph replay a frame, "
                "caches carried, refresh at the validated cadence). "
                "wall_ms is host wall time a call plus its sync: on the "
                "card no tunnel lies between host and device, "
                "sync_overhead_ms is the measured host round trip and "
                "nothing is subtracted. device_ms_pipelined times a window "
                f"of {pipe_k} one-frame dispatches by CUDA events; "
                "device_ms_chunkK is FrameStepper.step_chunk (K frames a "
                "dispatch, K-1 frames of added capture latency); "
                "refresh_ms_p50 the wall time of a refreshing call; "
                "scan_ms_per_frame runner.scan_video_jit's replays of "
                "T-frame chunks, measured here.")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("models", nargs="*", default=list(MODELS))
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--pipe-k", type=int, default=PIPE_K)
    ap.add_argument("--windows", type=int, default=PIPE_WINDOWS)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = measure(args.models, args.h, args.w, args.frames, args.device,
                  args.width_mult, args.pipe_k, args.windows,
                  log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out", "LATENCY_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
