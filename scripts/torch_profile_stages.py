#!/usr/bin/env python3
"""Per-layer and per-stage time on the card with the PyTorch port (the
twin of ``scripts/profile_stages.py``).

    python3 scripts/torch_profile_stages.py [--model scene] [--h 720]
        [--w 1280] [--frames 32] [--chunks 2] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

The workload of ``zoo.load`` (trained weights, tuned taus, the deployed
flagship specs; a sequential net: a DAG has no prefixes) cut into the
prefix nets ``specs[:k]``, k = 1 .. L, each converted with its share of
the tau vector. Two views, as the reference's docstring sets out:

1. Layer-prefix deltas: the CB scan (``runner.scan_video_jit``, a
   refresh prolog on an untimed warm-up clip, then steady chunks) and the
   dense frame loop (one captured graph) over each prefix; layer k's cost
   is t(k) - t(k-1). Each frame emits one row-slice sum, never its wide
   feature map.
2. Stage isolation: the same CB prefixes with the compute kernels (the
   tile conv, the stem conv, the delta pool) replaced by a no-op that
   writes nothing back, so ``detect_ms_*`` is detect, compaction and glue
   and ``compute_ms_* = cb - detect`` the gather/GEMM/scatter stage.

Times are device times of the replays (CUDA events around each pass over
``--chunks`` distinct clips of T frames), per frame; on the CPU the
host's. Writes PROFILE.json's keys (plus the detect-only columns, the
device and the card's name and power limit) to ``--out``, default
``chiprun_out/PROFILE_torch.json``; the reference's file is never
written.
"""

import argparse
import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch import layers, zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import (card, device_ms,  # noqa: E402
                                         measure_sync_overhead, scalar_sync)
from cbinfer_tpu_torch.convert import convert, num_cb_layers  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

COMPUTE_KERNELS = ("delta_conv", "stem_conv", "delta_pool")


def _no_write(*args, **kwargs):
    return None


@contextlib.contextmanager
def detect_only():
    """The compute kernels of ``layers`` replaced by a no-op (view 2)."""
    saved = {k: getattr(layers, k) for k in COMPUTE_KERNELS}
    try:
        for k in COMPUTE_KERNELS:
            setattr(layers, k, _no_write)
        yield
    finally:
        for k, v in saved.items():
            setattr(layers, k, v)


def _row_sum(y):
    return y[-1, :, 0].float().sum()


def time_prefix(net, params, taus, warm, chunks, dense=True):
    """(CB ms, dense ms or None) per frame of one prefix net."""
    dev = warm.device
    frames = sum(int(c.shape[0]) for c in chunks)
    run = scan_video_jit(net)
    state = net.init_state()
    kw = dict(thresholds=taus, collect_stats=False, out_map=_row_sum)
    scalar_sync(run(params, warm, state, refresh_start=True, **kw)[0])
    scalar_sync(run(params, warm, state, **kw)[0])
    cb = device_ms(lambda: [run(params, c, state, **kw) for c in chunks],
                   dev) / frames
    if not dense:
        return cb, None
    graphs = _Graphs(1)

    def dense_chunk(fs):
        return graphs.run(("dense",), lambda x: torch.stack(
            [_row_sum(net.apply_dense(params, f)) for f in x]), fs)

    scalar_sync(dense_chunk(warm))
    dn = device_ms(lambda: [dense_chunk(c) for c in chunks], dev) / frames
    return cb, dn


def profile(model="scene", H=720, W=1280, T=32, n_chunks=2, device="cuda",
            width=None, log=print):
    """PROFILE.json's record (the module docstring's views)."""
    dev = resolve_device(device)
    wl = zoo.load(model, (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    if wl.kind != "sequential":
        raise ValueError(f"{model}: a DAG has no layer prefixes")
    specs, cfg = wl.net.specs, wl.net.cfg
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=0))
    warm = torch.from_numpy(video.clip(T)).to(dev)
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_chunks)]
    sync_overhead = measure_sync_overhead(device=dev)
    rows = []
    prev = {"cb": 0.0, "dense": 0.0, "detect": 0.0}
    with torch.no_grad():
        for k in range(1, len(specs) + 1):
            sub = specs[:k]
            taus = wl.taus[:num_cb_layers(sub)]
            net = convert(sub, (H, W, 3), cfg, thresholds=taus)
            p = wl.params[:k]
            cb, dn = time_prefix(net, p, taus, warm, chunks)
            with detect_only():
                det, _ = time_prefix(net, p, taus, warm, chunks,
                                     dense=False)
            row = {"k": k, "layer": type(specs[k - 1]).__name__,
                   "spec": str(specs[k - 1]),
                   "cb_ms_total": cb, "dense_ms_total": dn,
                   "cb_ms_layer": cb - prev["cb"],
                   "dense_ms_layer": dn - prev["dense"],
                   "detect_ms_total": det,
                   "detect_ms_layer": det - prev["detect"],
                   "compute_ms_total": cb - det,
                   "compute_ms_layer": (cb - det) - (prev["cb"]
                                                     - prev["detect"])}
            prev = {"cb": cb, "dense": dn, "detect": det}
            rows.append(row)
            log(f"prefix {k:2d} {row['layer']:<10} cb "
                f"{row['cb_ms_layer']:7.4f} ms  dense "
                f"{row['dense_ms_layer']:7.4f} ms  detect "
                f"{row['detect_ms_layer']:7.4f} ms  (totals "
                f"{cb:7.4f} / {dn:7.4f} / {det:7.4f})")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return {"shape": [H, W], "frames": n_chunks * T, "model": model,
            "weights": wl.weights, "backend": cfg.backend,
            "stem": getattr(specs[0], "backend", None) or "cb",
            "tau_source": wl.tau_source,
            "thresholds": [float(t) for t in wl.taus],
            "sync_overhead_ms": 1e3 * sync_overhead, "rows": rows,
            "detect_only": ("view 2: " + ", ".join(COMPUTE_KERNELS)
                            + " replaced by a no-op in the CB prefixes"),
            "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="scene")
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = profile(args.model, args.h, args.w, args.frames, args.chunks,
                  args.device, args.width_mult,
                  log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out", "PROFILE_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
