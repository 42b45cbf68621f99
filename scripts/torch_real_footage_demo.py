#!/usr/bin/env python3
"""File-ingested footage through the flagship with the PyTorch port (the
twin of ``scripts/real_footage_demo.py``).

    python3 scripts/torch_real_footage_demo.py [--frames 96] [--keep]
        [--h 720] [--w 1280] [--device cuda|cpu] [--width-mult N]
        [--out PATH]

1. The native frame generator (``data.NativeSpriteVideo``, the C++
   ``framegen.cpp``; the numpy ``SpriteVideo`` where g++ is missing, and
   the record says which) makes a 720p clip,
2. ``fileio.write_y4m`` writes it to a real YUV4MPEG2 container (C444,
   8-bit) under ``build/footage/`` (deleted unless ``--keep``),
3. ``fileio.open_video`` reads the FILE back, and its chunks of 32 stream
   through the scene flagship (``zoo.load``: trained weights, tuned taus)
   under the deployment policy: ``runner.scan_video_jit`` with a refresh
   prolog at the validated cadence, argmax to uint8 inside; dense on the
   same decoded frames as one captured graph of the frame loop. Both are
   timed in one pass over the chunks by CUDA events around the replays
   (after an untimed pass that warms every graph), and
4. ``cli.main --video <file> --frames 8 --json`` runs the user's command
   on the same file.

The file carries no labels, so accuracy is CB's agreement with the dense
network on the same decoded frames (mIoU of the class maps), as the
reference records it. Writes REALFOOTAGE.json's keys (plus the device and
the card's name and power limit) to ``--out``, default
``chiprun_out/REALFOOTAGE_torch.json``; the reference's file is never
written.
"""

import argparse
import contextlib
import io
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
                                         scalar_sync)
from cbinfer_tpu_torch.data import (NativeSpriteVideo,  # noqa: E402
                                    native_available)
from cbinfer_tpu_torch.fileio import open_video, write_y4m  # noqa: E402
from cbinfer_tpu_torch.metrics import _np, miou_labels  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import _Graphs, scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig)

T = 32


def demo(n_frames=96, H=720, W=1280, device="cuda", width=None,
         keep=False, log=print):
    """REALFOOTAGE.json's record (the module docstring's steps)."""
    dev = resolve_device(device)
    n_frames = max(T, (n_frames // T) * T)
    path = os.path.join(REPO, "build", "footage", "real_footage.y4m")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # 1-2: native generation into a real container
    t0 = time.time()
    vcfg = SpriteVideoConfig(height=H, width=W, n_sprites=4, sprite_size=48,
                             speed=4.0, noise_std=0.002, seed=31)
    if native_available():
        gen, gen_kind = NativeSpriteVideo(vcfg), "native(framegen.cpp)"
    else:
        gen, gen_kind = SpriteVideo(vcfg), "numpy-fallback"
    write_y4m(path, gen.frames(n_frames), fps=30)
    gen_s = time.time() - t0
    size_mb = os.path.getsize(path) / 1e6

    # 3: the FILE read back and streamed through the flagship
    wl = zoo.load("scene", (H, W, 3), zoo.default_pipeline_config(device),
                  width=width)
    net, params = wl.net, wl.params
    cadence, cad_src = zoo.load_refresh_cadence("scene", T, H, W)
    video = open_video(path)
    t0 = time.time()
    chunks = [torch.from_numpy(video.clip(T)).to(dev)
              for _ in range(n_frames // T)]
    decode_s = time.time() - t0
    video.close()
    for c in chunks:
        scalar_sync(c)

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)

    with torch.no_grad():
        run = scan_video_jit(net)
        state = net.init_state()
        kw = dict(thresholds=wl.taus, collect_stats=False, out_map=out_u8)
        dense = _Graphs(1)

        def cb_pass(maps):
            for i, c in enumerate(chunks):
                maps.append(run(params, c, state,
                                refresh_start=i % max(1, cadence) == 0,
                                **kw)[0])

        def dense_pass(maps):
            maps.extend(dense.run(("dense",), lambda fs: torch.stack(
                [out_u8(net.apply_dense(params, f)) for f in fs]), c)
                for c in chunks)

        # untimed warm pass: both CB keys and the dense graph captured
        cb_pass([])
        run(params, chunks[0], state, refresh_start=False, **kw)
        dense_pass([])
        cb_maps, dn_maps = [], []
        cb_ms = device_ms(lambda: cb_pass(cb_maps), dev)
        dn_ms = device_ms(lambda: dense_pass(dn_maps), dev)
    cb_fps, dn_fps = n_frames / (cb_ms / 1e3), n_frames / (dn_ms / 1e3)
    agree = float(np.mean([miou_labels(_np(a), _np(b), 8)
                           for a, b in zip(cb_maps, dn_maps)]))

    # 4: the user's command on the same file
    from cbinfer_tpu_torch.cli import main as cli_main
    buf = io.StringIO()
    argv = ["--video", path, "--model", "scene", "--frames", "8", "--json",
            "--device", device]
    if width is not None:
        argv += ["--width-mult", str(width)]
    else:
        argv += ["--width-mult", "128"]
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    cli_out = json.loads(buf.getvalue().strip().splitlines()[0])
    if not keep:
        os.remove(path)
    out = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "file": {"path": os.path.relpath(path, REPO),
                 "container": "YUV4MPEG2 C444 8-bit",
                 "frames": n_frames, "size_mb": size_mb,
                 "generator": gen_kind, "generate_s": gen_s,
                 "decode_s": decode_s,
                 "decode_fps_host": n_frames / decode_s},
        "cb_fps": cb_fps, "dense_fps": dn_fps, "speedup": cb_fps / dn_fps,
        "agreement_miou_vs_dense": agree,
        "refresh_cadence_chunks": cadence, "cadence_source": cad_src,
        "taus": [float(t) for t in wl.taus], "weights": wl.weights,
        "cli": cli_out, "device": str(dev),
        **({"card": card()} if dev.type == "cuda" else {}),
        "note": ("8-bit YUV quantization (~0.005 a channel) sits above the "
                 "sensor-noise floor and below every deployed tau; fps by "
                 "CUDA events around one pass of graph replays over the "
                 "decoded chunks"),
    }
    log(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = demo(args.frames, args.h, args.w, args.device, args.width_mult,
               args.keep, log=lambda m: print(m, flush=True))
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   "REALFOOTAGE_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
