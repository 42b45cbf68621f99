"""Command-line runner (console script ``cbinfer-torch``): convert a model,
optionally tune its thresholds, stream synthetic or file video through it
on the card, and report the accuracy against the dense network and the
effective-FLOP reduction.

Examples:
  cbinfer-torch --model scene --height 360 --width 640 --frames 32
  cbinfer-torch --model scene --width-mult 128 --height 720 --width 1280 \\
      --bf16 --tune --budget 0.005 --live 1
  cbinfer-torch --video cam.y4m --model scene   # real footage
  cbinfer-torch --device cpu --height 64 --width 128   # the plain versions

It runs on the card unless ``--device cpu`` is given, and raises without
CUDA otherwise.
"""

import argparse
import functools
import json
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="scene")
    ap.add_argument("--width-mult", type=int, default=64,
                    help="model channel width")
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--tau", type=float, default=0.04)
    ap.add_argument("--tile", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: the hand-written kernels (default); cpu: "
                         "their plain PyTorch versions")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--stem",
                    choices=("flagship", "dense_cached", "dense", "cb"),
                    default="flagship",
                    help="layer-0 mode: flagship (convert.flagship_layers: "
                         "the sparse patch_stem stem where its gate holds, "
                         "else dense_cached), dense_cached (full-map detect "
                         "and a dense conv from the accepted cache), dense "
                         "(recomputed every frame, no hint), cb (the "
                         "kernel delta path)")
    ap.add_argument("--tune", action="store_true",
                    help="run the threshold auto-tuner first")
    ap.add_argument("--budget", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--video", default=None, metavar="PATH",
                    help="real footage instead of synthetic sprites: .y4m "
                         "(uncompressed YUV4MPEG2: `ffmpeg -i in.mp4 "
                         "out.y4m`) or a .npy/.npz (T,H,W,3) clip; "
                         "--height/--width are taken from the file")
    ap.add_argument("--live", type=int, nargs="?", const=1, default=None,
                    metavar="K",
                    help="live streaming mode (runner.FrameStepper): one "
                         "CUDA-graph replay per frame (K=1) or per K-frame "
                         "chunk (step_chunk: K-1 frames of added latency "
                         "for the per-call overhead / K). Reports wall "
                         "ms/frame beside the scan-form results")
    ap.add_argument("--json", action="store_true", help="JSON-only output")
    args = ap.parse_args(argv)

    import torch

    from .config import PipelineConfig, TileConfig
    from .convert import convert, flagship_layers, num_cb_layers
    from .metrics import (_np, effective_flops, miou, miou_device, pck,
                          pck_device)
    from .models import get_model
    from .network import init_params, resolve_device, torch_dtype
    from .profiling import summarize_stats
    from .runner import FrameStepper, scan_video
    from .tuner import tune
    from .video import SpriteVideo, SpriteVideoConfig

    device = resolve_device(args.device)  # raises without CUDA
    dtype = "bfloat16" if args.bf16 else "float32"
    # pose_cnn has a fixed two-branch head (PAF + heatmap), no num_classes
    specs = (get_model(args.model, width=args.width_mult)
             if args.model == "pose" else
             get_model(args.model, num_classes=args.classes,
                       width=args.width_mult))
    cfg = PipelineConfig(tile=TileConfig(args.tile, args.tile),
                         backend="cuda", compute_dtype=dtype,
                         cache_dtype=dtype, device=args.device)
    if args.video:
        from .fileio import open_video
        video = open_video(args.video, loop=True)
        args.height, args.width = video.height, video.width
    else:
        video = SpriteVideo(SpriteVideoConfig(
            height=args.height, width=args.width, n_sprites=4,
            sprite_size=max(16, args.height // 15), speed=4.0,
            noise_std=0.002, seed=args.seed))
    in_shape = (args.height, args.width, 3)
    net = convert(specs, in_shape, cfg,
                  dense_layers=[0] if args.stem == "dense" else [],
                  backend_overrides=(
                      {0: "dense_cached"} if args.stem == "dense_cached"
                      else flagship_layers(specs, in_shape, cfg)[0]
                      if args.stem == "flagship" else None))
    params = init_params(specs, in_shape, args.seed, device,
                         torch_dtype(dtype))
    clip = torch.from_numpy(video.clip(args.frames)).to(device)

    taus = [args.tau] * num_cb_layers(net.specs)
    # pose outputs PAF + heatmap channels: keypoint PCK, not argmax mIoU
    if args.model == "pose":
        metric_fn, device_metric_fn = pck, pck_device
    else:
        metric_fn = functools.partial(miou, num_classes=args.classes)
        device_metric_fn = functools.partial(miou_device,
                                             num_classes=args.classes)
    if args.tune:
        res = tune(net, params, video.clip(max(8, args.frames // 2)),
                   metric_fn, device_metric_fn=device_metric_fn,
                   budget=args.budget)
        taus = res.thresholds
        if not args.json:
            print(f"tuned thresholds: {taus}")
            print(f"tuner metric {res.metric:.4f}, "
                  f"flop reduction {res.flop_reduction:.2f}x")

    ys, _, stats = scan_video(net, params, clip, thresholds=taus)
    dense = torch.stack([net.apply_dense(params, f) for f in clip])
    m = metric_fn(_np(ys), _np(dense))
    ef = effective_flops(stats, net.specs, in_shape, args.tile, args.tile)
    out = {
        "model": args.model, "backend": args.device,
        "miou_vs_dense": round(m, 4),
        "flop_reduction": round(ef["flop_reduction"], 2),
        "thresholds": [float(t) for t in taus],
    }
    if args.live is not None:
        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize()

        K = max(1, args.live)
        # the deployment live form: no per-frame stats (the scan above
        # reported the counters)
        stepper = FrameStepper(net, params, thresholds=taus,
                               collect_stats=False)
        n = (clip.shape[0] // K) * K
        # warm both graphs untimed: the first frame or chunk runs only the
        # refreshing one, so without a plain warm call the plain graph's
        # eager first call and capture would land in the timed window. A
        # clip too short for two warm units keeps one timed unit.
        if K == 1:
            warm_n = min(2, max(1, n - 1))
            for t in range(warm_n):
                stepper(clip[t])
            sync()
            t0 = time.perf_counter()
            for t in range(warm_n, n):
                stepper(clip[t])
            sync()
            timed = n - warm_n
        else:
            warm_c = min(2, max(1, n // K - 1))
            for c in range(warm_c):
                stepper.step_chunk(clip[c * K:(c + 1) * K])
            sync()
            t0 = time.perf_counter()
            for c in range(warm_c, n // K):
                stepper.step_chunk(clip[c * K:(c + 1) * K])
            sync()
            timed = n - warm_c * K
        if timed > 0:
            out["live_ms_per_frame"] = round(
                (time.perf_counter() - t0) * 1e3 / timed, 3)
            out["live_chunk"] = K
    print(json.dumps(out))
    if not args.json:
        print(summarize_stats(stats, net.specs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
