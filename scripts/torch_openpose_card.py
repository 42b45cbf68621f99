#!/usr/bin/env python3
"""The COCO OpenPose workload (``zoo.load("openpose")``) on the card: its
dense path against the plain reference, its tau vector and its fused-detect
decision.

    python3 scripts/torch_openpose_card.py [--phases check,tune,fuse_ab]
        [--h 368] [--w 656] [--frames 256] [--chunk 32] [--reps 3]
        [--device cuda|cpu] [--out chiprun_out/openpose_card.json]

Frames are those of the benchmark cell ``openpose.cam1`` (its ``video``
parameters, ``cbbench.frames``) at the calibration seeds 7 and 11.

- ``check``: one frame through the program's dense path
  (``CBGraphNet.apply_dense``) in bf16 (the deployment's dtypes) and in
  float32 with TF32 off, and the frame after it through the CB path at
  tau = 0 (``FrameStepper``: the tile convs recompute every changed
  tile), against ``models/openpose_reference.py`` in
  float32; beside them the reference itself with its weights and every
  layer's output rounded to bf16 and to float8 e4m3 (the precision
  below). Each reading is max |y - ref| / max |ref| over the output.
- ``tune``: taus on the tuner's grid (``tuner.tune``'s default grid),
  each vector read by the pass over each seed's ring through
  ``scan_video_jit`` in chunks of ``--chunk``, a refresh on the ring's
  first frame: the worst frame's max |CB - dense| / max |dense| over the
  output (L1 and L2 of stage 6), dense being the same runner at tau = -1
  (the tuner's dense path). First every flat tau (recorded), then part
  by part (``PARTS``, in the net's order) the largest grid tau that keeps
  the worst frame within ``BUDGET``; that vector is written as the tau
  record ``--tau-out``.
- ``fuse_ab``: the net converted with and without ``fuse_detect`` at those
  taus (0 without a tune phase), their outputs compared bit for bit and
  their passes timed in turn (``--reps`` each, CUDA-synchronised wall
  time); the policy record
  ``--policy-out`` takes ``fuse_detect`` true only if the fused net is the
  faster in every pair.

One JSON line per phase goes to standard output and to ``--out``. The
shipped ``ckpts/openpose_coco_tau.json`` and ``POLICY_openpose.json`` are
never written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

GRID = (0.01, 0.02, 0.04, 0.08, 0.16, 0.32)  # tuner.tune's default grid
BUDGET = 0.02
SEEDS = (7, 11)
CELL = "openpose.cam1"
PARTS = (("front", ("bb_",)), ("stage1", ("s1_",)),
         ("refine", ("s2_", "s3_", "s4_", "s5_", "s6_")))


def rel_gap(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y.float() - ref).abs().amax() / ref.abs().amax())


def stored_reference(weights, frame, storage: str, device):
    """The reference with its weights and each layer's output rounded to
    ``storage``; (C, H, W)."""
    from cbbench.reference import rounder
    from cbinfer_tpu_torch.models.openpose_reference import \
        OpenPoseReference
    q = rounder(storage)
    ref = OpenPoseReference({k: q(torch.from_numpy(
        np.asarray(v, np.float32))).numpy() for k, v in weights.items()},
        device)
    outs = {"input": q(frame.permute(2, 0, 1).float())}
    with torch.no_grad():
        for name, kind, _, _, _, ins in ref.layers:
            y = (torch.cat([outs[i] for i in ins], 0) if kind == "concat"
                 else ref.node(name, outs[ins[0]]))
            outs[name] = q(y)
    return outs["out"]


def ring_of(seed, n, h, w, device):
    from cbbench import frames, spec
    return frames.make_ring(spec.cell(CELL)["video"], n, seed, h, w, device)


def cfg_of(device, dtype):
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    return PipelineConfig(tile=TileConfig(8, 8, 0.375), backend="cuda",
                          compute_dtype=dtype, cache_dtype=dtype,
                          device=device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_check(args):
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.models.openpose_reference import \
        OpenPoseReference
    from cbinfer_tpu_torch.runner import FrameStepper
    weights = dict(np.load(zoo.REGISTRY["openpose"].npz))
    shape = (args.h, args.w, 3)
    frame = ring_of(SEEDS[0], 1, args.h, args.w, args.device)[0]
    ref = OpenPoseReference(weights, args.device)(frame)
    row = {"phase": "check", "shape": list(shape)}
    dt = "bfloat16" if args.device == "cuda" else "float32"
    for dtype in sorted({dt, "float32"}):
        wl = zoo.load("openpose", shape, cfg_of(args.device, dtype))
        with torch.no_grad():
            y = wl.net.apply_dense(wl.params, frame)
        row[f"dense_{dtype}"] = rel_gap(y.permute(2, 0, 1), ref)
        if dtype == dt:  # the dense path's own time, 32 frames
            with torch.no_grad():
                wl.net.apply_dense(wl.params, frame)
                sync(args.device)
                t0 = time.perf_counter()
                for _ in range(32):
                    wl.net.apply_dense(wl.params, frame)
                sync(args.device)
            row[f"dense_ms_per_frame_{dtype}"] = (
                time.perf_counter() - t0) / 32 * 1e3
        del wl
    # the tile convs: a refresh frame, then the next frame at tau = 0
    # (every tile a changed pixel reaches recomputed by B2/B6), against the
    # reference of that frame
    wl = zoo.load("openpose", shape, cfg_of(args.device, dt))
    two = ring_of(SEEDS[0], 2, args.h, args.w, args.device)
    stepper = FrameStepper(wl.net, wl.params,
                           thresholds=[0.0] * wl.net.num_cb_layers())
    with torch.no_grad():
        stepper(two[0])
        y, _ = stepper(two[1])
        row[f"cb_tau0_{dt}"] = rel_gap(
            y.permute(2, 0, 1), OpenPoseReference(weights, args.device)(
                two[1]))
    del wl, stepper
    for storage in ("bfloat16", "float8_e4m3fn"):
        row[f"reference_{storage}"] = rel_gap(
            stored_reference(weights, frame, storage, args.device), ref)
    row["ref_max"] = float(ref.abs().amax())
    return row


def run_pass(run, params, state, ring, chunk, taus):
    ys = []
    for i in range(0, ring.shape[0], chunk):
        ys.append(run(params, ring[i:i + chunk], state, thresholds=taus,
                      refresh_start=i == 0, collect_stats=False)[0])
    return torch.cat(ys)


def frame_gaps(ys, dense):
    d = (ys.float() - dense.float()).abs().flatten(1).amax(1)
    return d / dense.float().abs().flatten(1).amax(1)


def phase_tune(args):
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.runner import scan_video_jit
    shape = (args.h, args.w, 3)
    wl = zoo.load("openpose", shape, cfg_of(args.device, "bfloat16"
                                            if args.device == "cuda"
                                            else "float32"))
    n = wl.net.num_cb_layers()
    run = scan_video_jit(wl.net)
    state = wl.net.init_state()
    rings = [ring_of(s, args.frames, args.h, args.w, args.device)
             for s in SEEDS]
    dense = [run_pass(run, wl.params, state, r, args.chunk, [-1.0] * n)
             for r in rings]
    names = list(wl.net._cb_indices())

    def worst_of(taus):
        worst, ms = 0.0, []
        for r, d in zip(rings, dense):
            run_pass(run, wl.params, state, r, args.chunk, taus)
            sync(args.device)
            t0 = time.perf_counter()
            ys = run_pass(run, wl.params, state, r, args.chunk, taus)
            sync(args.device)
            ms.append((time.perf_counter() - t0) / r.shape[0] * 1e3)
            worst = max(worst, float(frame_gaps(ys, d).max()))
        return worst, ms

    flat = []
    for tau in (0.0,) + GRID:
        worst, ms = worst_of([tau] * n)
        flat.append({"tau": tau, "worst": worst, "ms_per_frame": ms})
        print(json.dumps(flat[-1]), file=sys.stderr, flush=True)
    # part by part, in the order of the net: each part's largest grid tau
    # that keeps the worst frame within the budget, the parts before it
    # at theirs and those after it at 0
    taus = [0.0] * n
    rows = []
    for part, prefixes in PARTS:
        ix = [i for i, k in enumerate(names) if k.startswith(prefixes)]
        for tau in GRID:
            trial = list(taus)
            for i in ix:
                trial[i] = tau
            worst, ms = worst_of(trial)
            rows.append({"part": part, "tau": tau, "worst": worst,
                         "ms_per_frame": ms})
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
            if worst > BUDGET:
                break
            taus = trial
    worst, ms = worst_of(taus)
    by_part = {part: sorted({taus[i] for i, k in enumerate(names)
                             if k.startswith(prefixes)})
               for part, prefixes in PARTS}
    record = {
        "thresholds": [float(np.float32(t)) for t in taus],
        "metadata": {
            "rule": (f"part by part (the front bb_*, stage 1 s1_*, stages "
                     f"2-6 s2_*-s6_*), the largest tau on the tuner's grid "
                     f"{list(GRID)} whose worst calibration frame keeps "
                     f"max|CB - dense| / max|dense| of the output (L1 and "
                     f"L2 of stage 6) <= {BUDGET}, the parts before at "
                     f"theirs and those after at 0; dense: the same runner "
                     f"at tau = -1"),
            "by_part": by_part, "reading": worst, "ms_per_frame": ms,
            "sweep": rows, "flat_sweep": flat,
            "calib": {"seeds": list(SEEDS), "cell": CELL,
                      "frames": args.frames, "chunk": args.chunk},
            "resolution": f"{args.h}x{args.w}",
            "refresh_every": args.frames,
            "weights": "ckpts/openpose_coco.npz (seeded, not trained)",
            "card": card_name()}}
    return {"phase": "tune", "by_part": by_part, "reading": worst,
            "ms_per_frame": ms, "rows": rows, "flat": flat}, record


def phase_fuse_ab(args, taus):
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.graph import convert_graph_flagship
    from cbinfer_tpu_torch.runner import scan_video_jit
    shape = (args.h, args.w, 3)
    wl = zoo.load("openpose", shape, cfg_of(args.device, "bfloat16"
                                            if args.device == "cuda"
                                            else "float32"),
                  apply_policy=False)
    n = wl.net.num_cb_layers()
    taus = [0.0] * n if taus is None else taus
    ring = ring_of(SEEDS[0], args.frames, args.h, args.w, args.device)
    arms = {}
    for fuse in (False, True):
        net = convert_graph_flagship(wl.specs, shape, wl.net.cfg,
                                     output=wl.net.output, fuse_detect=fuse)
        arms[fuse] = (net, scan_video_jit(net), net.init_state())
    fused = [x.name for x in arms[True][0].nodes
             if getattr(x.spec, "fuse_next_detect", False)]
    outs = {f: run_pass(run, wl.params, st, ring, args.chunk, taus)
            for f, (_, run, st) in arms.items()}
    same = bool(torch.equal(outs[False], outs[True]))
    times = {False: [], True: []}
    for _ in range(args.reps):
        for f in (False, True):
            _, run, st = arms[f]
            sync(args.device)
            t0 = time.perf_counter()
            run_pass(run, wl.params, st, ring, args.chunk, taus)
            sync(args.device)
            times[f].append((time.perf_counter() - t0) / ring.shape[0] * 1e3)
    faster = all(b < a for a, b in zip(times[False], times[True]))
    row = {"phase": "fuse_ab", "taus": sorted(set(taus)), "fused_nodes": fused,
           "bit_identical": same, "ms_per_frame_unfused": times[False],
           "ms_per_frame_fused": times[True], "fused_faster": faster}
    policy = {"model": "openpose", "shape": [args.h, args.w],
              "frames_per_chunk": args.chunk, "reps": args.reps,
              "backend": "cuda", "capacity_fraction": 0.375,
              "tau_source": "tuned", "seed": SEEDS[0],
              "ms_per_frame": {"unfused": times[False],
                               "fused": times[True]},
              "overrides": {}, "fuse_detect": bool(faster and same),
              "card": card_name()}
    return row, policy


def card_name() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    from cbbench.run import card
    return card()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="check,tune,fuse_ab")
    ap.add_argument("--h", type=int, default=368)
    ap.add_argument("--w", type=int, default=656)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/openpose_card.json")
    ap.add_argument("--tau-out", default="chiprun_out/openpose_coco_tau.json")
    ap.add_argument("--policy-out",
                    default="chiprun_out/POLICY_openpose.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for p in (args.out, args.tau_out, args.policy_out):
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
    phases = args.phases.split(",")
    taus = None
    with open(args.out, "a") as out:
        def emit(row):
            row["card"] = card_name()
            line = json.dumps(row)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
        if "check" in phases:
            emit(phase_check(args))
        if "tune" in phases:
            row, record = phase_tune(args)
            emit(row)
            taus = record["thresholds"]
            with open(args.tau_out, "w") as f:
                json.dump(record, f, indent=1)
        if "fuse_ab" in phases:
            row, policy = phase_fuse_ab(args, taus)
            emit(row)
            with open(args.policy_out, "w") as f:
                json.dump(policy, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
