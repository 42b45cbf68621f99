#!/usr/bin/env python3
"""Measured per-layer backend policy with the PyTorch port (the twin of
``scripts/optimize_policy.py``).

    python3 scripts/torch_optimize_policy.py [scene|seg|pose|pose_graph|...]
        [--h 720] [--w 1280] [--frames 32] [--chunks 3] [--reps 3]
        [--min-gain 0.03] [--max-layers N] [--seed 0]
        [--device cuda|cpu] [--width-mult N] [--out PATH]

Decides per-layer backend flips end to end, on the WHOLE network's
steady-state fps. First the stem form: the ``band_cached`` stem (full-width
row bands recomputed from the accepted cache) against the flagship's stem.
Then greedily over the CB convs the flagship leaves on the default
backend, deepest first, two modes each: ``dense_cached`` (no sparse
machinery, everything recomputed from the accepted cache) and
``forward_hint`` (no detect; the producer's hint region recomputed). A
flip is accepted iff its fps beats the current pick's by ``--min-gain``.
Every mode is a value-exact superset of the CB recompute from the same
accepted cache, so the tuned taus stay valid.

Measurement: each trial builds both networks (the current pick and the
trial), warms them (the eager first call and the CUDA graph capture of
both refresh keys, ``runner.scan_video_jit``), then times ``--reps``
windows per network, each a pass over the same ``--chunks`` distinct
T-frame chunks (a refresh prolog on every other chunk, the deployment
cadence; the card replays every one, nothing is memoized), in alternating
order (A B, B A, ...) with CUDA events around each window's replays; the
median window decides. Each arm runs the garbage collector once it is
warm, and the collector stays off inside a window (so no earlier arm's
graphs are freed there); a device-side sleep of about 50 ms keeps the card
busy while the host enqueues the window, so the events bracket the card's
work and not a stall of the shared host. On the CPU the windows are timed by the host clock (the
plain versions: meaningful for the flow only). Every six trials the empty
policy is re-measured alone, and a drift of more than 30% from the
phase-start baseline aborts without writing; the final pick is re-measured
against the empty policy on fresh clips and dropped if it does not
reproduce. The clips come from ``--seed``, and the record names it.

Writes the record (the keys of ``POLICY_<model>.json``, plus every trial's
verdict, the device and the card's name and power limit) to ``--out``,
default ``chiprun_out/POLICY_<model>_torch.json``. The shipped
``POLICY_*.json``, which ``zoo.load`` reads, are never written.
Sequential models key overrides by spec index, pose_graph by node name.
"""

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import zoo  # noqa: E402
from cbinfer_tpu_torch.benchmark import card  # noqa: E402
from cbinfer_tpu_torch.config import ConvSpec  # noqa: E402
from cbinfer_tpu_torch.convert import convert_flagship  # noqa: E402
from cbinfer_tpu_torch.network import resolve_device  # noqa: E402
from cbinfer_tpu_torch.runner import scan_video_jit  # noqa: E402
from cbinfer_tpu_torch.video import (SpriteVideo,  # noqa: E402
                                     SpriteVideoConfig, workload_video_kwargs)

SANITY_EVERY = 6      # trials between re-measures of the empty policy
SLEEP_CYCLES = 100_000_000   # ~50 ms of card time ahead of each window
MODES = ("dense_cached", "forward_hint")


class Arm:
    """One network of a comparison: built, warmed (both refresh keys
    captured on the warm clip), and timed one window at a time."""

    def __init__(self, net, params, taus, warm):
        self.net, self.params, self.taus = net, params, taus
        self.cuda = torch.device(net.cfg.device).type == "cuda"
        self.run = scan_video_jit(net)
        self.state = net.init_state()
        for refresh in (True, False):
            self._chunk(warm, refresh)
        self.sync()
        gc.collect()

    def _chunk(self, frames, refresh):
        return self.run(self.params, frames, self.state, thresholds=self.taus,
                        collect_stats=False, refresh_start=refresh)[0]

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def window(self, clips) -> float:
        """fps of one window: ``clips`` replayed in order, a refresh
        prolog on every other chunk."""
        frames = sum(int(c.shape[0]) for c in clips)
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            gc_on = gc.isenabled()
            gc.disable()
            try:
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                for i, c in enumerate(clips):
                    self._chunk(c, i % 2 == 0)
                end.record()
            finally:
                if gc_on:
                    gc.enable()
            end.synchronize()
            return frames / (start.elapsed_time(end) / 1e3)
        t0 = time.perf_counter()
        for i, c in enumerate(clips):
            self._chunk(c, i % 2 == 0)
        return frames / max(1e-9, time.perf_counter() - t0)


def optimize(model, H=720, W=1280, T=32, chunks=3, reps=3, min_gain=0.03,
             max_layers=None, seed=0, device="cuda", width=None, log=print):
    """The stem trial, the greedy flips and the final re-measure; returns
    the record."""
    dev = resolve_device(device)
    # the deployment's configuration (capacity 0.375): the regime the
    # tuned taus and the policy serve in
    cfg = zoo.default_pipeline_config(device)
    # apply_policy=False: this is what writes the policy
    wl = zoo.load(model, (H, W, 3), cfg, apply_policy=False, width=width)
    for msg in wl.warnings:
        log(f"WARNING: {msg}")
    params, base_net, taus = wl.params, wl.net, wl.taus
    if wl.kind == "graph":
        from cbinfer_tpu_torch.graph import convert_graph_flagship

        def make_net(extra):
            return convert_graph_flagship(
                wl.specs, (H, W, 3), cfg, output=base_net.output,
                extra_overrides=extra or None)
        convs = [n.name for n in reversed(base_net.nodes)
                 if isinstance(n.spec, ConvSpec) and n.spec.use_cb
                 and n.spec.backend is None]
        stem_key = base_net.nodes[0].name
    else:
        def make_net(extra):
            return convert_flagship(wl.specs, (H, W, 3), cfg,
                                    extra_overrides=extra or None)
        convs = sorted((i for i, s in enumerate(base_net.specs)
                        if isinstance(s, ConvSpec) and s.use_cb
                        and s.backend is None), reverse=True)
        stem_key = 0
    if max_layers is not None:
        convs = convs[:max_layers]
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=max(8, 48 * H // 720),
        speed=4.0, noise_std=0.002, seed=seed,
        distinct_classes=model.startswith("pose"),
        **workload_video_kwargs(model)))
    warm = torch.from_numpy(video.clip(T)).to(dev)

    def clip_sets():
        clips = [torch.from_numpy(video.clip(T)).to(dev)
                 for _ in range(chunks)]
        return [clips] * reps

    sets = clip_sets()

    def arm(extra):
        return Arm(make_net(extra), params, taus, warm)

    def release():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def measure_pair(extra_a, extra_b, clip_sets_):
        """Median fps of two networks over windows in alternating order,
        and each network's windows."""
        a, b = arm(extra_a), arm(extra_b)
        fa, fb = [], []
        for r, clips in enumerate(clip_sets_):
            for x, out in ((a, fa), (b, fb))[::1 if r % 2 == 0 else -1]:
                out.append(x.window(clips))
        del a, b
        release()
        return float(np.median(fa)), float(np.median(fb)), fa, fb

    def measure_one(extra, clip_sets_):
        a = arm(extra)
        fs = [a.window(c) for c in clip_sets_]
        del a
        release()
        return float(np.median(fs)), fs

    base_fps, base_windows = measure_one({}, sets)
    log(f"{model} {H}x{W}: flagship baseline {base_fps:.1f} fps "
        f"({len(convs)} candidate layers)")
    trials, sanity = [], []
    accepted, best = {}, base_fps

    def trial(key, mode):
        nonlocal accepted, best
        cand = {**accepted, key: mode}
        f_cur, f_new, w_cur, w_new = measure_pair(accepted, cand, sets)
        verdict = f_new > f_cur * (1 + min_gain)
        trials.append({"key": str(key), "mode": mode, "fps": f_new,
                       "current_fps": f_cur, "accepted": verdict,
                       "fps_windows": w_new, "current_fps_windows": w_cur})
        log(f"  {key} -> {mode}: {f_new:.1f} fps against {f_cur:.1f} "
            f"({'ACCEPT' if verdict else 'reject'})")
        if verdict:
            accepted, best = cand, f_new

    def assert_chip_sane(tag):
        b, windows = measure_one({}, sets)
        if not 0.7 * base_fps <= b <= 1.45 * base_fps:
            raise RuntimeError(
                f"ABORT {tag}: baseline re-measure {b:.1f} fps is >30% off "
                f"the phase-start baseline {base_fps:.1f} (windows "
                f"{[round(w, 1) for w in windows]} against "
                f"{[round(w, 1) for w in base_windows]}; no policy "
                "written)")
        sanity.append({"after": tag, "fps": b, "fps_windows": windows})

    # the stem form first: an independent knob, the largest single cost
    trial(stem_key, "band_cached")
    n = 0
    for k in convs:
        for mode in MODES:
            trial(k, mode)
            n += 1
            if n % SANITY_EVERY == 0:
                assert_chip_sane(f"mid-greedy (after layer {k})")

    # the pick re-measured against the empty policy on fresh clips: the
    # greedy's "best" rode whatever noise survived its medians
    final_fps, base2 = best, base_fps
    if accepted:
        sets2 = clip_sets()
        base2, final_fps, _, _ = measure_pair({}, accepted, sets2)
        if not 0.5 * base_fps <= base2 <= 2.0 * base_fps:
            raise RuntimeError(
                f"ABORT final re-measure: fresh-clip baseline {base2:.1f} "
                f"fps is >2x off the greedy-phase baseline {base_fps:.1f} "
                "(no policy written)")
        if final_fps <= base2:
            log(f"  re-measure: {final_fps:.1f} <= baseline {base2:.1f} "
                "fps: the pick does not reproduce, empty policy")
            accepted, final_fps = {}, base2
    return {"model": model, "shape": [H, W], "frames_per_chunk": T,
            "chunks": chunks, "reps": reps, "backend": cfg.backend,
            "capacity_fraction": cfg.tile.capacity_fraction,
            "tau_source": wl.tau_source, "seed": seed,
            "baseline_fps": base2, "final_fps": final_fps,
            "greedy_fps": {"baseline": base_fps, "best": best,
                           "baseline_windows": base_windows},
            "sanity": sanity,
            "gain": final_fps / max(1e-9, base2),
            "overrides": {str(k): v for k, v in accepted.items()},
            "trials": trials, "min_gain": min_gain, "weights": wl.weights,
            "dtype": cfg.cache_dtype, "device": str(dev),
            **({"card": card()} if dev.type == "cuda" else {})}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default="pose",
                    choices=tuple(zoo.names()))
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-gain", type=float, default=0.03)
    ap.add_argument("--max-layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--width-mult", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = optimize(args.model, args.h, args.w, args.frames, args.chunks,
                   args.reps, args.min_gain, args.max_layers, args.seed,
                   args.device, args.width_mult)
    print(json.dumps(rec), flush=True)
    out = args.out or os.path.join(REPO, "chiprun_out",
                                   f"POLICY_{args.model}_torch.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
