#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cbinfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Three paths of the 720p scene network (w128, trained weights, tuned taus,
bf16 caches and compute, 8x8 tiles, capacity 0.375, T=32 chunks) are driven
through the entry points a user calls:
  flagship    zoo.load("scene"): the sparse patch_stem stem, forward-hint
              pools, kernel convs (the configuration bench.py builds)
  dense_stem  convert_flagship(..., extra_overrides={0: "dense_cached"}):
              the same with the stem recomputed densely every frame
  hintless    convert(..., dense_layers=(0, 6)): the plain converter; the
              stem runs dense, so the first pool detects the full map and
              both pools re-detect

Then the 720p pose network (w64, trained weights, tuned taus, bf16, the
graded-dynamics video of the pose profile) on three paths:
  pose          zoo.load("pose"): patch_stem stem, 13 conv pairs on the fused
                delta conv + consumer detect, forward-hint pools (the 180-row
                pool re-detects)
  pose_unfused  zoo.load("pose", apply_policy=False): the same net with every
                consumer detecting for itself, the A/B partner of pose
  pose_fwd      convert_flagship(..., extra_overrides={15, 16, 20:
                "forward_hint"}, fuse_detect=True): three 1x1 convs forward
                their producer's hint through the tile copy kernel

Then two more workloads through zoo.load, each on its own path:
  seg           zoo.load("seg"): w64, 9 CB layers (the dilated 3x3 at
                180x320x256 among them), patch_stem stem, forward-hint
                pools; the trailing nearest x4 upsample stripped and run as
                argmax, then x4 of the uint8 class map
  pose_graph    zoo.load("pose_graph"): the OpenPose DAG (graph.py), 28 CB
                nodes, the stage-2 concat (cin 312) read by both branches,
                17 fused producers; the stage-1 heads (cout 38 and 18) keep
                out caches padded to the tile conv's channel grid

Then CBinfer's own workflow: a user's torch module imported, the shipped
workload's thresholds tuned at full width, and the command line. Then the
flagship serving many 720p cameras at once (parallel.MultiStreamRunner,
frames from the native generator, data.NativeSpriteVideo), live behind
data.PrefetchingSource, over every change rate up to a panning camera,
and the multi-stream dry run. Then training on the card (train.py through
scripts/torch_train.py's recipes), the freshly trained scene net served
at 720p, and the benchmark module (benchmark.bench_network). Then the
other layer backends (band_cached, dense_cached_flat and the
capacity-bounded "torch") on the scene net, and the calibration scripts'
twins (scripts/torch_optimize_policy.py, torch_validate_refresh.py,
torch_eval_headline.py) in this process. Then the measurement and
accuracy scripts' twins, each at a reduced depth (see their phases):
latency per workload, a long stream, the DAG's headline row, the time
per layer prefix, a .y4m file through the flagship, the pose and DAG
accuracy sweeps and the seg repro. Then the twins of the last reference
scripts, each cut: many streams per card, the per-stage device trace,
the tau, fused-detect, stats and pointwise A/Bs, mask forwarding, and the
stem, output and tile variants.

Phases, each printing one JSON line:
  card        the card's name and power limit (nvidia-smi), torch and CUDA
  build       nvcc builds the kernels from cbinfer_tpu_torch/csrc/ (sm_90a)
  probe_dma   scripts/torch_probe_dma_constraints.py's eleven window cases
              (the path of P1 and P2, the DMA-window probes, on TMA): the
              card's verdict per case beside the encoder rules', every
              accepted window bit-identical to the plain version (each
              kernel needs one), a refused one raising with the buffer
              untouched; ms per launch (L2 flushed), plain ms, one
              PyTorch copy_'s ms, and the bound (the window's bytes)
  balance     the achieved bf16 GEMM rate (torch.matmul, 8192^3) and device
              copy rate (1 GiB), their ratio beside the data sheet's and
              metrics.MACHINE_BALANCE, the cost model's constant
  small       each path at 64x128 (scene w16, pose, seg and pose_graph w8,
              float32) on the card against the same run on the CPU's plain
              versions: identical per-layer stats and argmax maps, outputs
              within 1e-3
  main        flagship: 8 timed chunks with the REFRESH_scene.json cadence,
              CB and dense fps by CUDA events, argmax-u8 on both paths; the
              launch counters over the timed CB run, which runs under
              torch.cuda.set_sync_debug_mode("error") (no host sync in the
              frame loop); an untimed seed-0 pass for GT-mIoU (CB and
              dense) and the effective-FLOP reduction
  main_dense_stem  dense_stem: 2 timed chunks, interleaved chunk by chunk
              with 2 more flagship chunks (A S S A), so the stem comparison
              does not ride on the host's load between calls
  hintless    hintless: 2 timed chunks, counters, FLOP reduction, GT-mIoU
              (recorded, not gated: the taus were tuned for the flagship)
  pose        pose: 3 timed chunks of a fixed clip (POSE_TIMED_SEED; the
              scene phases' timed clip is seeded from the clock, and every
              phase line prints its seed) with a refresh prolog every 2nd chunk
              (REFRESH_pose.json validated no cadence), CB and dense fps,
              launch counters derived from the converted specs, no host
              sync; an untimed seed-0 pass for GT-PCK (CB and dense, alpha
              0.05 and 0.02), the FLOP reduction and the stem's density
  pose_unfused  bit-identity of outputs, stats and caches with pose over a
              refresh frame and 31 steady frames; both sides' launches and
              ms/frame in alternating chunks (F U U F); one more frame
              whose stem conv and delta pool calls the check phase holds
  pose_fwd    equality with pose run at tau = -1 on the three forwarded
              layers; launches; ms/frame
  seg, pose_graph  the workload's provenance (trained npz, tuned taus, the
              policy, the refresh cadence's source); 3 timed chunks of a
              fixed clip (POSE_TIMED_SEED), CB and dense with the
              deployment out_map in both loops (seg: the full-resolution
              class map; pose_graph: the 18 heat argmaxes), launches
              asserted against PER_FRAME, which per_frame_launches
              derives from the converted net; an untimed seed-0 pass for
              GT-mIoU at full resolution (seg) or GT-PCK at alpha 0.05 and
              0.02 (pose_graph), dense and CB, recorded, not gated; the
              FLOP reduction (> 1) and the stem's computed tiles (below
              n_tiles)
  graph_<path>  after each path's timed run (flagship, dense_stem,
              hintless, pose, pose_unfused, pose_fwd, seg, pose_graph):
              from two copies of
              its steady state, five chunks (refresh prologs R S S R S)
              eagerly and through runner.scan_video_jit's CUDA graphs,
              outputs, stats and caches bit for bit, every graph's
              captured launches PER_FRAME x its steady frames; then
              GRAPH_PAIRS alternating replayed-chunk / dense-chunk timed
              pairs (graph_fps, graph_ms_per_frame, graph_vs_baseline with
              its spread, host CPU, the graphs' peak memory); on flagship
              and pose, FrameStepper at K = 1 from a cold start, equal to
              the eager loop, per-frame median and p90 wall ms; on
              flagship, hintless, pose and pose_graph, runtime_taus: one
              graph replayed at three tau vectors, changed before every
              replay, equal to the eager loop bit for bit
  import      scene w128 written as an nn.Sequential (conv + BatchNorm with
              random running stats + ReLU, pools, a 1x1 head) through
              convert.specs_from_torch and convert_flagship: its bf16
              dense output against module(x) in float32, one 32-frame CB
              chunk's argmax against the dense argmax on the 31 steady
              frames, the chunk's launches (the flagship's PER_FRAME)
  tune        zoo.load("scene")'s thresholds re-tuned as
              scripts/tune_model.py's scene branch does (seeds 7 and 11,
              T = 96, GT-mIoU degradation on the device, its grid and
              budgets, refresh every 32): evaluations, seconds, the
              selected taus beside the shipped ones, the Pareto rows; then
              stress_validate of {the card's vector, the shipped one, flat
              0.04} on a fresh clip. Gates: the selected metric within the
              budget, a Pareto flop_reduction that does not fall as the
              budget rises, the device metric equal to the host one, the
              dense reference (CB at tau = -1) equal to apply_dense, every
              flagship kernel launched, the selected taus 0.15 x 6, and
              one graph captured for the sweep (and one for the stress
              check) replayed for every other scan; each replay runs
              under the sync check
  cli         cli.main in this process: synthetic 720p w128 bf16 with
              --tune and --live 1, then a .y4m that fileio.write_y4m wrote;
              the JSON keys, flop_reduction > 1, live ms/frame
  multistream the flagship (zoo.load("scene"), trained weights and taus,
              argmax-u8, mean stats) serving S = 4 and 8 streams of distinct
              NativeSpriteVideo seeds (frames made before timing), 4 chunks
              of 32 frames each with the REFRESH_scene.json cadence, then 3
              runner.step frames: every stream's outputs, mean stats and
              caches bit-identical to that stream run alone through its own
              scan_video_jit, every graph's captured launches PER_FRAME x
              its steady frames; then runner.run_clip against the same
              clips back to back in GRAPH_PAIRS alternating pairs, and the
              alone graphs (a pool per stream) replayed each on a side CUDA
              stream of its own, joined by events, bit-identical to in-order
              replays, in pairs against in-order: frames/s per card, the
              ratios, peak memory and graphs live per S
  live        4 NativeSpriteVideo 720p sources behind PrefetchingSource feed
              runner.step for 64 frames: frames/s, the share of next()
              calls that found the queue empty, the generator's ms/frame
              (recorded, not gated)
  changerate  scripts/torch_bench_changerate.py's sweep: the seven points
              of scripts/bench_changerate.py (sprites1 ... sprites24,
              pan_slow, pan_fast; frames made in threads before each point
              is timed), 4 chunks of 32 from a clock seed: chunk 2's replay
              equal to the eager loop bit for bit, graphed CB against
              graphed dense in pairs on chunks 1-3; per point the stem's
              changed share, overflow rate, both fps, their ratio, the
              agreement mIoU and pixel agreement with dense (recorded),
              GT-mIoU of CB and dense, gated: dense - CB <= 0.005 at every
              point; the classes whose IoU between the two maps is below
              0.9 in a chunk; the break-even changed share
  dryrun      parallel.dryrun_multistream over the machine's cards: the
              plain-stem flagship, the kernel path and the pose_graph DAG
              through the runner, one stream per card
  train       scripts/torch_train.py's scene recipe (w128, 8 classes,
              192x256, batch 4, 16 videos, 600 steps, seed 0): ms/step,
              seconds of data and of steps, the first and last 20-step mean
              loss (gated: falls), the final accuracy (gated: >= 0.95), the
              TF32 settings; the trained params served in bf16 through
              convert_flagship at 720p with ckpts/scene_w128_tau.json's taus
              over 3 chunks of the seed-0 scene clip through scan_video_jit:
              the flagship's launches asserted, GT-mIoU of dense (gated:
              >= 0.95) and CB against the 0.005 budget; the params through
              checkpoint.save_npz_params and load_npz_params, one served
              chunk bit-identical; then pose and pose_graph cut to 300 of
              their 3000 steps: ms/step, train PCK, falling loss
  bench       benchmark.bench_network on zoo.load("scene") at 720p over
              make_clips(RunConfig(...), 3) (seed 0), a refresh every 8
              chunks (REFRESH_scene.json): the graphed dense baseline and
              scan_video_jit; the BenchResult and its headline beside
              graph_flagship's figures; gated: flop_reduction > 1,
              metric_value >= 0.995, the flagship's five kernels launched
  backends    the scene net (zoo.load, trained weights, shipped taus) on
              five forms: the flagship, a band_cached stem, a
              dense_cached_flat stem (both before the kernel pipeline),
              and the whole net on the capacity-bounded plain backend
              ("torch") in float32 and in bf16: GT-mIoU of CB and dense
              over two seed-0 chunks (gated: within 0.005), the overflow
              frames and computed share per layer on a panning clip
              (gated: the bounded forms overflow), a steady chunk's
              launches (PER_FRAME) and eager ms/frame, replays equal to
              the eager loop (refresh, steady, pan) and their ms/frame;
              the band and flat stems' caches against the dense_cached
              stem's (gated: one bf16 ulp of the pre-bias dot product)
  policy      scripts/torch_optimize_policy.py on scene in this process
              (2 chunks, 2 windows a network): the band_cached stem's fps
              against the flagship's, every flip's verdict
  refresh     scripts/torch_validate_refresh.py on scene and pose, 4
              chunks, cadences 2 and 0, seed 0: the rows
  headline    one scripts/torch_eval_headline.py row for scene
  latency     scripts/torch_bench_latency.py on scene, seg, pose and
              pose_graph, 32 timed frames each (the script: 96): wall
              p50/p95 of FrameStepper K = 1, 64-frame pipelined windows
              of CB and dense by CUDA events, step_chunk K = 4 and 8, the
              refresh and scan_video_jit's ms a frame; gated: finite times
              for every model, every kernel of each path launched
  longrun     scripts/torch_bench_longrun.py: one flagship stream of 16
              chunks of 32 (the script: 64), seed 424242, windows of 8:
              fps, GT-mIoU of CB and dense, device memory; gated: the
              worst window within the 0.005 budget
  pose_graph_bench  scripts/torch_bench_pose_graph.py at 360x640, 12
              frames x 2 chunks (its defaults): fps, GT-PCK, FLOP
              reduction; gated: finite fps
  profile_stages  scripts/torch_profile_stages.py on scene: CB, dense and
              detect-only ms a frame per layer prefix; gated: finite rows
  footage     scripts/torch_real_footage_demo.py with 64 frames (the
              script: 96): native frames through a .y4m, read back,
              through the flagship, then the CLI on the file; gated:
              finite fps and the CLI's record
  sweeps      scripts/torch_pose_acc_sweep.py's protocol for pose (T 12)
              and pose_graph (T 16) with one seed (the scripts: 4), the
              tuned vector only (the scripts: 3), cadences 2 and 1, 4
              chunks: GT-PCK per chunk; gated: a row per cadence
  seg_repro   scripts/torch_repro_seg_acc.py at its defaults: per chunk
              dense and CB GT-mIoU and agreement; gated: two finite rows
              Each of these seven counts its launches from 0 and fails
              unless every kernel of its path launched.
  multistream_bench  scripts/torch_bench_multistream.py: S = 4 and 8
              flagship streams at 720p, one timed chunk of 8 frames a
              stream, 2 reps (the script: 2 chunks of 16, 3 reps): sequential,
              runner gathered and not, side streams; gated: finite rates
  profile_trace  scripts/torch_profile_trace.py on scene, seg, pose and
              pose_graph, 12 frames each (the script: 24, pose 12):
              per-stage device self time per frame of one
              graph replay (by kernel name) and of the eager loop (by
              stage scope); gated: the stage sums within 2% of the
              device's busy time
  tau_ab      scripts/torch_exp_tau_ab.py on the flagship, 2 chunks and 2
              reps (the script: 4 and 3); gated: one graph per stats form
  forward     scripts/torch_exp_forward.py on seg and pose, one timed
              chunk (the script: 2); gated: every variant runs, finite
              cb_fps and flop_reduction, the tile copy launched
  fused_ab    scripts/torch_exp_fused_ab.py on pose and pose_graph, 3
              chunks of 16 and 2 reps (the script: 6 of 32 and 5); gated:
              the arms' outputs and stats equal
  variants    scripts/torch_exp_variants.py, every mode, 2 chunks of 16
              (the script: 32), 2 passes; gated: finite times, and only
              the plain converter's cin = 3 stem refused (by the
              full-map detect)
  stats_ab    scripts/torch_exp_stats_ab.py on the flagship, 3 chunks and
              2 reps (the script: 6 and 5); gated: the arms' outputs
              bit-identical
  pointwise_ab  scripts/torch_exp_pointwise_ab.py on the flagship, 3
              chunks and 2 reps (the script: 6 and 5); gated: argmax
              agreement >= 0.999, POINTWISE_DOT back at its default
              These eight count their launches from 0 and fail unless
              every kernel of their paths launched.
  check       each of the nine path kernels against its plain version on
              the inputs its path gave it on one steady-state frame, plus
              count = 0, all-dirty lists (for the sparse detect, both
              pools and the tile copy: lists longer than the grid, so
              blocks walk several entries), tau = -1 for the full-map
              detects, the capacity
              overflow of the stem conv (a walk of every tile, longer than
              its grid), the sparse
              detect on a pool's geometry, and the fused kernel against the
              delta conv followed by the sparse detect (bit for bit, at
              tau2 = tuned, -1 and 1e9, listed tiles and every tile); the
              synthetic tile-conv cases (TILE_CONV_CASES: clusters of 1-8
              blocks, cin/cout off the 16-channel grid, dilation, stride,
              small tiles, ragged maps, counts 0, 1 and capacity)
  kernels     every kernel: launches, ms per launch, plain ms, bound ms
              (P1 and P2: their first accepted case's, with library_ms);
              B1, B3 and B4 carry the launch floor (one fill of their
              buffer and an empty one-block kernel, timed as they are) in
              their context, B5, B8 and B9, which make no fill, the empty
              kernel alone
The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without that line; without CUDA it exits 2 at once.
"""

import json
import os
import subprocess
import sys
import time
import types

H, W, T = 720, 1280, 32
CHUNKS = 8            # timed flagship chunks of distinct frames
SIDE_CHUNKS = 2       # timed chunks of each other path
NUM_CLASSES = 8
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
REPO = os.path.dirname(os.path.abspath(__file__))
POSE_CHUNKS = 3       # timed pose chunks (a refresh prolog every 2nd)
POSE_TIMED_SEED = 1   # of the pose phases' timed clip (accuracy: seed 0)
POSE_FWD = {15: "forward_hint", 16: "forward_hint", 20: "forward_hint"}
GRAPH_PAIRS = 4       # timed (CUDA-graph chunk, dense chunk) pairs per path
# refresh prologs of the graphed identity run's chunks: the refresh and the
# steady graph are each captured after an eager first call, then replayed
GRAPH_PATTERN = (True, False, False, True, False)
LATENCY_FRAMES = 64   # timed FrameStepper K=1 frames (flagship, pose)
# the paths whose graph phase replays one graph at three tau vectors (B1,
# B4, B6 and B7 read tau at run time), and the vectors' order: a change
# between every two replays
RUNTIME_TAU_PATHS = ("flagship", "hintless", "pose", "pose_graph")
RUNTIME_TAU_ORDER = (0, 1, 2, 0)
RESULTS = {}
# kernels launched per steady (non-refresh) frame of each path; the pose
# paths' numbers are derived from their converted specs (per_frame_launches),
# seg's and pose_graph's are both written here and derived, and must agree
PER_FRAME = {
    "flagship": {"stem_detect": 1, "stem_conv": 1, "detect_pool_fused": 2,
                 "detect_sparse": 3, "delta_conv": 3},
    "dense_stem": {"detect_pool_fused": 2, "detect_sparse": 3,
                   "delta_conv": 3},
    "hintless": {"detect_full": 1, "delta_pool": 2, "detect_sparse": 4,
                 "delta_conv": 3},
    "seg": {"stem_detect": 1, "stem_conv": 1, "detect_sparse": 6,
            "delta_conv": 6, "detect_pool_fused": 2},
    "pose_graph": {"stem_detect": 1, "stem_conv": 1, "detect_sparse": 8,
                   "delta_conv": 7, "delta_conv_detect": 17,
                   "detect_pool_fused": 2, "delta_pool": 1},
    # the CLI's net: the plain converter with the flagship's stem, so both
    # pools re-detect and the 1x1 head is a CB conv
    "cli": {"stem_detect": 1, "stem_conv": 1, "detect_sparse": 6,
            "delta_pool": 2, "delta_conv": 4},
    # the backends phase's forms (BACKEND_FORMS): a band or flat stem
    # before the kernel pipeline runs dense_stem's kernels; the bounded
    # plain backend runs none
    "band_stem": {"detect_pool_fused": 2, "detect_sparse": 3,
                  "delta_conv": 3},
    "flat_stem": {"detect_pool_fused": 2, "detect_sparse": 3,
                  "delta_conv": 3},
    "torch_f32": {},
    "torch_bf16": {},
}
# what zoo.load must give the two workloads of the last phases: CB layers,
# the fused consumer detect, the policy file it came from (None: "none")
WORKLOADS = {
    "seg": dict(n_taus=9, fuse_detect=False, policy=None),
    "pose_graph": dict(n_taus=28, fuse_detect=True,
                       policy="POLICY_pose_graph.json"),
}


def emit(phase, **kw):
    RESULTS[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    import cbinfer_tpu_torch  # noqa: F401  (fails alone, outside the repo)

    t0 = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from cbinfer_tpu_torch.ops.kernels import build
    info = phase("build", build.build_all)
    emit("build", seconds=info["seconds"],
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in info["ptxas"].items()})
    phase("probe_dma", probe_dma_phase, torch, np)

    phase("balance", balance_phase, torch)
    phase("small", small_parity, torch, np)
    ctx = phase("setup", make_context, torch, np)
    calls = phase("main", main_path, torch, np, ctx)
    phase("graph_flagship", graph_path, torch, "flagship", ctx.wl.net,
          ctx.wl.params, ctx.wl.taus, ctx.state, ctx.chunks, ctx.out_u8,
          ctx.dense_chunk, True)
    phase("main_dense_stem", dense_stem_path, torch, ctx)
    calls += phase("hintless", hintless_path, torch, np, ctx)
    del ctx
    torch.cuda.empty_cache()
    pctx = phase("pose_setup", make_pose_context, torch, np)
    calls += phase("pose", pose_path, torch, np, pctx)
    calls += phase("pose_unfused", pose_unfused_path, torch, pctx)
    calls += phase("pose_fwd", pose_fwd_path, torch, pctx)
    del pctx
    torch.cuda.empty_cache()
    for name in WORKLOADS:
        wctx = phase(f"{name}_setup", make_workload_context, torch, np, name)
        calls += phase(name, workload_path, torch, np, wctx)
        del wctx
        torch.cuda.empty_cache()
    phase("import", import_phase, torch, np)
    phase("tune", tune_phase, torch, np)
    torch.cuda.empty_cache()
    calls += phase("cli", cli_phase, torch, np)
    torch.cuda.empty_cache()
    phase("multistream", multistream_phase, torch, np)
    torch.cuda.empty_cache()
    phase("live", live_phase, torch)
    phase("changerate", changerate_phase, torch, np)
    torch.cuda.empty_cache()
    phase("dryrun", dryrun_phase, torch)
    torch.cuda.empty_cache()
    phase("train", train_phase, torch, np)
    torch.cuda.empty_cache()
    phase("bench", bench_phase, torch, np)
    torch.cuda.empty_cache()
    phase("backends", backends_phase, torch, np)
    torch.cuda.empty_cache()
    phase("policy", policy_phase, torch)
    torch.cuda.empty_cache()
    phase("refresh", refresh_phase, torch)
    torch.cuda.empty_cache()
    phase("headline", headline_phase, torch)
    torch.cuda.empty_cache()
    for name, fn in (("latency", latency_phase), ("longrun", longrun_phase),
                     ("pose_graph_bench", pose_graph_bench_phase),
                     ("profile_stages", profile_stages_phase),
                     ("footage", footage_phase), ("sweeps", sweeps_phase),
                     ("seg_repro", seg_repro_phase),
                     ("multistream_bench", multistream_bench_phase),
                     ("profile_trace", profile_trace_phase),
                     ("tau_ab", tau_ab_phase), ("forward", forward_phase),
                     ("fused_ab", fused_ab_phase),
                     ("variants", variants_phase),
                     ("stats_ab", stats_ab_phase),
                     ("pointwise_ab", pointwise_ab_phase)):
        phase(name, fn, torch, np)
        torch.cuda.empty_cache()
    phase("check", check_kernels, torch, np, calls)
    emit_kernels()
    seconds["total"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------- small parity --------------------------------


def build_net(path, specs, in_shape, cfg, thresholds=None):
    """The path's network through the port's converters."""
    from cbinfer_tpu_torch.convert import convert, convert_flagship
    if path.startswith("pose"):
        return convert_flagship(
            specs, in_shape, cfg, thresholds=thresholds,
            extra_overrides=POSE_FWD if path == "pose_fwd" else None,
            fuse_detect=path != "pose_unfused")
    if path in ("flagship", "seg"):
        return convert_flagship(specs, in_shape, cfg, thresholds=thresholds)
    if path == "dense_stem":
        return convert_flagship(specs, in_shape, cfg, thresholds=thresholds,
                                extra_overrides={0: "dense_cached"})
    return convert(specs, in_shape, cfg, thresholds=thresholds,
                   dense_layers=(0, len(specs) - 1))


def _layers(tree):
    """(key, entry) pairs of a per-layer list or a name-keyed dict."""
    return list(tree.items()) if isinstance(tree, dict) \
        else list(enumerate(tree))


def small_parity(torch, np):
    """The 64x128 slices of tests/test_torch_scene_slice.py, card vs CPU."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.graph import (convert_graph_flagship,
                                         init_graph_params)
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.models.pose import pose_graph
    from cbinfer_tpu_torch.netview import NetView
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    h, w, n = 64, 128, 6
    scene = get_model("scene", num_classes=NUM_CLASSES, width=16)
    pose = get_model("pose", width=8)
    seg = get_model("seg", num_classes=NUM_CLASSES, width=8)[:-1]
    nodes, out_name = pose_graph(width=8)
    scene_clip = SpriteVideo(SpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, seed=3)).clip(n)
    # noise-free, as the CPU tests' clip: a float32 rounding difference
    # between the card and the CPU must not meet a pixel that sits at tau
    pose_clip = SpriteVideo(SpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, seed=3,
        distinct_classes=True)).clip(n)
    report = {}
    for path in ("flagship", "dense_stem", "hintless", "pose",
                 "pose_unfused", "pose_fwd", "seg", "pose_graph"):
        specs, clip = ((pose, pose_clip) if path.startswith("pose")
                       else (seg if path == "seg" else scene, scene_clip))
        out = {}
        for dev in ("cpu", "cuda"):
            cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device=dev)
            if path == "pose_graph":
                # f32: the stage-1 heads' caches are padded 38 -> 40, 18 -> 20
                net = convert_graph_flagship(nodes, (h, w, 3), cfg,
                                             output=out_name,
                                             fuse_detect=True)
                params = init_graph_params(nodes, (h, w, 3), seed=3,
                                           device=dev)
            else:
                net = build_net(path, specs, (h, w, 3), cfg)
                params = init_params(specs, (h, w, 3), seed=3, device=dev)
            taus = [0.05] * len(NetView.of(net).cb_rows())
            ys, _, stats = scan_video(net, params,
                                      torch.from_numpy(clip).to(dev),
                                      thresholds=taus, refresh_start=True)
            out[dev] = (ys.cpu(), [(key, {k: torch.as_tensor(v).cpu()
                                          .tolist() for k, v in s.items()})
                                   for key, s in _layers(stats)])
        err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        # class maps of the scene net; the pose net's 56 regression
        # channels have no argmax to speak of
        same_maps = path.startswith("pose") or bool(torch.equal(
            out["cuda"][0].argmax(-1), out["cpu"][0].argmax(-1)))
        same_stats = out["cuda"][1] == out["cpu"][1]
        report[path] = dict(max_abs_err=err, stats_equal=same_stats,
                            argmax_equal=same_maps)
        if not (err < 1e-3 and same_maps and same_stats):
            raise AssertionError(f"{path}: the card run disagrees with the "
                                 f"CPU run: {report[path]}")
    emit("small", **report)


# ------------------------------ the 720p paths -------------------------------


def scene_workload():
    """zoo.load("scene") at 720p with its provenance checked, and its
    refresh cadence in chunks (REFRESH_scene.json)."""
    from cbinfer_tpu_torch import zoo
    wl = zoo.load("scene", (H, W, 3))
    if wl.weights != "trained(npz)" or wl.tau_source != "tuned" \
            or wl.warnings:
        raise AssertionError(f"zoo.load: {wl.weights} {wl.tau_source} "
                             f"{wl.warnings}")
    cadence, src = zoo.load_refresh_cadence("scene", T, H, W)
    if not src.endswith("REFRESH_scene.json"):
        raise AssertionError(f"refresh cadence: {src}")
    return wl, cadence


def _u8_map(torch):
    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)
    return out_u8


def make_context(torch, np):
    """What the three 720p phases share: the workload (weights, taus and
    refresh cadence through the zoo), frames, and the timing helpers."""
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    wl, cadence = scene_workload()
    out_u8 = _u8_map(torch)

    def video(seed):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed, **workload_video_kwargs("scene")))

    def cb_chunk(net, taus, ch, state, refresh, stats=False):
        return scan_video(net, wl.params, ch, state, collect_stats=stats,
                          thresholds=taus, refresh_start=refresh,
                          out_map=out_u8)

    def dense_chunk(ch):
        return torch.stack([out_u8(wl.net.apply_dense(wl.params, f))
                            for f in ch])

    def warm_state(net, taus, warm):
        """A steady state: cold start, allocator, algorithm choices."""
        state = net.init_state()
        state = cb_chunk(net, taus, warm, state, True)[1]
        return cb_chunk(net, taus, warm, state, False)[1]

    seed = int(time.time() * 1e3) % 100000
    tv = video(seed)
    warm = torch.from_numpy(tv.clip(T)).cuda()
    chunks = [torch.from_numpy(tv.clip(T)).cuda() for _ in range(CHUNKS)]
    return types.SimpleNamespace(
        wl=wl, seed=seed, cadence=min(cadence, CHUNKS), video=video,
        out_u8=out_u8,
        cb_chunk=cb_chunk, dense_chunk=dense_chunk, warm_state=warm_state,
        warm=warm, chunks=chunks, accuracy=None, state=None)


def timed(torch, fn):
    """(result, device ms between events, host CPU ms of this thread while
    enqueuing: the host's own work, whatever else the host runs)"""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    c0 = time.thread_time()
    e0.record()
    r = fn()
    e1.record()
    c1 = time.thread_time()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1), (c1 - c0) * 1e3


def no_sync(torch, fn):
    """Run the frame loop so that any implicit host sync (a .item(), a
    host-to-device copy of a Python value) raises: it must only enqueue."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def expect_launches(path, counts, steady_frames):
    """The path went through its kernels: exactly the per-frame numbers,
    and nothing else was launched."""
    want = {k: 0 for k in counts}
    want.update({k: v * steady_frames for k, v in PER_FRAME[path].items()})
    if counts != want:
        raise AssertionError(f"{path}: launches {counts} != {want}")


def accuracy_pass(torch, np, ctx, net, taus, n_chunks, cadence):
    """Untimed pass over the fixed seed-0 clip: GT-mIoU of the CB maps and
    of the dense maps (computed once, kept for the later paths), their
    agreement, and the per-layer stats means. Returns (miou dict, effective
    flops, the CB state after the pass, the seed-0 video)."""
    from cbinfer_tpu_torch.metrics import effective_flops, iu_counts, merge_iu
    from cbinfer_tpu_torch.network import out_shapes
    av = ctx.video(0)
    stride = H // out_shapes(net.specs, (H, W, 3))[-1][0]
    if ctx.accuracy is None:
        ctx.accuracy = []
    sums = {k: [0, 0] for k in ("cb", "dense", "agree")}
    chunk_stats = []
    state = net.init_state()
    for i in range(n_chunks):
        ch, lab = av.clip_with_labels(T)
        ch = torch.from_numpy(ch).cuda()
        if i == len(ctx.accuracy):
            ctx.accuracy.append((
                torch.from_numpy(lab[:, ::stride, ::stride]).cuda(),
                ctx.dense_chunk(ch)))
        lab, dmap = ctx.accuracy[i]
        cmap, state, st = ctx.cb_chunk(net, taus, ch, state,
                                       i % cadence == 0, stats="mean")
        chunk_stats.append([{k: float(v) for k, v in s.items()} for s in st])
        skip = 8 if i == 0 else 0  # cold start is exact by construction
        for key, a, b in (("cb", cmap, lab), ("dense", dmap, lab),
                          ("agree", cmap, dmap)):
            it, un = iu_counts(a[skip:], b[skip:], NUM_CLASSES)
            sums[key][0] += it.cpu().numpy()
            sums[key][1] += un.cpu().numpy()
    stats = [{k: np.array([c[li][k] for c in chunk_stats]) for k in s}
             if s else {} for li, s in enumerate(chunk_stats[0])]
    ef = effective_flops(stats, net.specs, (H, W, 3), 8, 8)
    miou = {k: merge_iu(*v) for k, v in sums.items()}
    stem = stats[0]
    stem_tiles = ({"computed": float(np.mean(stem["computed_tiles"])),
                   "n_tiles": float(np.max(stem["n_tiles"])),
                   "overflow_share": float(np.mean(stem["overflow"]))}
                  if stem else None)
    return miou, ef, stem_tiles, state, av


def capture_frame(torch, ctx, path, net, taus, state, av,
                  out_shape=(H // 4, W // 4, NUM_CLASSES), frame=None):
    """One more (steady-state) frame (the next of video ``av``, or
    ``frame``) with every kernel call recorded: the inputs each kernel of
    the path gets at the path's own shapes."""
    from cbinfer_tpu_torch import layers as L
    calls = []
    names = ("detect_sparse", "delta_conv", "detect_pool_fused",
             "stem_detect", "stem_conv", "detect_full", "delta_pool",
             "delta_conv_detect", "accept_tiles")
    saved = {n: getattr(L, n) for n in names}

    def recorder(name):
        def wrapper(*args, **kw):
            calls.append((path, name,
                          [a.clone() if torch.is_tensor(a) else a
                           for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()}))
            return saved[name](*args, **kw)
        return wrapper

    if frame is None:
        frame = torch.from_numpy(av.clip(1)).cuda()[0]
    if per_frame_launches(net) != PER_FRAME[path]:
        raise AssertionError(f"{path}: the specs give "
                             f"{per_frame_launches(net)}, not "
                             f"{PER_FRAME[path]}")
    try:
        for n in names:
            setattr(L, n, recorder(n))
        logits = net.apply(ctx.wl.params, state, frame, taus)[0]
    finally:
        for n in names:
            setattr(L, n, saved[n])
    if (tuple(logits.shape) != out_shape
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{path}: logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    got = {}
    for _, name, _, _ in calls:
        got[name] = got.get(name, 0) + 1
    if got != PER_FRAME[path]:
        raise AssertionError(f"{path}: a steady frame called {got}, not "
                             f"{PER_FRAME[path]}")
    return calls


def main_path(torch, np, ctx):
    """The exact flagship, as zoo.load builds it."""
    from cbinfer_tpu_torch.convert import num_cb_layers
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    net, taus, cadence, chunks = ctx.wl.net, ctx.wl.taus, ctx.cadence, \
        ctx.chunks
    if net.specs[0].backend != "patch_stem" \
            or num_cb_layers(net.specs) != len(taus):
        raise AssertionError(f"not the flagship: {net.specs[0]}")
    torch.cuda.reset_peak_memory_stats()
    state = ctx.warm_state(net, taus, ctx.warm)
    ctx.dense_chunk(ctx.warm)
    torch.cuda.synchronize()

    # an event after every chunk too: the host-bound CB loop swings with
    # the host's load, and per-chunk times show the spread
    marks = {k: [torch.cuda.Event(enable_timing=True)
                 for _ in range(CHUNKS + 1)] for k in ("cb", "dense")}

    def cb_run():
        nonlocal state
        ys = None
        marks["cb"][0].record()
        for i, ch in enumerate(chunks):
            ys, state, _ = ctx.cb_chunk(net, taus, ch, state,
                                        i % cadence == 0)
            marks["cb"][i + 1].record()
        return ys

    def dense_run():
        marks["dense"][0].record()
        for i, ch in enumerate(chunks):
            dn = ctx.dense_chunk(ch)
            marks["dense"][i + 1].record()
        return dn

    def chunk_ms(key):
        m = marks[key]
        return [m[i].elapsed_time(m[i + 1]) / T for i in range(CHUNKS)]

    reset_launches()
    ys, cb_ms, cb_host_ms = timed(torch, lambda: no_sync(torch, cb_run))
    counts = launches()
    n_refresh = sum(1 for i in range(CHUNKS) if i % cadence == 0)
    expect_launches("flagship", counts, CHUNKS * T - n_refresh)
    if ys.shape != (T, H // 4, W // 4) or ys.dtype != torch.uint8:
        raise AssertionError(f"CB output {tuple(ys.shape)} {ys.dtype}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    _, dense_ms, dense_host_ms = timed(torch, dense_run)
    frames = CHUNKS * T
    cb_fps, dense_fps = frames / (cb_ms / 1e3), frames / (dense_ms / 1e3)
    ctx.state = state  # steady, for the interleaved stem comparison

    miou, ef, stem_tiles, acc_state, av = accuracy_pass(
        torch, np, ctx, net, taus, max(2, cadence), cadence)
    emit("main", path="flagship", timed_clip_seed=ctx.seed, cb_fps=cb_fps,
         dense_fps=dense_fps,
         vs_baseline=cb_fps / dense_fps, cb_ms_per_frame=cb_ms / frames,
         dense_ms_per_frame=dense_ms / frames, frames_timed=frames,
         cb_host_cpu_ms_per_frame=cb_host_ms / frames,
         dense_host_cpu_ms_per_frame=dense_host_ms / frames,
         cb_chunk_ms_per_frame=chunk_ms("cb"),
         dense_chunk_ms_per_frame=chunk_ms("dense"),
         refresh_every_chunks=cadence, launches=counts,
         miou_gt_cb=miou["cb"], miou_gt_dense=miou["dense"],
         miou_degradation=miou["dense"] - miou["cb"],
         miou_vs_dense=miou["agree"],
         flop_reduction=ef["flop_reduction"], stem_tiles=stem_tiles,
         peak_mem_gib=peak_gib, smi_after_cb=clocks,
         weights=ctx.wl.weights, taus=taus, stem=net.specs[0].backend)
    if not miou["dense"] - miou["cb"] <= 0.005:
        raise AssertionError(f"GT-mIoU degradation "
                             f"{miou['dense'] - miou['cb']} > 0.005")
    if not stem_tiles["computed"] < stem_tiles["n_tiles"]:
        raise AssertionError(f"the sparse stem computed every tile: "
                             f"{stem_tiles}")
    return capture_frame(torch, ctx, "flagship", net, taus, acc_state, av)


def dense_stem_path(torch, ctx):
    """The flagship with the stem on dense_cached, chunk by chunk in turns
    with the exact flagship (A S S A) on the same frames."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl = ctx.wl
    nets = {"flagship": wl.net,
            "dense_stem": build_net("dense_stem", wl.specs, (H, W, 3),
                                    wl.net.cfg)}
    torch.cuda.reset_peak_memory_stats()
    states = {"flagship": ctx.state,
              "dense_stem": ctx.warm_state(nets["dense_stem"], wl.taus,
                                           ctx.warm)}
    torch.cuda.synchronize()
    order = ["flagship"] + ["dense_stem"] * SIDE_CHUNKS + ["flagship"]
    series = {k: [] for k in nets}
    host = {k: [] for k in nets}
    counts = {k: {} for k in nets}
    for path, ch in zip(order, ctx.chunks):
        def run():
            states[path] = ctx.cb_chunk(nets[path], wl.taus, ch,
                                        states[path], False)[1]
        reset_launches()
        _, ms, host_ms = timed(torch, lambda: no_sync(torch, run))
        for k, v in launches().items():
            counts[path][k] = counts[path].get(k, 0) + v
        series[path].append(ms / T)
        host[path].append(host_ms / T)
    for path in nets:
        expect_launches(path, counts[path], len(series[path]) * T)
    emit("main_dense_stem", timed_clip_seed=ctx.seed, order=order,
         ms_per_frame=series,
         host_cpu_ms_per_frame=host,
         cb_fps={k: 1e3 * len(v) / sum(v) for k, v in series.items()},
         launches=counts["dense_stem"], launches_flagship=counts["flagship"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    graph_path(torch, "dense_stem", nets["dense_stem"], wl.params, wl.taus,
               states["dense_stem"], ctx.chunks, ctx.out_u8, ctx.dense_chunk)
    ctx.state = None
    del states
    torch.cuda.empty_cache()


def hintless_path(torch, np, ctx):
    """The plain converter with a dense stem: no hint reaches the first
    pool, and no pool forwards one."""
    from cbinfer_tpu_torch.convert import num_cb_layers
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl = ctx.wl
    net = build_net("hintless", wl.specs, (H, W, 3), wl.net.cfg)
    taus = [wl.taus[0]] * num_cb_layers(net.specs)
    if net.specs[0].use_cb or any(getattr(s, "forward_hint", False)
                                  for s in net.specs):
        raise AssertionError("not the hint-less path")
    torch.cuda.reset_peak_memory_stats()
    state = ctx.warm_state(net, taus, ctx.warm)
    torch.cuda.synchronize()
    chunks = ctx.chunks[:SIDE_CHUNKS]
    series, host = [], []
    reset_launches()
    for ch in chunks:
        def run():
            nonlocal state
            return ctx.cb_chunk(net, taus, ch, state, False)
        (ys, state, _), ms, host_ms = timed(
            torch, lambda: no_sync(torch, run))
        series.append(ms / T)
        host.append(host_ms / T)
    counts = launches()
    expect_launches("hintless", counts, len(chunks) * T)
    if ys.shape != (T, H // 4, W // 4) or ys.dtype != torch.uint8:
        raise AssertionError(f"CB output {tuple(ys.shape)} {ys.dtype}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    graph_path(torch, "hintless", net, wl.params, taus, state, ctx.chunks,
               ctx.out_u8, ctx.dense_chunk)
    del state
    # as many chunks as the flagship's pass, so that the one refresh frame
    # weighs the same in both FLOP reductions
    miou, ef, _, acc_state, av = accuracy_pass(
        torch, np, ctx, net, taus, max(2, ctx.cadence), ctx.cadence)
    emit("hintless", path="hintless", timed_clip_seed=ctx.seed,
         cb_fps=1e3 * len(series) / sum(series),
         dense_fps=RESULTS["main"]["dense_fps"], ms_per_frame=series,
         host_cpu_ms_per_frame=host, frames_timed=len(chunks) * T,
         launches=counts, flop_reduction=ef["flop_reduction"],
         miou_gt_cb=miou["cb"], miou_gt_dense=miou["dense"],
         miou_degradation=miou["dense"] - miou["cb"],
         miou_vs_dense=miou["agree"], peak_mem_gib=peak_gib, taus=taus)
    return capture_frame(torch, ctx, "hintless", net, taus, acc_state, av)



# ------------------------------- CUDA graphs ---------------------------------


def _clone_state(state):
    from cbinfer_tpu_torch.layers import CBLayerState
    out = [(k, None if s is None else CBLayerState(s.in_cache.clone(),
                                                   s.out_cache.clone()))
           for k, s in _layers(state)]
    return dict(out) if isinstance(state, dict) else [s for _, s in out]


def _graph_launches(path, info, want_frames):
    """Each live graph's captured launches are PER_FRAME[path] times its
    steady frames (a refresh graph's frame 0 launches none)."""
    for g in info:
        steady = g["frames"] - (1 if g["refresh_start"] else 0)
        want = {k: v * steady for k, v in PER_FRAME[path].items()
                if v * steady}
        if g["launches"] != want:
            raise AssertionError(f"{path}: a graph of {g} captured "
                                 f"{g['launches']}, not {want}")
    got = sorted((g["frames"], g["refresh_start"]) for g in info)
    if got != sorted(want_frames):
        raise AssertionError(f"{path}: graphs {got}, not {want_frames}")


def graph_path(torch, path, net, params, taus, state, chunks, out_map,
               dense_chunk, latency=False):
    """The path through its CUDA-graph forms, from a steady state:
    (1) identity: the GRAPH_PATTERN chunks from two clones of the state,
    eagerly (scan_video) and through scan_video_jit, outputs, stats and
    final caches bit for bit, the replays under the host-sync check, and
    the graphs' captured launches PER_FRAME x their steady frames;
    (2) GRAPH_PAIRS timed pairs of a replayed steady chunk and a dense
    chunk (G D D G ...), CUDA events, the medians and spread; (3) with
    ``latency``, FrameStepper.__call__ at K=1 from a cold start: equal to
    the eager loop on the same frames, then per-frame wall ms (synchronised)
    over LATENCY_FRAMES frames."""
    import numpy as np
    from cbinfer_tpu_torch.runner import (FrameStepper, scan_video,
                                          scan_video_jit)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    s_eager, s_graph = _clone_state(state), _clone_state(state)
    run = scan_video_jit(net)
    for i, refresh in enumerate(GRAPH_PATTERN):
        ch = chunks[i % len(chunks)]
        eager = scan_video(net, params, ch, s_eager, collect_stats=True,
                           thresholds=taus, refresh_start=refresh)
        graphed = no_sync(torch, lambda: run(
            params, ch, s_graph, thresholds=taus, refresh_start=refresh,
            collect_stats=True))
        _same_run(torch, eager, graphed, f"{path}: graph vs eager, chunk {i}")
    info = run.graphs.info()
    replays = sum(g["replays"] for g in info)
    if replays != len(GRAPH_PATTERN) - 2:
        raise AssertionError(f"{path}: {replays} replays: {info}")
    _graph_launches(path, info, [(T, True), (T, False)])
    del eager, graphed, s_eager
    runtime = (runtime_taus(torch, path, net, params, taus, state, chunks)
               if path in RUNTIME_TAU_PATHS else None)

    # timed: replayed steady chunks (no stats, the deployment out_map)
    # against the dense path, in turns
    def graph_chunk(ch):
        return run(params, ch, s_graph, thresholds=taus, collect_stats=False,
                   out_map=out_map)[0]
    graph_chunk(chunks[0])
    graph_chunk(chunks[1])
    _graph_launches(path, run.graphs.info(),
                    [(T, True), (T, False), (T, False)])
    order = ["graph", "dense", "dense", "graph"] * (GRAPH_PAIRS // 2)
    series = {"graph": [], "dense": []}
    host = {"graph": [], "dense": []}
    for i, kind in enumerate(order):
        ch = chunks[(i // 2) % len(chunks)]
        fn = (lambda: no_sync(torch, lambda: graph_chunk(ch))) \
            if kind == "graph" else (lambda: dense_chunk(ch))
        _, ms, host_ms = timed(torch, fn)
        series[kind].append(ms / T)
        host[kind].append(host_ms / T)
    ratio = [d / g for g, d in zip(series["graph"], series["dense"])]
    g_ms = float(np.median(series["graph"]))
    out = dict(path=path, identical_to_eager=True, pattern=GRAPH_PATTERN,
               replays_checked=replays, graphs=run.graphs.info(),
               graph_ms_per_frame=g_ms, graph_fps=1e3 / g_ms,
               graph_host_cpu_ms_per_frame=float(np.median(host["graph"])),
               dense_ms_per_frame=float(np.median(series["dense"])),
               dense_fps=1e3 / float(np.median(series["dense"])),
               graph_vs_baseline=float(np.median(ratio)),
               graph_vs_baseline_spread=[min(ratio), max(ratio)],
               order=order, ms_per_frame=series, host_cpu_ms_per_frame=host,
               peak_mem_above_held_gib=(torch.cuda.max_memory_allocated()
                                        - held) / 2**30,
               reserved_gib=torch.cuda.memory_reserved() / 2**30,
               smi=nvidia_smi("name,power.limit"))
    if runtime is not None:
        out["runtime_taus"] = runtime
    del run, s_graph
    if latency:
        frames = torch.cat([chunks[0][:8]] + list(chunks[1:]))[
            :8 + LATENCY_FRAMES]
        ref = scan_video(net, params, frames, net.init_state(),
                         collect_stats=False, thresholds=taus,
                         refresh_start=True, out_map=out_map)[0]
        stepper = FrameStepper(net, params, thresholds=taus, out_map=out_map)
        ys, wall = [], []
        for t, f in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys.append(no_sync(torch, lambda: stepper(f)[0]) if t > 2
                      else stepper(f)[0])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(torch.stack(ys), ref):
            raise AssertionError(f"{path}: FrameStepper differs from the "
                                 "eager loop")
        info = stepper.graphs.info()
        _graph_launches(path, info, [(1, True), (1, False)])
        wall = wall[8:]
        out["stepper_k1"] = dict(
            frames=len(wall), median_ms=float(np.median(wall)),
            p90_ms=float(np.percentile(wall, 90)), min_ms=min(wall),
            identical_to_eager=True, graphs=info)
        del stepper
    emit(f"graph_{path}", **out)
    torch.cuda.empty_cache()


def runtime_taus(torch, path, net, params, taus, state, chunks):
    """Thresholds at run time inside one graph: steady chunks from two
    clones of ``state`` through scan_video_jit and the eager scan_video,
    at three tau vectors in the order RUNTIME_TAU_ORDER (the first call
    eager and captured, then a replay after each change of the vector):
    outputs, stats, packed stats and final caches bit for bit, and one
    graph captured for all of them."""
    from cbinfer_tpu_torch.runner import (pack_stats, scan_video,
                                          scan_video_jit)
    vectors = [list(taus), [0.5 * t for t in taus],
               [t * (2.0 if i % 2 else 0.25) for i, t in enumerate(taus)]]
    run = scan_video_jit(net)
    s_eager, s_graph = _clone_state(state), _clone_state(state)
    for i, v in enumerate(RUNTIME_TAU_ORDER):
        ch = chunks[i % len(chunks)]
        eager = scan_video(net, params, ch, s_eager, collect_stats=True,
                           thresholds=vectors[v])
        graphed = no_sync(torch, lambda: run(
            params, ch, s_graph, thresholds=vectors[v], collect_stats=True))
        what = f"{path}: runtime taus, chunk {i} (vector {v})"
        _same_run(torch, eager, graphed, what)
        if not torch.equal(pack_stats(eager[2]), pack_stats(graphed[2])):
            raise AssertionError(f"{what}: packed stats differ")
    info = run.graphs.info()
    if (run.graphs.captures != 1 or len(info) != 1
            or info[0]["replays"] != len(RUNTIME_TAU_ORDER) - 1):
        raise AssertionError(f"{path}: runtime taus took "
                             f"{run.graphs.captures} captures: {info}")
    del run, s_eager, s_graph
    return dict(vectors=vectors, order=list(RUNTIME_TAU_ORDER),
                identical_to_eager=True, captures=1,
                replays=len(RUNTIME_TAU_ORDER) - 1)


# ------------------------------ the pose paths -------------------------------


def per_frame_launches(net):
    """Kernel launches of one steady (non-refresh) frame, read off the
    converted net (a CBNet or a CBGraphNet): which layer detects for
    itself, which is pre-detected by its producer's fused kernel (on a DAG
    only the consumer ``fused_consumer_map`` names), which forwards its
    producer's hint. A hint reaches a layer from a CB producer, or from a
    concat whose inputs all carry one."""
    from cbinfer_tpu_torch import layers as L
    from cbinfer_tpu_torch.netview import NetView
    view = NetView.of(net)
    if hasattr(net, "nodes"):
        row_of = {r.key: i for i, r in enumerate(view.rows)}
        consumer = {row_of[p]: row_of[c]
                    for p, c in net.fused_consumer_map().items()}
    else:
        consumer = {i: i + 1 for i in range(len(view.rows) - 1)}
    want = {}

    def add(name):
        want[name] = want.get(name, 0) + 1

    hinted, predetected = [], set()
    for i, row in enumerate(view.rows):
        spec = row.spec
        hint = bool(row.producers) and all(hinted[p] for p in row.producers)
        if spec.kind == "concat":
            hinted.append(hint)
            continue
        if spec.kind not in ("conv", "pool") or not spec.use_cb:
            hinted.append(False)
            continue
        cfg = L._layer_cfg(spec, net.cfg)
        g = L._geometry(spec, row.in_shape, cfg)
        if cfg.backend == "patch_stem":
            add("stem_detect")
            add("stem_conv")
        elif cfg.backend in ("dense_cached", "dense_cached_flat",
                             "band_cached", "torch"):
            pass  # detects and convolves with torch ops, no kernel
        elif (spec.kind == "pool" and spec.forward_hint and hint
              and L.fused_pool_gate(spec, g, cfg)):
            add("detect_pool_fused")
        else:
            if spec.kind == "conv" and spec.forward_hint and hint:
                add("accept_tiles")
            elif i not in predetected:
                add("detect_sparse" if hint else "detect_full")
            j = consumer.get(i)
            if spec.kind == "pool":
                add("delta_pool")
            elif (spec.fuse_next_detect and j is not None
                  and L.fuse_next_gate(spec, view.rows[j].spec,
                                       row.in_shape, net.cfg)):
                add("delta_conv_detect")
                predetected.add(j)
            else:
                add("delta_conv")
        hinted.append(True)
    return want


def make_pose_context(torch, np):
    """What the pose phases share: the workload through the zoo, the
    graded-dynamics frames, and the chunk runners (outputs reduced on the
    device to the 18 heat-channel argmaxes, as PCK needs them)."""
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.metrics import heat_argmax
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    wl = zoo.load("pose", (H, W, 3))
    if (wl.weights != "trained(npz)" or wl.tau_source != "tuned"
            or wl.warnings or wl.fuse_detect is not True
            or not wl.policy_source.endswith("POLICY_pose.json")
            or len(wl.taus) != 21):
        raise AssertionError(
            f"zoo.load('pose'): {wl.weights} {wl.tau_source} "
            f"{wl.policy_source} fuse_detect={wl.fuse_detect} "
            f"{len(wl.taus)} taus {wl.warnings}")
    cadence, cadence_src = zoo.load_refresh_cadence("pose", T, H, W)
    if cadence != 2 or "no cadence validated" not in cadence_src:
        raise AssertionError(f"refresh cadence: {cadence} {cadence_src}")

    def video(seed):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed, distinct_classes=True,
            **workload_video_kwargs("pose")))

    def cb_chunk(net, taus, ch, state, refresh, stats=False,
                 out_map=heat_argmax):
        return scan_video(net, wl.params, ch, state, collect_stats=stats,
                          thresholds=taus, refresh_start=refresh,
                          out_map=out_map)

    def dense_chunk(ch):
        return torch.stack([heat_argmax(wl.net.apply_dense(wl.params, f))
                            for f in ch])

    # a fixed clip: pose_unfused and pose_fwd capture their kernel calls
    # from its chunk 3 after streaming chunks 0-2, so every run holds B5,
    # B8 and B9 against the same lists
    tv = video(POSE_TIMED_SEED)
    warm = torch.from_numpy(tv.clip(T)).cuda()
    chunks = [torch.from_numpy(tv.clip(T)).cuda()
              for _ in range(POSE_CHUNKS + 1)]
    return types.SimpleNamespace(
        wl=wl, seed=POSE_TIMED_SEED, cadence=cadence, cadence_src=cadence_src, video=video,
        cb_chunk=cb_chunk, dense_chunk=dense_chunk, warm=warm, chunks=chunks,
        out_shape=(H // 8, W // 8, 56))


def pose_path(torch, np, ctx):
    """zoo.load("pose") exactly: timed CB and dense, launches, accuracy."""
    from cbinfer_tpu_torch.metrics import (effective_flops, heat_argmax,
                                           pck_gt_from_argmax)
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl, net, taus = ctx.wl, ctx.wl.net, ctx.wl.taus
    PER_FRAME["pose"] = per_frame_launches(net)
    fused = [i for i, s in enumerate(net.specs)
             if getattr(s, "fuse_next_detect", False)]
    if (net.specs[0].backend != "patch_stem" or len(fused) != 13
            or PER_FRAME["pose"].get("delta_conv_detect") != 13):
        raise AssertionError(f"not the pose flagship: fused {fused}, "
                             f"{PER_FRAME['pose']}")
    chunks = ctx.chunks[:POSE_CHUNKS]
    torch.cuda.reset_peak_memory_stats()
    # what the earlier phases keep on the card (the recorded kernel calls)
    held_gib = torch.cuda.memory_allocated() / 2**30
    state = net.init_state()
    state = ctx.cb_chunk(net, taus, ctx.warm, state, True)[1]
    state = ctx.cb_chunk(net, taus, ctx.warm, state, False)[1]
    ctx.dense_chunk(ctx.warm)
    torch.cuda.synchronize()
    marks = {k: [torch.cuda.Event(enable_timing=True)
                 for _ in range(POSE_CHUNKS + 1)] for k in ("cb", "dense")}

    def cb_run():
        nonlocal state
        ys = None
        marks["cb"][0].record()
        for i, ch in enumerate(chunks):
            ys, state, _ = ctx.cb_chunk(net, taus, ch, state,
                                        i % ctx.cadence == 0)
            marks["cb"][i + 1].record()
        return ys

    def dense_run():
        marks["dense"][0].record()
        for i, ch in enumerate(chunks):
            dn = ctx.dense_chunk(ch)
            marks["dense"][i + 1].record()
        return dn

    def chunk_ms(key):
        m = marks[key]
        return [m[i].elapsed_time(m[i + 1]) / T for i in range(POSE_CHUNKS)]

    reset_launches()
    ys, cb_ms, cb_host_ms = timed(torch, lambda: no_sync(torch, cb_run))
    counts = launches()
    n_refresh = sum(1 for i in range(POSE_CHUNKS) if i % ctx.cadence == 0)
    frames = POSE_CHUNKS * T
    expect_launches("pose", counts, frames - n_refresh)
    if ys.shape != (T, 18) or ys.dtype != torch.int64:
        raise AssertionError(f"CB output {tuple(ys.shape)} {ys.dtype}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    _, dense_ms, dense_host_ms = timed(torch, dense_run)
    cb_fps, dense_fps = frames / (cb_ms / 1e3), frames / (dense_ms / 1e3)
    # untimed accuracy pass on the fixed seed-0 clip: 2 chunks, a refresh
    # prolog on the first
    av = ctx.video(0)
    acc_state = net.init_state()
    cb_arg, dn_arg, kps, valid, chunk_stats = [], [], [], [], []
    for i in range(2):
        ch, k, v = av.clip_with_keypoints(T)
        ch = torch.from_numpy(ch).cuda()
        a, acc_state, st = ctx.cb_chunk(net, taus, ch, acc_state, i == 0,
                                        stats="mean")
        cb_arg.append(a.cpu())
        dn_arg.append(ctx.dense_chunk(ch).cpu())
        kps.append(k)
        valid.append(v)
        chunk_stats.append([{q: float(x) for q, x in s.items()} for s in st])
    kps, valid = np.concatenate(kps), np.concatenate(valid)
    cb_arg, dn_arg = torch.cat(cb_arg), torch.cat(dn_arg)
    hw = ctx.out_shape[:2]
    pck = {f"{name}@{alpha}": pck_gt_from_argmax(arg[8:], hw, kps[8:],
                                                 valid[8:], 8, alpha)
           for name, arg in (("cb", cb_arg), ("dense", dn_arg))
           for alpha in (0.05, 0.02)}  # 8 cold-start frames skipped
    stats = [{k: np.array([c[li][k] for c in chunk_stats]) for k in s}
             if s else {} for li, s in enumerate(chunk_stats[0])]
    ef = effective_flops(stats, net.specs, (H, W, 3), 8, 8)
    stem = stats[0]
    steady = chunk_stats[1][0]  # the chunk without a refresh frame
    stem_tiles = {"computed": float(np.mean(stem["computed_tiles"])),
                  "n_tiles": float(np.max(stem["n_tiles"])),
                  "steady_chunk_density": steady["computed_tiles"]
                  / steady["n_tiles"],
                  "overflow_share": float(np.mean(stem["overflow"])),
                  "steady_chunk_overflow_share": steady["overflow"]}
    density = [round(float(np.mean(s["computed_tiles"])
                           / np.max(s["n_tiles"])), 4) if s else None
               for s in stats]
    emit("pose", path="pose", timed_clip_seed=ctx.seed, cb_fps=cb_fps,
         dense_fps=dense_fps,
         vs_baseline=cb_fps / dense_fps, cb_ms_per_frame=cb_ms / frames,
         dense_ms_per_frame=dense_ms / frames, frames_timed=frames,
         steady_frames=frames - n_refresh,
         cb_host_cpu_ms_per_frame=cb_host_ms / frames,
         dense_host_cpu_ms_per_frame=dense_host_ms / frames,
         cb_chunk_ms_per_frame=chunk_ms("cb"),
         dense_chunk_ms_per_frame=chunk_ms("dense"),
         refresh_every_chunks=ctx.cadence, refresh_source=ctx.cadence_src,
         launches=counts, per_frame=PER_FRAME["pose"], fused_layers=fused,
         pck_gt=pck,
         pck_degradation={a: pck[f"dense@{a}"] - pck[f"cb@{a}"]
                          for a in (0.05, 0.02)},
         pck_budget_not_gated=0.005,
         flop_reduction=ef["flop_reduction"],
         dense_gflop_per_frame=ef["dense_flops_per_frame"] / 1e9,
         stem_tiles=stem_tiles, computed_share_per_layer=density,
         peak_mem_gib=peak_gib, peak_mem_above_held_gib=peak_gib - held_gib,
         smi_after_cb=clocks, weights=wl.weights,
         tau_source=wl.tau_source, policy_source=wl.policy_source,
         fuse_detect=wl.fuse_detect, taus=taus)
    if not all(np.isfinite(v) for v in pck.values()) \
            or pck["dense@0.05"] < 0.5:
        raise AssertionError(f"the trained pose net finds no keypoints: {pck}")
    if not stem_tiles["computed"] < stem_tiles["n_tiles"]:
        raise AssertionError(f"the sparse stem computed every tile: "
                             f"{stem_tiles}")
    graph_path(torch, "pose", net, wl.params, taus, state, ctx.chunks,
               heat_argmax, ctx.dense_chunk, latency=True)
    del state
    return capture_frame(torch, ctx, "pose", net, taus, acc_state, av,
                         ctx.out_shape)


def _same_run(torch, a, b, what, stats=True):
    """Outputs, every cache and (with ``stats``) the per-layer stats of two
    runs, bit for bit."""
    (ya, sa, ta), (yb, sb, tb) = a, b
    if not torch.equal(ya, yb):
        raise AssertionError(f"{what}: outputs differ")
    if stats and [k for k, _ in _layers(ta)] != [k for k, _ in _layers(tb)]:
        raise AssertionError(f"{what}: the stats' layers differ")
    for (k, x), (_, y) in zip(_layers(ta), _layers(tb)) if stats else ():
        if set(x) != set(y):
            raise AssertionError(f"{what}: layer {k} stats' keys differ")
        for key in x:
            if not torch.equal(torch.as_tensor(x[key]),
                               torch.as_tensor(y[key])):
                raise AssertionError(f"{what}: layer {k} stat {key} differs")
    for (k, x), (_, y) in zip(_layers(sa), _layers(sb)):
        if x is not None and not (torch.equal(x.in_cache, y.in_cache)
                                  and torch.equal(x.out_cache, y.out_cache)):
            raise AssertionError(f"{what}: layer {k} caches differ")


def pose_unfused_path(torch, ctx):
    """The A/B partner of pose: every consumer detects for itself. Bit-
    identical outputs, stats and caches; then both sides timed in turns."""
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.metrics import heat_argmax
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl = ctx.wl
    wu = zoo.load("pose", (H, W, 3), apply_policy=False)
    if wu.fuse_detect or wu.policy_source != "none" or any(
            getattr(s, "fuse_next_detect", False) for s in wu.net.specs):
        raise AssertionError("apply_policy=False still fuses")
    nets = {"pose": wl.net, "pose_unfused": wu.net}
    PER_FRAME["pose_unfused"] = per_frame_launches(wu.net)
    runs, states = {}, {}
    for path, net in nets.items():
        ys, st, stats = ctx.cb_chunk(net, wl.taus, ctx.chunks[0],
                                     net.init_state(), True, stats=True,
                                     out_map=None)
        runs[path], states[path] = (ys, st, stats), st
    _same_run(torch, runs["pose"], runs["pose_unfused"], "fused vs unfused")
    ys = runs["pose"][0]
    if tuple(ys.shape) != (T,) + ctx.out_shape \
            or not bool(torch.isfinite(ys).all()):
        raise AssertionError(f"pose output {tuple(ys.shape)}")
    del runs, ys
    torch.cuda.synchronize()
    # each side streams chunks 0 (above), 1, 2 in order; the sides take
    # turns F U U F so that neither rides on the host's load
    order = ["pose", "pose_unfused", "pose_unfused", "pose"]
    series = {k: [] for k in nets}
    host = {k: [] for k in nets}
    counts = {k: {} for k in nets}
    for path, ch in zip(order, [ctx.chunks[i] for i in (1, 1, 2, 2)]):
        def run():
            states[path] = ctx.cb_chunk(nets[path], wl.taus, ch,
                                        states[path], False)[1]
        reset_launches()
        _, ms, host_ms = timed(torch, lambda: no_sync(torch, run))
        for k, v in launches().items():
            counts[path][k] = counts[path].get(k, 0) + v
        series[path].append(ms / T)
        host[path].append(host_ms / T)
    for path in nets:
        expect_launches(path, counts[path], len(series[path]) * T)
    per_frame = {k: sum(v.values()) for k, v in PER_FRAME.items()
                 if k in nets}
    emit("pose_unfused", timed_clip_seed=ctx.seed, bit_identical=True,
         order=order,
         ms_per_frame=series, host_cpu_ms_per_frame=host,
         cb_fps={k: 1e3 * len(v) / sum(v) for k, v in series.items()},
         launches=counts["pose_unfused"], launches_pose=counts["pose"],
         per_frame=PER_FRAME["pose_unfused"],
         kernel_launches_per_frame=per_frame)
    graph_path(torch, "pose_unfused", wu.net, wl.params, wl.taus,
               states["pose_unfused"], ctx.chunks, heat_argmax,
               ctx.dense_chunk)
    # the next frame's calls of B5 and B8 (the unfused net's stem and pool
    # are pose's; its 18 detects and 17 convs are not held here again)
    calls = capture_frame(torch, ctx, "pose_unfused", wu.net, wl.taus,
                          states["pose_unfused"], None, ctx.out_shape,
                          frame=ctx.chunks[3][0])
    return [c for c in calls if c[1] in ("stem_conv", "delta_pool")]


def pose_fwd_path(torch, ctx):
    """Layers 15, 16 and 20 forward their producer's hint (the tile copy
    kernel): equal to the same net re-detecting there at tau = -1."""
    from cbinfer_tpu_torch.metrics import heat_argmax
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl = ctx.wl
    net = build_net("pose_fwd", wl.specs, (H, W, 3), wl.net.cfg)
    PER_FRAME["pose_fwd"] = want = per_frame_launches(net)
    fwd = [i for i, s in enumerate(net.specs)
           if s.kind == "conv" and s.forward_hint]
    if fwd != sorted(POSE_FWD) or want.get("accept_tiles") != 3 \
            or want.get("delta_conv_detect") != 10:
        raise AssertionError(f"not the forwarding path: {fwd} {want}")
    cb = [i for i, s in enumerate(net.specs)
          if s.kind in ("conv", "pool") and s.use_cb]
    taus_ref = [-1.0 if cb[i] in POSE_FWD else t
                for i, t in enumerate(wl.taus)]
    runs = {}
    for name, n, taus in (("fwd", net, wl.taus), ("ref", wl.net, taus_ref)):
        runs[name] = ctx.cb_chunk(n, taus, ctx.chunks[0], n.init_state(),
                                  True, stats=True, out_map=None)
    (yf, sf, tf), (yr, sr, tr) = runs["fwd"], runs["ref"]
    _same_run(torch, runs["fwd"], runs["ref"], "forward-hint vs tau = -1",
              stats=False)
    for k in POSE_FWD:
        for key in ("computed_tiles", "changed_tiles", "detect_tiles"):
            if not torch.equal(tf[k][key], tr[k][key]):
                raise AssertionError(f"forward-hint layer {k}: {key} differs "
                                     "from tau = -1")
        # forwarding never inspects pixels: it reports the hinted area, 64
        # pixels a tile, where tau = -1 counts the 90-row map's bottom
        # tiles by the 2 rows they own (equal on 8-aligned maps only)
        if not torch.equal(tf[k]["changed_pixels"][1:],
                           tf[k]["detect_tiles"][1:] * 64):
            raise AssertionError(f"forward-hint layer {k}: changed_pixels "
                                 "is not the hinted area")
    state = sf
    del runs, yf, yr, sr
    series, host = [], []
    reset_launches()
    for ch in ctx.chunks[1:3]:
        def run():
            nonlocal state
            state = ctx.cb_chunk(net, wl.taus, ch, state, False)[1]
        _, ms, host_ms = timed(torch, lambda: no_sync(torch, run))
        series.append(ms / T)
        host.append(host_ms / T)
    counts = launches()
    expect_launches("pose_fwd", counts, len(series) * T)
    emit("pose_fwd", timed_clip_seed=ctx.seed, equals_tau_minus_one=True,
         forwarded_layers=fwd,
         ms_per_frame=series, host_cpu_ms_per_frame=host,
         cb_fps=1e3 * len(series) / sum(series), launches=counts,
         per_frame=want)
    graph_path(torch, "pose_fwd", net, wl.params, wl.taus, state, ctx.chunks,
               heat_argmax, ctx.dense_chunk)
    return capture_frame(torch, ctx, "pose_fwd", net, wl.taus, state, None,
                         ctx.out_shape, frame=ctx.chunks[3][0])


# ------------------------- seg and pose_graph -------------------------------


def make_workload_context(torch, np, name):
    """What a seg or pose_graph phase needs: the workload through the zoo
    with its provenance checked, its refresh cadence, a fixed timed clip of
    its video profile, and the chunk runners with the deployment out_map
    (seg: argmax, then the nearest upsample of the uint8 class map by the
    stripped layer's scale; pose_graph: the 18 heat argmaxes)."""
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.metrics import heat_argmax
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    want = WORKLOADS[name]
    wl = zoo.load(name, (H, W, 3))
    policy_ok = (wl.policy_source == "none" if want["policy"] is None
                 else wl.policy_source.endswith(want["policy"]))
    if (wl.weights != "trained(npz)" or wl.tau_source != "tuned"
            or wl.warnings or len(wl.taus) != want["n_taus"]
            or wl.fuse_detect is not want["fuse_detect"] or not policy_ok):
        raise AssertionError(
            f"zoo.load({name!r}): {wl.weights} {wl.tau_source} "
            f"{wl.policy_source} fuse_detect={wl.fuse_detect} "
            f"{len(wl.taus)} taus {wl.warnings}")
    cadence, cadence_src = zoo.load_refresh_cadence(name, T, H, W)
    pose = wl.metric == "pck"
    if pose:
        out_map, out_shape = heat_argmax, (18,)
    else:
        sh, sw = wl.upsample_scale

        def out_map(y):
            ids = y.argmax(-1).to(torch.uint8)
            return ids.repeat_interleave(sh, 0).repeat_interleave(sw, 1)
        out_shape = (H, W)

    def video(seed):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed, distinct_classes=pose,
            **workload_video_kwargs(name)))

    def cb_chunk(net, taus, ch, state, refresh, stats=False):
        return scan_video(net, wl.params, ch, state, collect_stats=stats,
                          thresholds=taus, refresh_start=refresh,
                          out_map=out_map)

    def dense_chunk(ch):
        return torch.stack([out_map(wl.net.apply_dense(wl.params, f))
                            for f in ch])

    tv = video(POSE_TIMED_SEED)
    warm = torch.from_numpy(tv.clip(T)).cuda()
    chunks = [torch.from_numpy(tv.clip(T)).cuda() for _ in range(POSE_CHUNKS)]
    return types.SimpleNamespace(
        name=name, wl=wl, seed=POSE_TIMED_SEED, cadence=cadence,
        cadence_src=cadence_src, video=video, out_map=out_map,
        out_shape=out_shape, cb_chunk=cb_chunk, dense_chunk=dense_chunk,
        warm=warm, chunks=chunks)


def _stack_means(np, chunk_stats):
    """Per-chunk mean stats (a list or a name-keyed dict of per-layer
    dicts of floats each) -> the same container of per-counter arrays over
    the chunks."""
    first = chunk_stats[0]
    out = [(k, {q: np.array([dict(_layers(c))[k][q] for c in chunk_stats])
                for q in s}) for k, s in _layers(first)]
    return dict(out) if isinstance(first, dict) else [s for _, s in out]


def workload_accuracy(torch, np, ctx, net, taus):
    """Untimed pass over the fixed seed-0 clip: 2 chunks, a refresh prolog
    on the first, 8 cold-start frames skipped. seg: GT-mIoU of the CB and
    the dense full-resolution class maps; pose_graph: GT-PCK at alpha 0.05
    and 0.02. Returns (scores, per-chunk stats means, state, video)."""
    from cbinfer_tpu_torch.metrics import (iu_counts, merge_iu,
                                           pck_gt_from_argmax)
    av = ctx.video(0)
    state = net.init_state()
    sums = {k: [0, 0] for k in ("cb", "dense", "agree")}
    cb_arg, dn_arg, kps, valid, chunk_stats = [], [], [], [], []
    for i in range(2):
        if ctx.wl.metric == "pck":
            ch, k, v = av.clip_with_keypoints(T)
            kps.append(k)
            valid.append(v)
        else:
            ch, lab = av.clip_with_labels(T)
            lab = torch.from_numpy(lab).cuda()
        ch = torch.from_numpy(ch).cuda()
        cmap, state, st = ctx.cb_chunk(net, taus, ch, state, i == 0,
                                       stats="mean")
        dmap = ctx.dense_chunk(ch)
        means = [(k, {q: float(x) for q, x in s.items()})
                 for k, s in _layers(st)]
        chunk_stats.append(dict(means) if isinstance(st, dict)
                           else [m for _, m in means])
        if ctx.wl.metric == "pck":
            cb_arg.append(cmap.cpu())
            dn_arg.append(dmap.cpu())
            continue
        skip = 8 if i == 0 else 0
        for key, a, b in (("cb", cmap, lab), ("dense", dmap, lab),
                          ("agree", cmap, dmap)):
            it, un = iu_counts(a[skip:], b[skip:], NUM_CLASSES)
            sums[key][0] += it.cpu().numpy()
            sums[key][1] += un.cpu().numpy()
    if ctx.wl.metric == "pck":
        kps, valid = np.concatenate(kps), np.concatenate(valid)
        cb_arg, dn_arg = torch.cat(cb_arg), torch.cat(dn_arg)
        hw = (H // 8, W // 8)
        scores = {f"{name}@{alpha}": pck_gt_from_argmax(
            arg[8:], hw, kps[8:], valid[8:], 8, alpha)
            for name, arg in (("cb", cb_arg), ("dense", dn_arg))
            for alpha in (0.05, 0.02)}
    else:
        scores = {k: merge_iu(*v) for k, v in sums.items()}
    return scores, chunk_stats, state, av


def workload_path(torch, np, ctx):
    """seg or pose_graph exactly as zoo.load builds it: launches derived
    and asserted, timed CB and dense chunks, the untimed accuracy pass,
    then the graphed forms and one recorded frame for the check phase."""
    from cbinfer_tpu_torch.metrics import effective_flops_view
    from cbinfer_tpu_torch.netview import NetView
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    name, wl, net, taus = ctx.name, ctx.wl, ctx.wl.net, ctx.wl.taus
    derived = per_frame_launches(net)
    if derived != PER_FRAME[name]:
        raise AssertionError(f"{name}: the converted net gives {derived}, "
                             f"not {PER_FRAME[name]}")
    view = NetView.of(net)
    stem = view.rows[0]
    if stem.spec.backend != "patch_stem":
        raise AssertionError(f"{name}: stem {stem.spec}")
    chunks = ctx.chunks
    n_chunks = len(chunks)
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2**30
    state = net.init_state()
    state = ctx.cb_chunk(net, taus, ctx.warm, state, True)[1]
    state = ctx.cb_chunk(net, taus, ctx.warm, state, False)[1]
    ctx.dense_chunk(ctx.warm)
    torch.cuda.synchronize()
    marks = {k: [torch.cuda.Event(enable_timing=True)
                 for _ in range(n_chunks + 1)] for k in ("cb", "dense")}

    def cb_run():
        nonlocal state
        ys = None
        marks["cb"][0].record()
        for i, ch in enumerate(chunks):
            ys, state, _ = ctx.cb_chunk(net, taus, ch, state,
                                        i % ctx.cadence == 0)
            marks["cb"][i + 1].record()
        return ys

    def dense_run():
        marks["dense"][0].record()
        for i, ch in enumerate(chunks):
            dn = ctx.dense_chunk(ch)
            marks["dense"][i + 1].record()
        return dn

    def chunk_ms(key):
        m = marks[key]
        return [m[i].elapsed_time(m[i + 1]) / T for i in range(n_chunks)]

    reset_launches()
    ys, cb_ms, cb_host_ms = timed(torch, lambda: no_sync(torch, cb_run))
    counts = launches()
    n_refresh = sum(1 for i in range(n_chunks) if i % ctx.cadence == 0)
    frames = n_chunks * T
    expect_launches(name, counts, frames - n_refresh)
    want_dtype = torch.int64 if wl.metric == "pck" else torch.uint8
    if tuple(ys.shape) != (T,) + ctx.out_shape or ys.dtype != want_dtype:
        raise AssertionError(f"{name}: CB output {tuple(ys.shape)} "
                             f"{ys.dtype}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    dn, dense_ms, dense_host_ms = timed(torch, dense_run)
    if tuple(dn.shape) != tuple(ys.shape) or dn.dtype != ys.dtype:
        raise AssertionError(f"{name}: dense output {tuple(dn.shape)}")
    cb_fps, dense_fps = frames / (cb_ms / 1e3), frames / (dense_ms / 1e3)
    scores, chunk_stats, acc_state, av = workload_accuracy(torch, np, ctx,
                                                           net, taus)
    stats = _stack_means(np, chunk_stats)
    ef = effective_flops_view(view, stats, 8, 8)
    stem_stats = view.stats_of(stats, stem)
    steady = view.stats_of(chunk_stats[1], stem)  # no refresh frame
    stem_tiles = {"computed": float(np.mean(stem_stats["computed_tiles"])),
                  "n_tiles": float(np.max(stem_stats["n_tiles"])),
                  "steady_chunk_density": steady["computed_tiles"]
                  / steady["n_tiles"],
                  "overflow_share": float(np.mean(stem_stats["overflow"]))}
    density = {str(r.key): round(float(
        np.mean(view.stats_of(stats, r)["computed_tiles"])
        / np.max(view.stats_of(stats, r)["n_tiles"])), 4)
        for r in view.cb_rows()}
    if wl.metric == "pck":
        accuracy = dict(
            pck_gt=scores,
            pck_degradation={a: scores[f"dense@{a}"] - scores[f"cb@{a}"]
                             for a in (0.05, 0.02)})
    else:
        accuracy = dict(miou_gt_cb=scores["cb"],
                        miou_gt_dense=scores["dense"],
                        miou_degradation=scores["dense"] - scores["cb"],
                        miou_vs_dense=scores["agree"],
                        miou_at="full resolution (argmax, then x"
                                f"{wl.upsample_scale[0]} of the class map)")
    emit(name, path=name, timed_clip_seed=ctx.seed, cb_fps=cb_fps,
         dense_fps=dense_fps, vs_baseline=cb_fps / dense_fps,
         cb_ms_per_frame=cb_ms / frames, dense_ms_per_frame=dense_ms / frames,
         frames_timed=frames, steady_frames=frames - n_refresh,
         cb_host_cpu_ms_per_frame=cb_host_ms / frames,
         dense_host_cpu_ms_per_frame=dense_host_ms / frames,
         cb_chunk_ms_per_frame=chunk_ms("cb"),
         dense_chunk_ms_per_frame=chunk_ms("dense"),
         refresh_every_chunks=ctx.cadence, refresh_source=ctx.cadence_src,
         launches=counts, per_frame=PER_FRAME[name], **accuracy,
         accuracy_budget_not_gated=0.005,
         flop_reduction=ef["flop_reduction"],
         dense_gflop_per_frame=ef["dense_flops_per_frame"] / 1e9,
         stem_tiles=stem_tiles, computed_share_per_layer=density,
         peak_mem_gib=peak_gib, peak_mem_above_held_gib=peak_gib - held_gib,
         smi_after_cb=clocks, smi=nvidia_smi("name,power.limit"),
         weights=wl.weights, tau_source=wl.tau_source,
         policy_source=wl.policy_source, fuse_detect=wl.fuse_detect,
         taus=taus)
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"{name}: accuracy not finite: {scores}")
    if not stem_tiles["computed"] < stem_tiles["n_tiles"]:
        raise AssertionError(f"{name}: the sparse stem computed every tile: "
                             f"{stem_tiles}")
    if not ef["flop_reduction"] > 1.0:
        raise AssertionError(f"{name}: no FLOP reduction: {ef}")
    graph_path(torch, name, net, wl.params, taus, state, chunks, ctx.out_map,
               ctx.dense_chunk)
    del state
    logits = ((H // 8, W // 8, 56) if wl.metric == "pck"
              else (H // 4, W // 4, NUM_CLASSES))
    return capture_frame(torch, ctx, name, net, taus, acc_state, av, logits)


# ------------------------------ kernel checks --------------------------------


def _time_launches(torch, fn, restore, reps, sleep_cycles=2_000_000):
    """Mean device ms per call. Before each timed call the mutable inputs
    are restored and L2 is flushed (untimed); a device-side sleep keeps the
    card busy while the host enqueues, so the events bracket the call's
    own work."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    total = 0.0
    for _ in range(reps):
        restore()
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def _bound_ms(flops, nbytes):
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3, (
        "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_BYTES
        else "bytes")


def _time_pair(torch, kernel, plain, buf_k, buf_p, orig):
    """(kernel ms, plain ms) per call; ``buf_k``/``buf_p`` are the buffers
    the two update in place, restored from ``orig`` before every call."""
    return (_time_launches(torch, kernel, lambda: buf_k.copy_(orig), 20),
            _time_launches(torch, plain, lambda: buf_p.copy_(orig), 5,
                           sleep_cycles=0))


def _grid(module, idx, parts=1):
    """Blocks the wrapper of ``module`` (B1, B3, B8; B9 with the ``parts``
    of a tile) launches for list ``idx``."""
    from cbinfer_tpu_torch.ops.kernels import sm_count
    return module.walk_grid(idx.numel() * parts, sm_count(idx.device.index),
                            module.BLOCKS_PER_SM)


def _stem_walk(g, cout):
    """(blocks of 8 items B5's overflow walk covers, the blocks its wrapper
    launches)."""
    from cbinfer_tpu_torch.ops.kernels import sm_count
    from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
    walk = KSC.walk_blocks(g, cout)
    return walk, KSC.walk_grid(walk, sm_count(0), KSC.BLOCKS_PER_SM)


def _ulps(torch, a, b):
    """Largest distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        v = t.view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return int((ordered(a) - ordered(b)).abs().max())


def _window_cover_bytes(np, idx, c, g, store_shape, cin, es):
    """Bytes of the union of the listed tiles' input windows, read once."""
    cover = np.zeros(store_shape[:2], bool)
    for t in idx[:c].cpu().numpy():
        ti, tj = divmod(int(t), g.tiles_w)
        r0 = ti * g.th * g.stride[0]
        c0 = tj * g.tw * g.stride[1] + g.dx0
        cover[r0:r0 + g.win_h, c0:c0 + g.win_w] = True
    return int(cover.sum()) * cin * es


# Synthetic cases of the bf16 tile-conv kernels (B2, and B6 where the fuse
# gate holds), run by the check phase and by tests/test_torch_gpu.py:
# name -> (H, W, cin, cout, kernel, dilation, stride, (th, tw), the
# consumer's kernel). cout 512 is an 8-block cluster, 576 one whose first
# block takes two slices, 264 a ragged last slice; 90 and 180 rows are the
# pose maps' ragged heights (529 tiles: a launch of many clusters).
TILE_CONV_CASES = {
    "cout512_cluster8": (24, 48, 64, 512, 3, 1, 1, (8, 8), 3),
    "cout576_two_slices_a_block": (20, 48, 32, 576, 3, 1, 1, (8, 8), 1),
    "cout264_ragged_slice": (20, 48, 56, 264, 3, 1, 1, (8, 8), 3),
    "cin24_cout56": (20, 48, 24, 56, 3, 1, 1, (8, 8), 3),
    "cin56_cout24": (20, 48, 56, 24, 3, 1, 1, (8, 8), 1),
    "dilation2": (24, 48, 32, 128, 3, 2, 1, (8, 8), 3),
    "stride2": (40, 64, 32, 64, 3, 1, 2, (8, 8), 3),
    "tile4x8": (20, 48, 32, 64, 3, 1, 1, (4, 8), None),
    "ragged90": (90, 64, 64, 256, 3, 1, 1, (8, 8), 3),
    "ragged180": (180, 32, 128, 128, 3, 1, 1, (8, 8), 1),
    "ragged180_529_tiles": (180, 184, 64, 128, 3, 1, 1, (8, 8), 3),
    "pointwise_cout56": (90, 48, 128, 56, 1, 1, 1, (8, 8), 3),
    # pose_graph's concat readers: cin 312 is off the 16-channel k-step
    "cin312_ragged90": (90, 64, 312, 256, 3, 1, 1, (8, 8), 3),
    # seg's dilated context conv at its widths, on a 180-row map
    "dilation2_cin256": (180, 64, 256, 256, 3, 2, 1, (8, 8), 1),
    # tiles of more than 64 output pixels (the tile sweep of
    # scripts/torch_exp_variants.py): launched as their 8x8 sub-tiles
    "tile8x16": (24, 64, 32, 64, 3, 1, 1, (8, 16), None),
    "tile16x16_ragged": (44, 72, 64, 128, 3, 1, 1, (16, 16), None),
    "tile16x32_cout256": (40, 96, 128, 256, 3, 1, 1, (16, 32), None),
}


def check_tile_conv(torch, np, name):
    """One TILE_CONV_CASES case in bf16 on the card, at counts 0, 1, a
    few tiles and every tile of a capacity-long list: B2 within 2e-2 of
    its plain version, tiles not listed bit-identical, count 0 a no-op;
    B6 equal bit for bit to B2 followed by B1 (out cache, consumer cache,
    mask, npix) at tau2 0.05, -1 and 1e9, and its conv within 2e-2 of the
    plain version. Raises AssertionError; returns a summary."""
    from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
    from cbinfer_tpu_torch.ops.kernels import delta_conv as KC
    from cbinfer_tpu_torch.ops.kernels import delta_conv_detect as KF
    from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
    H, W, cin, cout, k, dil, stride, (th, tw), k2 = TILE_CONV_CASES[name]
    dt, dev = torch.bfloat16, "cuda"
    rng = np.random.default_rng(H * 1000 + cout)
    g = conv_tile_geometry((H, W, cin), (k, k), (stride, stride), (dil, dil),
                           "SAME", th, tw)
    g2 = (conv_tile_geometry((g.out_h, g.out_w, cout), (k2, k2), (1, 1),
                             (1, 1), "SAME", 8, 8) if k2 else None)
    fused = KF.fuse_gate(g, g2)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    xp = t(rng.standard_normal(g.store_shape))
    w = t(rng.standard_normal((k, k, cin, cout)) * (2.0 / (k * k * cin)) ** .5)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    out0 = t(rng.standard_normal((g.out_h_pad, g.out_w_pad, cout)))
    if fused:
        nc0 = rng.standard_normal(g2.store_shape) * 0.05
        nc0[g2.store_lo_h:g2.store_lo_h + g.out_h,
            g2.store_lo_w:g2.store_lo_w + g.out_w] += \
            out0[:g.out_h].float().cpu().numpy()
        nc0 = t(nc0)
    order = rng.permutation(g.n_tiles).astype(np.int32)
    idx = torch.from_numpy(order).to(dev)
    report = dict(case=name, n_tiles=g.n_tiles, fused=fused,
                  max_abs_err=0.0)
    for c in sorted({0, 1, min(5, g.n_tiles), g.n_tiles}):
        count = torch.tensor(c, dtype=torch.int32, device=dev)
        ok_ = KC.delta_conv(xp, idx, w, b, out0.clone(), g, "relu", dt,
                            count=count)
        op_ = KC.delta_conv_plain(xp, idx, w, b, out0.clone(), g, "relu", dt,
                                  count=count)
        listed = torch.zeros(g.n_tiles, dtype=torch.bool, device=dev)
        listed[idx[:c].long()] = True
        keep = ~listed.view(g.tiles_h, 1, g.tiles_w, 1, 1).expand(
            g.tiles_h, th, g.tiles_w, tw, cout).reshape(ok_.shape)
        err = float((ok_.float() - op_.float()).abs().max())
        report["max_abs_err"] = max(report["max_abs_err"], err)
        if not (torch.allclose(ok_.float(), op_.float(), rtol=2e-2, atol=2e-2)
                and torch.equal(ok_[keep], out0[keep])
                and (c or torch.equal(ok_, out0))):
            raise AssertionError(f"delta_conv {name} count {c}: max abs "
                                 f"err {err} or untouched tiles written")
        if not fused:
            continue
        for tau2 in (0.05, -1.0, 1e9):
            of, nf = out0.clone(), nc0.clone()
            _, _, mf, pf = KF.delta_conv_detect(xp, idx, w, b, of, g, "relu",
                                                dt, nf, tau2, g2, count=count)
            ou, nu = out0.clone(), nc0.clone()
            KC.delta_conv(xp, idx, w, b, ou, g, "relu", dt, count=count)
            _, mu, pu = KD.detect_sparse(ou, nu, tau2, idx, count, g2)
            if not (torch.equal(of, ou) and torch.equal(nf, nu)
                    and torch.equal(mf, mu) and torch.equal(pf, pu)
                    and torch.allclose(of.float(), op_.float(), rtol=2e-2,
                                       atol=2e-2)):
                raise AssertionError(
                    f"delta_conv_detect {name} count {c} tau2 {tau2}: not "
                    "equal to delta_conv then detect_sparse")
            if tau2 == -1.0 and c == g.n_tiles \
                    and int(pf) != g.out_h * g.out_w:
                raise AssertionError(f"delta_conv_detect {name}: {int(pf)} "
                                     "pixels at tau2 = -1 on every tile")
    return report


def check_kernels(torch, np, calls):
    import torch.nn.functional as F
    from cbinfer_tpu_torch import network
    from cbinfer_tpu_torch.config import ConvSpec
    from cbinfer_tpu_torch.layers import NEG_FILL
    from cbinfer_tpu_torch.ops.delta_conv import (make_storage,
                                                  storage_interior)
    from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
    from cbinfer_tpu_torch.ops.kernels import accept as KA
    from cbinfer_tpu_torch.ops.kernels import delta_conv as KC
    from cbinfer_tpu_torch.ops.kernels import delta_conv_detect as KF
    from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP
    from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
    from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
    from cbinfer_tpu_torch.ops.kernels import pool_fused as KP
    from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
    from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD
    per = {}
    checks = []
    context = {}
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    for case in TILE_CONV_CASES:
        checks.append(dict(kernel="delta_conv+delta_conv_detect",
                           **check_tile_conv(torch, np, case)))

    def acc(path, name, ms, pms, bound, by, err):
        p = per.setdefault((path, name), dict(
            n=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, by=set()))
        p["n"] += 1
        p["ms"] += ms
        p["plain_ms"] += pms
        p["bound_ms"] += bound
        p["by"].add(by)
        p["err"] = max(p["err"], err)

    def fail_unless(ok, what):
        checks.append(what)
        if not ok:
            raise AssertionError(f"kernel check failed: {what}")

    def full_detect(mod_fn, plain_fn, name, path, li, x, st0, tau, g):
        """B4 and B7: exact on the captured inputs and at tau = -1."""
        st = st0.clone()
        _, mk, nk = mod_fn(x, st, tau, g)
        sp = st0.clone()
        _, mp, npl = plain_fn(x, sp, tau, g)
        ok = (torch.equal(st, sp) and torch.equal(mk, mp)
              and torch.equal(nk, npl))
        sa, sb = st0.clone(), st0.clone()
        _, ma, na = mod_fn(x, sa, -1.0, g)
        _, mb, nb = plain_fn(x, sb, -1.0, g)
        oka = (torch.equal(sa, sb) and torch.equal(ma, mb)
               and torch.equal(na, nb) and int(na) == g.in_h * g.in_w
               and bool((ma == 1).all()))
        fail_unless(ok and oka, dict(
            kernel=name, path=path, call=li, exact=ok,
            tau_minus_one_exact=oka, npix=int(nk),
            marked=int(mk.sum()), of=mk.numel()))
        ms, pms = _time_pair(torch, lambda: mod_fn(x, st, tau, g),
                             lambda: plain_fn(x, sp, tau, g), st, sp, st0)
        es, C = st0.element_size(), st0.shape[-1]
        nbytes = (g.in_h * g.in_w * C * (x.element_size() + es)
                  + int(nk) * C * es + mk.numel() * 4 + 4)
        err = float((st.float() - sp.float()).abs().max())
        acc(path, name, ms, pms, *_bound_ms(0.0, nbytes), err)

    for li, (path, name, args, kw) in enumerate(calls):
        if name == "detect_sparse":
            x, st0, tau, idx, count, g = args
            st = st0.clone()
            _, mk, nk = KD.detect_sparse(x, st, tau, idx, count, g)
            sp = st0.clone()
            _, mp, npl = KD.detect_sparse_plain(x, sp, tau, idx, count, g)
            err = float((st.float() - sp.float()).abs().max())
            ok = (torch.equal(st, sp) and torch.equal(mk, mp)
                  and torch.equal(nk, npl))
            # count = 0 is a no-op
            s0 = st0.clone()
            _, m0, n0 = KD.detect_sparse(x, s0, tau, idx, zero, g)
            ok0 = torch.equal(s0, st0) and not m0.any() and int(n0) == 0
            # all hint tiles dirty, the clamped bottom row included
            n_hint = -(-g.in_h // 8) * (g.in_w // 8)
            ia = torch.arange(n_hint, dtype=torch.int32, device="cuda")
            ca = torch.tensor(n_hint, dtype=torch.int32, device="cuda")
            xa = x.clone()
            xa[:g.in_h, :g.in_w] += (torch.rand(g.in_h, g.in_w, 1,
                                                device="cuda") < 0.1) * 0.5
            sa, sb = st0.clone(), st0.clone()
            _, ma, na = KD.detect_sparse(xa, sa, tau, ia, ca, g)
            _, mb, nb = KD.detect_sparse_plain(xa, sb, tau, ia, ca, g)
            oka = (torch.equal(sa, sb) and torch.equal(ma, mb)
                   and torch.equal(na, nb))
            fail_unless(ok and ok0 and oka, dict(
                kernel=name, path=path, call=li, exact=ok, count0_noop=ok0,
                all_dirty_exact=oka, clamped=g.in_h % 8 != 0,
                pool_geometry=g.stride != (1, 1), count=int(count),
                npix=int(nk), grid=_grid(KD, idx),
                all_dirty_above_grid=n_hint > _grid(KD, ia)))
            ms, pms = _time_pair(
                torch, lambda: KD.detect_sparse(x, st, tau, idx, count, g),
                lambda: KD.detect_sparse_plain(x, sp, tau, idx, count, g),
                st, sp, st0)
            c = int(count)
            hm = torch.zeros(n_hint, dtype=torch.bool, device="cuda")
            hm[idx[:c].long()] = True
            own = int(hm.view(-1, g.in_w // 8).repeat_interleave(8, 0)
                      [:g.in_h].sum()) * 8
            C, es = st0.shape[-1], st0.element_size()
            nbytes = (2 * own * C * es + int(nk) * C * es
                      + g.tiles_h * g.tiles_w * 4 + c * 4 + 8)
            acc(path, name, ms, pms, *_bound_ms(0.0, nbytes), err)
        elif name == "delta_conv":
            xp, idx, w, b, out0, g, act, cd = args
            count = kw["count"]
            ok_ = KC.delta_conv(xp, idx, w, b, out0.clone(), g, act, cd,
                                count=count)
            op_ = KC.delta_conv_plain(xp, idx, w, b, out0.clone(), g, act,
                                      cd, count=count)
            c = int(count)
            touched = torch.zeros(g.n_tiles, dtype=torch.bool, device="cuda")
            touched[idx[:c].long()] = True
            tmask = touched.view(g.tiles_h, 1, g.tiles_w, 1, 1)
            cout = w.shape[-1]

            def tiled(t):
                return t.view(g.tiles_h, g.th, g.tiles_w, g.tw, cout)
            err = float((ok_.float() - op_.float()).abs().max())
            close = torch.allclose(ok_.float(), op_.float(), rtol=2e-2,
                                   atol=2e-2)
            kept = torch.equal(
                torch.where(tmask, torch.zeros_like(tiled(ok_)), tiled(ok_)),
                torch.where(tmask, torch.zeros_like(tiled(out0)),
                            tiled(out0)))
            z = KC.delta_conv(xp, idx, w, b, out0.clone(), g, act, cd,
                              count=zero)
            ok0 = torch.equal(z, out0)
            fail_unless(close and kept and ok0, dict(
                kernel=name, path=path, call=li, max_abs_err=err,
                within_2e2=close, untouched_bit_identical=kept,
                count0_noop=ok0, count=c))
            out_k, out_p = out0.clone(), out0.clone()
            ms, pms = _time_pair(
                torch, lambda: KC.delta_conv(xp, idx, w, b, out_k, g, act, cd,
                                             count=count),
                lambda: KC.delta_conv_plain(xp, idx, w, b, out_p, g, act, cd,
                                            count=count),
                out_k, out_p, out0)
            kh, kw_ = g.kernel
            cin = g.cin
            es = xp.element_size()
            flops = 2 * g.th * g.tw * kh * kw_ * cin * cout * c
            nbytes = (_window_cover_bytes(np, idx, c, g, xp.shape, cin, es)
                      + c * g.th * g.tw * cout * es
                      + w.numel() * es + cout * 4 + c * 4)
            acc(path, name, ms, pms, *_bound_ms(flops, nbytes), err)
        elif name == "detect_pool_fused":
            x, out0, idx, count, g = args
            ok_, mk = KP.detect_pool_fused(x, out0.clone(), idx, count, g,
                                           **kw)
            op_, mp = KP.detect_pool_fused_plain(x, out0.clone(), idx, count,
                                                 g, **kw)
            err = float((ok_.float() - op_.float()).abs().max())
            ok = torch.equal(ok_, op_) and torch.equal(mk, mp)
            z, m0 = KP.detect_pool_fused(x, out0.clone(), idx, zero, g, **kw)
            ok0 = torch.equal(z, out0) and not m0.any()
            # every block of the map: more entries than the grid has blocks
            n_blk = (g.in_h // kw["hint_h"]) * (g.in_w // kw["hint_w"])
            ia = torch.arange(n_blk, dtype=torch.int32, device="cuda")
            ca = torch.tensor(n_blk, dtype=torch.int32, device="cuda")
            ya, ma = KP.detect_pool_fused(x, out0.clone(), ia, ca, g, **kw)
            yb, mb = KP.detect_pool_fused_plain(x, out0.clone(), ia, ca, g,
                                                **kw)
            oka = torch.equal(ya, yb) and torch.equal(ma, mb)
            fail_unless(ok and ok0 and oka, dict(
                kernel=name, path=path, call=li, exact=ok, count0_noop=ok0,
                all_blocks_exact=oka, count=int(count), grid=_grid(KP, idx),
                all_blocks_above_grid=n_blk > _grid(KP, ia)))
            out_k, out_p = out0.clone(), out0.clone()
            ms, pms = _time_pair(
                torch, lambda: KP.detect_pool_fused(x, out_k, idx, count, g,
                                                    **kw),
                lambda: KP.detect_pool_fused_plain(x, out_p, idx, count, g,
                                                   **kw),
                out_k, out_p, out0)
            c, C, es = int(count), out0.shape[-1], out0.element_size()
            nbytes = (c * (kw["hint_h"] * kw["hint_w"]
                           + kw["hint_h"] * kw["hint_w"] // 4) * C * es
                      + g.tiles_h * g.tiles_w * 4 + c * 4)
            acc(path, name, ms, pms, *_bound_ms(0.0, nbytes), err)
        elif name == "stem_detect":
            x, st0, tau, g = args
            full_detect(KSD.stem_detect, KSD.stem_detect_plain, name, path,
                        li, x, st0, tau, g)
        elif name == "detect_full":
            x, st0, tau, g = args
            full_detect(KDF.detect_full, KDF.detect_full_plain, name, path,
                        li, x, st0, tau, g)
            # a map off the 8-pixel grid (the kernel clips at the edge):
            # the same layer on this input less 4 rows and 4 columns
            gu = conv_tile_geometry(
                (g.in_h - 4, g.in_w - 4, g.cin), g.kernel, g.stride,
                g.dilation, "SAME" if g.pad_lo_h else "VALID", g.th, g.tw)
            fill = 0.0 if g.pad_lo_h else NEG_FILL  # conv / pool margins
            su = make_storage(gu, 0.0, fill, st0.dtype, "cuda")
            storage_interior(su, gu).copy_(
                storage_interior(st0, g)[:gu.in_h, :gu.in_w])
            sa, sb = su.clone(), su.clone()
            _, ma, na = KDF.detect_full(x, sa, tau, gu)
            _, mb, nb = KDF.detect_full_plain(x, sb, tau, gu)
            fail_unless(
                torch.equal(sa, sb) and torch.equal(ma, mb)
                and torch.equal(na, nb) and int(na) > 0,
                dict(kernel=name, path=path, call=li, unaligned_exact=True,
                     map=[gu.in_h, gu.in_w], npix=int(na),
                     marked=int(ma.sum()), of=ma.numel()))
        elif name == "stem_conv":
            st, idx, count, w, b, out0, g, act, cd = args
            cap = kw["capacity"]
            cout = w.shape[-1]
            c = int(count)
            ok_ = KSC.stem_conv(st, idx, count, w, b, out0.clone(), g, act,
                                cd, capacity=cap)
            op_ = KSC.stem_conv_plain(st, idx, count, w, b, out0.clone(), g,
                                      act, cd, capacity=cap)
            ulp = _ulps(torch, ok_, op_)
            # past the capacity the kernel recomputes every tile
            touched = torch.full((g.n_tiles,), c > cap, dtype=torch.bool,
                                 device="cuda")
            touched[idx[:min(c, cap)].long()] = True
            keep = ~touched.view(g.tiles_h, 1, g.tiles_w, 1, 1)

            def tiled(t):
                return t.view(g.tiles_h, g.th, g.tiles_w, g.tw, cout)
            kept = torch.equal(tiled(ok_)[keep.expand_as(tiled(ok_))],
                               tiled(out0)[keep.expand_as(tiled(out0))])
            z = KSC.stem_conv(st, idx, zero, w, b, out0.clone(), g, act, cd,
                              capacity=cap)
            ok0 = torch.equal(z, out0)
            # overflow: one tile more than the capacity -> every tile
            over = torch.tensor(cap + 1, dtype=torch.int32, device="cuda")
            ov_k = KSC.stem_conv(st, idx, over, w, b, out0.clone(), g, act,
                                 cd, capacity=cap)
            ov_p = KSC.stem_conv_plain(st, idx, over, w, b, out0.clone(), g,
                                       act, cd, capacity=cap)
            ulp_over = _ulps(torch, ov_k, ov_p)
            # ... which is the dense conv of the accepted cache
            spec = ConvSpec(features=cout, activation=act)
            dense = network.dense_conv(storage_interior(st, g), w, b, spec,
                                       cd)
            # (another summation order: sums that cancel differ by more
            # than an ulp of their small result, so this one is absolute)
            err_dense = float((ov_k.float() - dense.float()).abs().max())
            walk, grid = _stem_walk(g, cout)
            fail_unless(
                c < g.n_tiles and ulp <= 1 and kept and ok0
                and ulp_over <= 1 and err_dense <= 2e-2,
                dict(kernel=name, path=path, call=li, max_ulps=ulp,
                     untouched_bit_identical=kept, count0_noop=ok0,
                     overflow_max_ulps=ulp_over,
                     overflow_vs_dense_conv_max_abs_err=err_dense,
                     differs_from_dense_conv=float(
                         (ov_k != dense).float().mean()),
                     count=c, capacity=cap, n_tiles=g.n_tiles, grid=grid,
                     overflow_walk_above_grid=walk > grid))
            out_k, out_p = out0.clone(), out0.clone()
            ms, pms = _time_pair(
                torch, lambda: KSC.stem_conv(st, idx, count, w, b, out_k, g,
                                             act, cd, capacity=cap),
                lambda: KSC.stem_conv_plain(st, idx, count, w, b, out_p, g,
                                            act, cd, capacity=cap),
                out_k, out_p, out0)
            es = st.element_size()
            # the tiles the call computes: every tile past the capacity
            work = g.n_tiles if c > cap else c
            work_idx = (torch.arange(work, dtype=torch.int32)
                        if c > cap else idx)
            flops = 2 * g.th * g.tw * 9 * g.cin * cout * work
            nbytes = (_window_cover_bytes(np, work_idx, work, g, st.shape,
                                          g.cin, es)
                      + work * g.th * g.tw * cout * es + w.numel() * es
                      + cout * 4 + c * 4 + 4)
            err = float((ok_.float() - op_.float()).abs().max())
            acc(path, name, ms, pms, *_bound_ms(flops, nbytes), err)
            # context, timed here and used nowhere in the port: every tile
            # through this kernel, through cuDNN's conv on the 3-channel
            # map, and through the im2col matmul of the dense stem
            if name in context:
                continue
            xi = storage_interior(st, g)
            xn = xi.permute(2, 0, 1)[None].contiguous(
                memory_format=torch.channels_last)
            wn = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bn = b.to(cd)
            context[name] = {
                "all_tiles_ms": _time_launches(
                    torch, lambda: KSC.stem_conv(st, idx, over, w, b, out_k,
                                                 g, act, cd, capacity=cap),
                    lambda: None, 10),
                "conv2d_all_tiles_ms": _time_launches(
                    torch, lambda: torch.relu_(F.conv2d(xn, wn, bn,
                                                        padding=1)),
                    lambda: None, 10),
                "im2col_all_tiles_ms": _time_launches(
                    torch, lambda: network.dense_conv(xi, w, b, spec, cd),
                    lambda: None, 10),
            }
        elif name == "delta_conv_detect":
            xp, idx, w, b, out0, g, act, cd, nc0, tau2, g2 = args
            count = kw["count"]
            c = int(count)
            cout = w.shape[-1]

            def fused(i, n, t, o, nc):
                return KF.delta_conv_detect(xp, i, w, b, o, g, act, cd, nc,
                                            t, g2, count=n)[2:]

            def pair(i, n, t, o, nc):
                KC.delta_conv(xp, i, w, b, o, g, act, cd, count=n)
                return KD.detect_sparse(o, nc, t, i, n, g2)[1:]

            ia = torch.arange(g.n_tiles, dtype=torch.int32, device="cuda")
            ca = torch.tensor(g.n_tiles, dtype=torch.int32, device="cuda")
            # against the delta conv followed by the sparse detect, bit for
            # bit: the listed tiles and every tile (the overhanging bottom
            # row of a ragged map included), tau2 tuned, -1 and 1e9
            exact, npix_all = True, None
            for i_, n_ in ((idx, count), (ia, ca)):
                for t_ in (tau2, -1.0, 1e9):
                    of, nf = out0.clone(), nc0.clone()
                    mf, pf = fused(i_, n_, t_, of, nf)
                    ou, nu = out0.clone(), nc0.clone()
                    mu, pu = pair(i_, n_, t_, ou, nu)
                    exact = (exact and torch.equal(of, ou)
                             and torch.equal(nf, nu) and torch.equal(mf, mu)
                             and torch.equal(pf, pu))
                    if i_ is ia and t_ == -1.0:
                        npix_all = int(pf)
                        exact = exact and bool((mf == 1).all())
                    if t_ == 1e9:
                        exact = exact and int(pf) == 0 and not mf.any() \
                            and torch.equal(nf, nc0)
            ulp = _ulps(torch, of, ou) if out0.dtype == torch.bfloat16 else 0
            # against the plain version: the conv within the delta conv's
            # tolerance (another summation order), and the detect exact
            # given the kernel's own out tile
            ok_, nk_ = out0.clone(), nc0.clone()
            mk, pk = fused(idx, count, tau2, ok_, nk_)
            op_, np_ = out0.clone(), nc0.clone()
            _, _, mp, pp = KF.delta_conv_detect_plain(
                xp, idx, w, b, op_, g, act, cd, np_, tau2, g2, count=count)
            err = float((ok_.float() - op_.float()).abs().max())
            close = torch.allclose(ok_.float(), op_.float(), rtol=2e-2,
                                   atol=2e-2)
            nd_ = nc0.clone()
            _, md, pd = KD.detect_sparse_plain(ok_, nd_, tau2, idx, count,
                                               g2)
            detect_exact = (torch.equal(nk_, nd_) and torch.equal(mk, md)
                            and torch.equal(pk, pd))
            plain_exact = (torch.equal(nk_, np_) and torch.equal(mk, mp)
                           and torch.equal(pk, pp))
            z_o, z_n = out0.clone(), nc0.clone()
            mz, pz = fused(idx, zero, tau2, z_o, z_n)
            ok0 = (torch.equal(z_o, out0) and torch.equal(z_n, nc0)
                   and not mz.any() and int(pz) == 0)
            fail_unless(
                exact and ulp == 0 and close and detect_exact and ok0
                and npix_all == g.out_h * g.out_w,
                dict(kernel=name, path=path, call=li,
                     equals_conv_then_detect=exact, max_ulps_vs_pair=ulp,
                     conv_max_abs_err_vs_plain=err, within_2e2=close,
                     detect_exact_vs_plain=detect_exact,
                     whole_plain_exact=plain_exact, count0_noop=ok0,
                     all_tiles_tau_minus_one_npix=npix_all,
                     map=[g.out_h, g.out_w], ragged=g.out_h % 8 != 0,
                     cin=g.cin, cout=cout, kernel_hw=list(g.kernel),
                     consumer_kernel_hw=list(g2.kernel),
                     tau2=float(tau2),
                     count=c, npix=int(pk)))
            out_k, out_p = out0.clone(), out0.clone()
            nc_k, nc_p = nc0.clone(), nc0.clone()

            def restore_k():
                out_k.copy_(out0)
                nc_k.copy_(nc0)

            def restore_p():
                out_p.copy_(out0)
                nc_p.copy_(nc0)

            ms = _time_launches(
                torch, lambda: fused(idx, count, tau2, out_k, nc_k),
                restore_k, 20)
            pms = _time_launches(
                torch, lambda: KF.delta_conv_detect_plain(
                    xp, idx, w, b, out_p, g, act, cd, nc_p, tau2, g2,
                    count=count), restore_p, 5, sleep_cycles=0)
            # the unfused pair's time on the same inputs, as context
            pair_ms = _time_launches(
                torch, lambda: pair(idx, count, tau2, out_k, nc_k),
                restore_k, 20)
            kh, kw_ = g.kernel
            es = xp.element_size()
            flops = 2 * 64 * kh * kw_ * g.cin * cout * c
            nbytes = (_window_cover_bytes(np, idx, c, g, xp.shape, g.cin, es)
                      + c * 64 * cout * es          # out tiles written
                      + c * 64 * cout * es          # consumer cache read
                      + int(pk) * cout * es         # accepted pixels
                      + w.numel() * es + cout * 4 + c * 4
                      + g2.tiles_h * g2.tiles_w * 4 + 8)
            acc(path, name, ms, pms, *_bound_ms(flops, nbytes), err)
            ctxt = context.setdefault(name, {"unfused_pair_ms": 0.0,
                                             "calls": 0})
            ctxt["unfused_pair_ms"] += pair_ms
            ctxt["calls"] += 1
        elif name == "accept_tiles":
            x, st0, idx, count, g = args
            c = int(count)
            sk = KA.accept_tiles(x, st0.clone(), idx, count, g)
            sp = KA.accept_tiles_plain(x, st0.clone(), idx, count, g)
            ok = torch.equal(sk, sp)
            ok0 = torch.equal(KA.accept_tiles(x, st0.clone(), idx, zero, g),
                              st0)
            n_hint = -(-g.in_h // 8) * (g.in_w // 8)
            ia = torch.arange(n_hint, dtype=torch.int32, device="cuda")
            ca = torch.tensor(n_hint, dtype=torch.int32, device="cuda")
            sa = KA.accept_tiles(x, st0.clone(), ia, ca, g)
            sb = KA.accept_tiles_plain(x, st0.clone(), ia, ca, g)
            interior = storage_interior(sa, g)
            oka = torch.equal(sa, sb) and torch.equal(
                interior, x[:g.in_h, :g.in_w])
            # (tile, part) pairs the blocks walk, as the wrapper splits
            es = x.element_size()
            parts = KA.part_split(8 * x.shape[-1] * es
                                  // KA.unit_bytes(x, st0, g))[0]
            fail_unless(ok and ok0 and oka, dict(
                kernel=name, path=path, call=li, exact=ok, count0_noop=ok0,
                all_tiles_exact=oka, clamped=g.in_h % 8 != 0,
                map=[g.in_h, g.in_w], channels=x.shape[-1], count=c,
                of=n_hint, parts=parts, grid=_grid(KA, idx, parts),
                all_tiles_above_grid=n_hint * parts > _grid(KA, ia, parts)))
            st_k, st_p = st0.clone(), st0.clone()
            ms, pms = _time_pair(
                torch, lambda: KA.accept_tiles(x, st_k, idx, count, g),
                lambda: KA.accept_tiles_plain(x, st_p, idx, count, g),
                st_k, st_p, st0)
            C = x.shape[-1]
            nbytes = 2 * c * 64 * C * es + c * 4 + 4
            acc(path, name, ms, pms, *_bound_ms(0.0, nbytes),
                float((sk.float() - sp.float()).abs().max()))
            if name not in context:
                # context, used nowhere in the port: the same copy as two
                # PyTorch calls over precomputed pixel indices (their
                # computation from the device-side count is not timed)
                ids = idx[:c].long()
                hw_ = g.in_w // 8
                oy = torch.clamp(ids // hw_ * 8, max=g.in_h - 8)
                ox = ids % hw_ * 8
                ar = torch.arange(8, device="cuda")
                rows = (oy[:, None] + ar)[:, :, None].expand(-1, 8, 8)
                cols = (ox[:, None] + ar)[:, None, :].expand(-1, 8, 8)
                src = (rows * x.shape[1] + cols).reshape(-1)
                dst = ((rows + g.store_lo_h) * st0.shape[1] + cols
                       + g.store_lo_w).reshape(-1)
                xf, sf = x.view(-1, C), st_k.view(-1, C)
                context[name] = {
                    "index_select_index_copy_ms": _time_launches(
                        torch, lambda: sf.index_copy_(
                            0, dst, xf.index_select(0, src)),
                        lambda: None, 10)}
                if not torch.equal(st_k, sk):
                    raise AssertionError("accept_tiles: the index_copy_ "
                                         "yardstick disagrees")
        else:  # delta_pool
            st, idx, out0, g = args
            count = kw["count"]
            c = int(count)
            ok_ = KDP.delta_pool(st, idx, out0.clone(), g, count=count)
            op_ = KDP.delta_pool_plain(st, idx, out0.clone(), g, count=count)
            ok = torch.equal(ok_, op_)
            z = KDP.delta_pool(st, idx, out0.clone(), g, count=zero)
            ok0 = torch.equal(z, out0)
            ia = torch.arange(g.n_tiles, dtype=torch.int32, device="cuda")
            ca = torch.tensor(g.n_tiles, dtype=torch.int32, device="cuda")
            oka = torch.equal(
                KDP.delta_pool(st, ia, out0.clone(), g, count=ca),
                KDP.delta_pool_plain(st, ia, out0.clone(), g, count=ca))
            fail_unless(ok and ok0 and oka, dict(
                kernel=name, path=path, call=li, exact=ok, count0_noop=ok0,
                all_tiles_exact=oka, count=c, n_tiles=g.n_tiles,
                grid=_grid(KDP, idx),
                all_tiles_above_grid=g.n_tiles > _grid(KDP, ia)))
            out_k, out_p = out0.clone(), out0.clone()
            ms, pms = _time_pair(
                torch, lambda: KDP.delta_pool(st, idx, out_k, g, count=count),
                lambda: KDP.delta_pool_plain(st, idx, out_p, g, count=count),
                out_k, out_p, out0)
            C, es = out0.shape[-1], out0.element_size()
            nbytes = (_window_cover_bytes(np, idx, c, g, st.shape, C, es)
                      + c * g.th * g.tw * C * es + c * 4 + 4)
            acc(path, name, ms, pms, *_bound_ms(0.0, nbytes),
                float((ok_.float() - op_.float()).abs().max()))
            if name not in context:
                # context: the library's pool of the WHOLE map
                xi = storage_interior(st, g).permute(2, 0, 1)[None] \
                    .contiguous(memory_format=torch.channels_last)
                context[name] = {"max_pool2d_whole_map_ms": _time_launches(
                    torch, lambda: F.max_pool2d(xi, g.kernel, g.stride),
                    lambda: None, 10)}
    if not any(c.get("pool_geometry") for c in checks
               if c["kernel"] == "detect_sparse"):
        raise AssertionError("detect_sparse was not checked on a pool")
    for name, key in (("detect_sparse", "all_dirty_above_grid"),
                      ("detect_pool_fused", "all_blocks_above_grid"),
                      ("delta_pool", "all_tiles_above_grid"),
                      ("stem_conv", "overflow_walk_above_grid"),
                      ("accept_tiles", "all_tiles_above_grid")):
        if not any(c.get(key) for c in checks if c["kernel"] == name):
            raise AssertionError(f"{name}: no list outgrew the grid")
    # what any launch of these costs at least, timed as the kernels are:
    # one fill of B1's mask-and-npix buffer (flagship spec 2) and an empty
    # one-block kernel
    floor = {"launch_floor_ms": _time_launches(
        torch, lambda: (torch.zeros(45 * 80 + 1, dtype=torch.int32,
                                    device="cuda"), torch.cuda._sleep(0)),
        lambda: None, 20)}
    for name in ("detect_sparse", "detect_pool_fused"):
        context[name] = floor
    # ... of B4: one fill of its mask-and-npix buffer (the 90 x 160 cells
    # of the 720p stem) and an empty one-block kernel
    context["stem_detect"] = {"launch_floor_ms": _time_launches(
        torch, lambda: (torch.zeros(90 * 160 + 1, dtype=torch.int32,
                                    device="cuda"), torch.cuda._sleep(0)),
        lambda: None, 20)}
    # ... and of B5, B8 and B9, which make no fill: an empty one-block
    # kernel
    floor = _time_launches(torch, lambda: torch.cuda._sleep(0),
                           lambda: None, 20)
    for name in ("stem_conv", "delta_pool", "accept_tiles"):
        context[name]["launch_floor_no_fill_ms"] = floor
    fused_ctx = context.get("delta_conv_detect")
    if fused_ctx:
        fused_ctx["unfused_pair_ms"] /= fused_ctx.pop("calls")
    emit("check", calls=checks)
    RESULTS["_per_kernel"] = per
    RESULTS["_context"] = context


# ------------------------- the workflow of slice 10 --------------------------
# import a torch module, tune its thresholds, run the command line: each
# phase resets the launch counters just before it and reads them just after


TUNE_T = 96           # frames of each calibration clip and the stress clip
TUNE_SEEDS = (7, 11)  # calibration seeds (scripts/tune_model.py's)
STRESS_SEED = 23      # the stress clip's: disjoint from both and the timed
TUNE_GRID = (0.015, 0.02, 0.03, 0.045, 0.07, 0.1, 0.15)
TUNE_BUDGETS = (0.001, 0.002, 0.005, 0.01, 0.02)
TUNE_BUDGET = 0.005
TUNE_REFRESH = 32
TUNE_SKIP = 8
IMPORT_TAU = 0.02     # flat tau of the imported (random-weight) net
# bf16 dense against module(x) in float32: the largest |diff| over the
# largest |module(x)|, and the share of argmax pixels that must agree
IMPORT_DENSE_REL = 0.03
IMPORT_DENSE_AGREE = 0.99
# CB against dense argmax on the 31 steady frames of the imported net
IMPORT_CB_AGREE = 0.98
# the tuner's dense reference (CB at tau = -1, every tile recomputed)
# against apply_dense: the same two bounds
TAU_MINUS_ONE_REL = 0.03
TAU_MINUS_ONE_AGREE = 0.999
CLI_BUDGET = 0.05     # the cli phase's --budget (see cli_phase)


def balance_phase(torch):
    """The card's achieved dense bf16 GEMM rate (torch.matmul, 8192^3) and
    device-to-device copy rate (1 GiB, read + write counted), their ratio,
    beside the data sheet's and the constant the port's cost model ships."""
    from cbinfer_tpu_torch import metrics
    n = 8192
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    c = torch.empty(n, n, device="cuda", dtype=torch.bfloat16)
    src = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)

    def rate(fn, work, reps=20):
        for _ in range(3):
            fn()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return work * reps / (e0.elapsed_time(e1) / 1e3)

    flops = rate(lambda: torch.matmul(a, b, out=c), 2.0 * n ** 3)
    bw = rate(lambda: dst.copy_(src), 2.0 * src.numel())
    del a, b, c, src, dst
    torch.cuda.empty_cache()
    emit("balance", gemm_bf16_tflops=flops / 1e12, copy_tb_per_s=bw / 1e12,
         measured_flop_per_byte=flops / bw,
         datasheet_flop_per_byte=PEAK_BF16_FLOPS / PEAK_BYTES,
         shipped_machine_balance=metrics.MACHINE_BALANCE,
         nvidia_smi=nvidia_smi("name,power.limit"))


def scene_module(torch, width=128, classes=NUM_CLASSES, seed=0):
    """scene w128 written as a torch nn.Sequential: conv + BatchNorm (random
    non-trivial running stats) + ReLU, max pools, a 1x1 head."""
    nn = torch.nn
    gen = torch.Generator().manual_seed(seed)

    def conv_bn(cin, cout):
        conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        nn.init.kaiming_normal_(conv.weight, nonlinearity="relu",
                                generator=gen)
        bn = nn.BatchNorm2d(cout)
        with torch.no_grad():
            bn.running_mean.copy_(0.1 * torch.randn(cout, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(cout, generator=gen))
            bn.weight.copy_(0.5 + torch.rand(cout, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(cout, generator=gen))
        return [conv, bn, nn.ReLU()]

    w2 = 2 * width
    head = nn.Conv2d(w2, classes, 1)
    nn.init.kaiming_normal_(head.weight, generator=gen)
    nn.init.zeros_(head.bias)
    m = nn.Sequential(*conv_bn(3, width), nn.MaxPool2d(2),
                      *conv_bn(width, w2), nn.MaxPool2d(2),
                      *conv_bn(w2, w2), *conv_bn(w2, w2), head)
    return m.eval()


def import_phase(torch, np):
    """A user's own torch module through the importer: specs_from_torch ->
    convert_flagship on the card, its dense output against module(x), one
    32-frame CB chunk against its dense argmax, and the chunk's launches,
    which must be the flagship's."""
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.convert import (convert_flagship, num_cb_layers,
                                           specs_from_torch)
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    module = scene_module(torch).cuda()
    cfg = zoo.default_pipeline_config()
    specs, params = specs_from_torch(module, device="cuda",
                                     dtype=torch.bfloat16)
    net = convert_flagship(specs, (H, W, 3), cfg)
    if (net.specs[0].backend != "patch_stem"
            or per_frame_launches(net) != PER_FRAME["flagship"]):
        raise AssertionError(f"the imported net is not the flagship's: "
                             f"{per_frame_launches(net)}")
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=0, **workload_video_kwargs("scene")))
        .clip(T)).cuda()
    with torch.no_grad():
        ref = module(clip[:4].permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    dense4 = torch.stack([net.apply_dense(params, f) for f in clip[:4]])
    rel = float((dense4.float() - ref).abs().max() / ref.abs().max())
    agree_dense = float((dense4.argmax(-1) == ref.argmax(-1))
                        .float().mean())
    taus = [IMPORT_TAU] * num_cb_layers(net.specs)
    dense = torch.stack([net.apply_dense(params, f).argmax(-1)
                         for f in clip])
    torch.cuda.synchronize()
    reset_launches()
    ys, _, _ = no_sync(torch, lambda: scan_video(
        net, params, clip, thresholds=taus, collect_stats=False,
        refresh_start=True, out_map=lambda y: y.argmax(-1)))
    torch.cuda.synchronize()
    counts = launches()
    agree_cb = float((ys[1:] == dense[1:]).float().mean())
    emit("import", module=[type(m).__name__ for m in module],
         specs=[type(s).__name__ for s in net.specs],
         backends=[getattr(s, "backend", None) for s in net.specs],
         dense_vs_module_rel_err=rel, dense_vs_module_argmax=agree_dense,
         cb_vs_dense_argmax_steady=agree_cb, tau=IMPORT_TAU,
         launches=counts, steady_frames=T - 1,
         tolerances=dict(dense_rel=IMPORT_DENSE_REL,
                         dense_argmax=IMPORT_DENSE_AGREE,
                         cb_argmax=IMPORT_CB_AGREE))
    expect_launches("flagship", counts, T - 1)
    if not (rel <= IMPORT_DENSE_REL and agree_dense >= IMPORT_DENSE_AGREE
            and agree_cb >= IMPORT_CB_AGREE):
        raise AssertionError(f"import: dense rel err {rel}, dense argmax "
                             f"{agree_dense}, CB argmax {agree_cb}")


def tune_phase(torch, np):
    """The full-width tuning of the shipped workload as
    scripts/tune_model.py's scene branch does it, then stress_validate of
    the card's vector, the shipped one and a flat 0.04 on a fresh clip."""
    from cbinfer_tpu_torch import tuner, zoo
    from cbinfer_tpu_torch.metrics import _np, miou_labels, miou_labels_device
    from cbinfer_tpu_torch.netview import NetView
    from cbinfer_tpu_torch.network import out_shapes
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    wl = zoo.load("scene", (H, W, 3))
    net, params = wl.net, wl.params
    stride = H // out_shapes(net.specs, (H, W, 3))[-1][0]

    def video(seed):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=max(24, H // 15),
            speed=4.0, noise_std=0.002, seed=seed,
            **workload_video_kwargs("scene")))

    pairs = [video(s).clip_with_labels(TUNE_T) for s in TUNE_SEEDS]
    calib = np.stack([f for f, _ in pairs])
    labels = np.stack([lab[:, ::stride, ::stride] for _, lab in pairs])
    del pairs

    def gt_metric(cb, dn, lab):
        return 1.0 - (miou_labels(dn, lab, NUM_CLASSES)
                      - miou_labels(cb, lab, NUM_CLASSES))

    def gt_metric_device(cb, dn, lab):
        return 1.0 - (miou_labels_device(dn, lab, NUM_CLASSES)
                      - miou_labels_device(cb, lab, NUM_CLASSES))

    n = len(wl.taus)
    # the dense reference the tuner uses (CB at tau = -1) against
    # apply_dense, and the device metric against the host one, on the
    # first calibration clip
    run = tuner._make_runner(net, params, TUNE_REFRESH)
    clip0 = torch.from_numpy(calib[0]).cuda()
    lab0 = torch.from_numpy(labels[0]).cuda()
    ref_cb = run(clip0, [-1.0] * n)[0]
    ref_dense = torch.stack([net.apply_dense(params, f) for f in clip0])
    m1_rel = float((ref_cb.float() - ref_dense.float()).abs().max()
                   / ref_dense.float().abs().max())
    m1_agree = float((ref_cb.argmax(-1) == ref_dense.argmax(-1))
                     .float().mean())
    ys = run(clip0, wl.taus)[0]
    s = TUNE_SKIP
    host = gt_metric(_np(ys)[s:], _np(ref_cb)[s:], labels[0][s:])
    dev = float(gt_metric_device(ys[s:], ref_cb[s:], lab0[s:]))
    del run, clip0, lab0, ref_cb, ref_dense, ys
    torch.cuda.synchronize()

    # the runners tune and stress_validate make, to count their graphs,
    # each scan between two events: the scans' own card time
    runners, make_runner, spans = [], tuner._make_runner, []

    def recording_runner(*a, **kw):
        run = make_runner(*a, **kw)
        runners.append(run)

        def timed_run(frames, taus):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = run(frames, taus)
            e1.record()
            spans.append((e0, e1, int(frames.shape[0])))
            return out
        return timed_run
    tuner._make_runner = recording_runner
    try:
        reset_launches()
        t0 = time.perf_counter()
        res = tuner.tune(net, params, calib, gt_metric,
                         device_metric_fn=gt_metric_device, labels=labels,
                         tau_grid=TUNE_GRID, budgets=TUNE_BUDGETS,
                         budget=TUNE_BUDGET, skip_frames=TUNE_SKIP,
                         refresh_every=TUNE_REFRESH)
        seconds = time.perf_counter() - t0
        counts = launches()
        tune_graphs = [dict(captures=r.graphs.captures,
                            graphs=r.graphs.info()) for r in runners]
        runners.clear()
        torch.cuda.synchronize()
        # the replays only: the first scan of the runner ran eagerly and
        # captured the graph
        replay_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in spans[1:])
        replay_frames = sum(f for _, _, f in spans[1:])
        frames_evaluated = res.evaluations * len(TUNE_SEEDS) * TUNE_T
        del calib, labels

        sf, slab = video(STRESS_SEED).clip_with_labels(TUNE_T)
        t1 = time.perf_counter()
        stress = tuner.stress_validate(
            net, params, {"card_tuned": res.thresholds, "shipped": wl.taus,
                          "flat_0.04": [0.04] * n},
            [sf], gt_metric, labels=[slab[:, ::stride, ::stride]],
            budget=TUNE_BUDGET, skip_frames=TUNE_SKIP,
            refresh_every=TUNE_REFRESH, device_metric_fn=gt_metric_device)
        stress_seconds = time.perf_counter() - t1
        stress_graphs = [dict(captures=r.graphs.captures,
                              graphs=r.graphs.info()) for r in runners]
    finally:
        tuner._make_runner = make_runner
    view = NetView.of(net)
    dead = [tuner._tau_is_dead(view, r)
            for r, row in enumerate(view.rows) if row.is_cb]
    emit("tune", T=TUNE_T, calib_seeds=list(TUNE_SEEDS),
         stress_seed=STRESS_SEED, evaluations=res.evaluations,
         seconds=seconds, ms_per_evaluated_frame=seconds * 1e3
         / frames_evaluated, tau_dead=dead, selected_taus=res.thresholds,
         shipped_taus=wl.taus, calib_metric=res.metric,
         flop_reduction=res.flop_reduction,
         cost_reduction=min(res.pareto, key=lambda p: abs(
             p["budget"] - TUNE_BUDGET))["cost_reduction"],
         pareto=res.pareto, stress_rows=stress.rows,
         stress_source=stress.source, stress_passed=stress.passed,
         stress_seconds=stress_seconds, launches=counts,
         tau_minus_one_vs_dense_rel_err=m1_rel,
         tau_minus_one_vs_dense_argmax=m1_agree,
         device_metric=dev, host_metric=host, tune_graphs=tune_graphs,
         stress_graphs=stress_graphs,
         replay_ms_per_frame=replay_ms / replay_frames,
         smi=nvidia_smi("name,power.limit"))
    # one graph per (clip shape, refresh cadence) serves the whole sweep:
    # the calibration clips share one shape, and so does the stress clip
    for what, runs, want_replays in (
            ("tune", tune_graphs,
             (res.evaluations + 1) * len(TUNE_SEEDS) - 1),
            ("stress", stress_graphs, len(stress.rows))):
        if (len(runs) != 1 or runs[0]["captures"] != 1
                or [g["replays"] for g in runs[0]["graphs"]]
                != [want_replays]):
            raise AssertionError(f"{what}: graphs {runs}, not one graph "
                                 f"replayed {want_replays} times")
    if [np.float32(t) for t in res.thresholds] != [np.float32(0.15)] * n:
        raise AssertionError(f"tune selected {res.thresholds}, not 0.15 "
                             f"x {n}")
    if not (m1_rel <= TAU_MINUS_ONE_REL and m1_agree >= TAU_MINUS_ONE_AGREE):
        raise AssertionError(f"tau = -1 against apply_dense: rel err "
                             f"{m1_rel}, argmax {m1_agree}")
    if abs(dev - host) > 1e-6:
        raise AssertionError(f"device metric {dev} != host metric {host}")
    if res.metric < 1.0 - TUNE_BUDGET - 1e-9:
        raise AssertionError(f"selected metric {res.metric} below budget")
    fr = [p["flop_reduction"] for p in sorted(res.pareto,
                                              key=lambda p: p["budget"])]
    if any(b < a for a, b in zip(fr, fr[1:])):
        raise AssertionError(f"Pareto flop_reduction falls: {fr}")
    missing = [k for k in PER_FRAME["flagship"] if not counts.get(k)]
    if missing:
        raise AssertionError(f"tune: no launch of {missing}")


def cli_phase(torch, np):
    """cli.main in this process, twice: synthetic 720p w128 bf16 with the
    tuner and the live stepper, then a .y4m file that fileio.write_y4m
    wrote."""
    import contextlib
    import io
    import tempfile
    from cbinfer_tpu_torch import cli
    from cbinfer_tpu_torch.fileio import write_y4m
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

    def call(argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out = json.loads(buf.getvalue().strip().splitlines()[0])
        want = {"model", "backend", "miou_vs_dense", "flop_reduction",
                "thresholds"}
        if rc != 0 or not want <= set(out) or out["backend"] != "cuda" \
                or not out["flop_reduction"] > 1:
            raise AssertionError(f"cli {argv}: rc {rc}, {out}")
        out["seconds"] = time.perf_counter() - t
        return out

    base = ["--model", "scene", "--width-mult", "128", "--bf16", "--json"]
    reset_launches()
    # the CLI's random-weight net scores agreement mIoU against its own
    # dense output: at the default budget of 0.005 the smallest tau of the
    # grid already costs more, and the tuner keeps tau = 0 (no reduction)
    synthetic = call(base + ["--height", str(H), "--width", str(W),
                             "--tune", "--budget", str(CLI_BUDGET),
                             "--live", "1"])
    if "live_ms_per_frame" not in synthetic:
        raise AssertionError(f"cli --live: {synthetic}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.y4m")
        write_y4m(path, SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=3)).clip(16))
        video = call(base + ["--video", path, "--frames", "16"])
    torch.cuda.synchronize()
    emit("cli", synthetic=synthetic, video=video, launches=launches())
    return capture_cli_frame(torch, synthetic["thresholds"])


def capture_cli_frame(torch, taus):
    """The CLI's synthetic net rebuilt as cli.main builds it (same seed,
    so the same random weights), streamed to a steady state, then one
    frame with its kernel calls recorded for the check phase: the shapes
    the CLI gives its kernels."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert, flagship_layers
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    specs = get_model("scene", num_classes=NUM_CLASSES, width=128)
    cfg = PipelineConfig(tile=TileConfig(8, 8), compute_dtype="bfloat16",
                         cache_dtype="bfloat16", device="cuda")
    net = convert(specs, (H, W, 3), cfg, backend_overrides=flagship_layers(
        specs, (H, W, 3), cfg)[0])
    params = init_params(specs, (H, W, 3), 0, "cuda", torch.bfloat16)
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=max(16, H // 15),
        speed=4.0, noise_std=0.002, seed=0))
    clip = torch.from_numpy(video.clip(9)).cuda()
    _, state, _ = scan_video(net, params, clip[:8], thresholds=taus,
                             collect_stats=False)
    ctx = types.SimpleNamespace(wl=types.SimpleNamespace(params=params))
    return capture_frame(torch, ctx, "cli", net, taus, state, None,
                         frame=clip[8])


# ---------------- many streams, the live source, the change rate -------------

MS_STREAMS = (4, 8)   # streams per card in the multistream phase
MS_CHUNKS = 4         # chunks of T frames per stream (their refresh: the
                      # REFRESH_scene.json cadence)
MS_STEPS = 3          # runner.step frames per stream after the clips
LIVE_STREAMS = 4      # native 720p sources behind PrefetchingSource
LIVE_WARM = 4         # untimed live steps (eager first call, capture)
LIVE_FRAMES = 64      # timed live steps
CR_CHUNKS = 4         # chunks of each change-rate point (chunk 0 refreshes)
CR_PAIRS = 2          # timed (graphed CB, graphed dense) pairs per point


def _stream_stats(stats, s, axis=0):
    """Stream ``s``'s entry of runner stats ((S,) leaves, or (T, S) with
    ``axis`` 1)."""
    def pick(v):
        return v[s] if axis == 0 else v[:, s]
    return ({k: {c: pick(v) for c, v in d.items()} for k, d in stats.items()}
            if isinstance(stats, dict)
            else [{c: pick(v) for c, v in d.items()} for d in stats])


def _first_cb_stats(stats):
    return next(d for _, d in _layers(stats) if d)


def _restore(dst_state, src_state):
    """Write a saved state into the live tensors (graphs stay bound)."""
    for (_, a), (_, b) in zip(_layers(dst_state), _layers(src_state)):
        if a is not None:
            a.in_cache.copy_(b.in_cache)
            a.out_cache.copy_(b.out_cache)


def _pairs(torch, order, units, frames):
    """Time the units in ``order`` (each a fn of its pair index), CUDA
    events around each: per kind the ms per frame, and in each pair the
    second kind's time over the first's (> 1: the first kind is faster)."""
    a, b = order[0], order[1]
    series = {a: [], b: []}
    host = {a: [], b: []}
    for i, kind in enumerate(order):
        _, ms, host_ms = timed(torch, lambda: no_sync(
            torch, lambda: units[kind](i // 2)))
        series[kind].append(ms / frames)
        host[kind].append(host_ms / frames)
    ratio = [y / x for x, y in zip(series[a], series[b])]
    return series, host, ratio


def multistream_phase(torch, np):
    """configs[4] on one card: the flagship scene net at 720p serving S
    streams (MS_STREAMS) through parallel.MultiStreamRunner, against the
    same S clips back to back through per-stream scan_video_jit."""
    from cbinfer_tpu_torch.data import NativeSpriteVideo, native_available
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.video import SpriteVideoConfig
    if not native_available():
        raise AssertionError("the native frame generator did not build")
    wl, cadence = scene_workload()
    seed = int(time.time() * 1e3) % 100000
    s_max = max(MS_STREAMS)
    t0 = time.perf_counter()
    chunks = [torch.empty((s_max, T, H, W, 3), device="cuda")
              for _ in range(MS_CHUNKS)]
    for s in range(s_max):
        video = NativeSpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed + s))
        for ch in chunks:
            ch[s].copy_(torch.from_numpy(video.clip(T)))
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    reset_launches()
    rows = [_multistream_run(torch, np, wl, chunks, S, cadence)
            for S in MS_STREAMS]
    counts = launches()
    missing = [k for k in PER_FRAME["flagship"] if not counts.get(k)]
    emit("multistream", clip_seeds=[seed, seed + s_max - 1],
         frame_source="NativeSpriteVideo", frames_seconds=frames_s,
         chunks=MS_CHUNKS, T=T, refresh_every_chunks=cadence, rows=rows,
         launches=counts, smi=nvidia_smi("name,power.limit"))
    if missing:
        raise AssertionError(f"multistream: no launch of {missing}")


def _multistream_run(torch, np, wl, chunks, S, cadence):
    from cbinfer_tpu_torch.parallel import (MultiStreamRunner,
                                            make_stream_mesh,
                                            replay_on_side_streams)
    from cbinfer_tpu_torch.runner import scan_video_jit
    net, params, taus = wl.net, wl.params, wl.taus
    out_u8 = _u8_map(torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    runner = MultiStreamRunner(net, params, n_streams=S,
                               mesh=make_stream_mesh(1), thresholds=taus,
                               out_map=out_u8, collect_stats="mean")
    alone = [scan_video_jit(net) for _ in range(S)]
    states = [net.init_state() for _ in range(S)]

    def one(s, clip, refresh=False, stats="mean"):
        return alone[s](params, clip, states[s], thresholds=taus,
                        refresh_start=refresh, collect_stats=stats,
                        out_map=out_u8)

    # identity: each stream of the runner against that stream alone, over
    # every chunk (eager first calls, captures, then replays) and steps
    for i, ch in enumerate(chunks):
        refresh = i % cadence == 0
        ys, st = runner.run_clip(ch[:S], refresh_start=refresh)
        for s in range(S):
            _same_run(torch, (ys[s], runner.states[s], _stream_stats(st, s)),
                      one(s, ch[s], refresh),
                      f"multistream S={S}: stream {s}, chunk {i}")
    for k in range(MS_STEPS):
        f = chunks[0][:S, k]
        ys, st = runner.step(f)
        for s in range(S):
            ya, _, sa = one(s, f[s][None], stats=True)
            _same_run(torch, (ys[s], runner.states[s], _stream_stats(st, s)),
                      (ya[0], states[s], _stream_stats(sa, 0)),
                      f"multistream S={S}: stream {s}, step {k}")
    want = [(T, True), (T, False), (1, False)]
    for s in range(S):
        _graph_launches("flagship", runner.scans[s].graphs.info(), want)
        _graph_launches("flagship", alone[s].graphs.info(), want)

    # side streams: the alone graphs (a pool per stream), each stream's
    # replay on a CUDA stream of its own, bit-identical to in-order replays
    # from the same states
    side = [torch.cuda.Stream() for _ in range(S)]
    snap = [_clone_state(st) for st in states]
    ref = [one(s, chunks[1][s]) for s in range(S)]
    ref_states = [_clone_state(st) for st in states]
    for st, sn in zip(states, snap):
        _restore(st, sn)
    got = replay_on_side_streams(alone, params,
                            [chunks[1][s] for s in range(S)], states, side,
                            thresholds=taus, collect_stats="mean",
                            out_map=out_u8)
    torch.cuda.synchronize()
    for s in range(S):
        _same_run(torch, (got[s][0], states[s], got[s][1]),
                  (ref[s][0], ref_states[s], ref[s][2]),
                  f"multistream S={S}: stream {s}, side stream")
    del snap, ref, ref_states, got

    def chunk(i):
        return chunks[1 + i % (MS_CHUNKS - 1)]

    def b2b(i):
        return [one(s, chunk(i)[s])[0] for s in range(S)]

    units = {"runner": lambda i: runner.run_clip(chunk(i)[:S])[0],
             "back_to_back": b2b,
             "in_order": b2b,
             "side_streams": lambda i: replay_on_side_streams(
                 alone, params, [chunk(i)[s] for s in range(S)],
                 states, side, thresholds=taus, collect_stats="mean",
                 out_map=out_u8)}
    frames = S * T
    rs, rh, r_ratio = _pairs(
        torch, ["runner", "back_to_back", "back_to_back", "runner"]
        * (GRAPH_PAIRS // 2), units, frames)
    ss, sh, s_ratio = _pairs(
        torch, ["side_streams", "in_order", "in_order", "side_streams"]
        * (GRAPH_PAIRS // 2), units, frames)
    med = {k: float(np.median(v)) for k, v in {**rs, **ss}.items()}
    row = dict(
        streams=S, identical_to_alone=True, side_identical=True,
        fps_per_card={k: 1e3 / v for k, v in med.items()},
        ms_per_frame=med,
        # throughput ratios in pairs: back-to-back ms over the runner's,
        # in-order ms over the side streams'
        runner_vs_back_to_back=float(np.median(r_ratio)),
        runner_vs_back_to_back_spread=[min(r_ratio), max(r_ratio)],
        side_vs_in_order=float(np.median(s_ratio)),
        side_vs_in_order_spread=[min(s_ratio), max(s_ratio)],
        series={**rs, **ss}, host_cpu_ms_per_frame={**rh, **sh},
        graphs_live=sum(len(r) for r in runner.graphs())
        + sum(len(a.graphs.info()) for a in alone),
        held_gib=held / 2**30,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_above_held_gib=(torch.cuda.max_memory_allocated() - held)
        / 2**30,
        reserved_gib=torch.cuda.memory_reserved() / 2**30)
    del runner, alone, states, units
    torch.cuda.empty_cache()
    return row


def live_phase(torch):
    """LIVE_STREAMS native 720p sources, each behind a PrefetchingSource,
    feed MultiStreamRunner.step (the deployment form: argmax-u8 maps, no
    stats): frames/s, and the share of next() calls that found the queue
    empty (the host source set the pace). Recorded, not gated."""
    from cbinfer_tpu_torch.data import (NativeSpriteVideo, PrefetchingSource,
                                        native_available)
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.parallel import MultiStreamRunner, make_stream_mesh
    from cbinfer_tpu_torch.video import SpriteVideoConfig
    if not native_available():
        raise AssertionError("the native frame generator did not build")
    wl, _ = scene_workload()
    seed = int(time.time() * 1e3) % 100000

    def cfg(s):
        return SpriteVideoConfig(height=H, width=W, n_sprites=4,
                                 sprite_size=48, speed=4.0, noise_std=0.002,
                                 seed=seed + s)

    video = NativeSpriteVideo(cfg(0))
    t0 = time.perf_counter()
    for _ in range(16):
        video.frame()
    gen_ms = (time.perf_counter() - t0) * 1e3 / 16
    runner = MultiStreamRunner(wl.net, wl.params, n_streams=LIVE_STREAMS,
                               mesh=make_stream_mesh(1), thresholds=wl.taus,
                               out_map=_u8_map(torch), collect_stats=False)
    reset_launches()
    sources = [PrefetchingSource(NativeSpriteVideo(cfg(s)), depth=4)
               for s in range(LIVE_STREAMS)]
    try:
        for _ in range(LIVE_WARM):
            ys, _ = runner.step([next(src) for src in sources])
        torch.cuda.synchronize()
        for src in sources:
            src.waited = src.served = 0
        t0 = time.perf_counter()
        for _ in range(LIVE_FRAMES):
            ys, _ = runner.step([next(src) for src in sources])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for src in sources:
            src.close()
    counts = launches()
    if tuple(ys.shape) != (LIVE_STREAMS, H // 4, W // 4) \
            or ys.dtype != torch.uint8:
        raise AssertionError(f"live: outputs {tuple(ys.shape)} {ys.dtype}")
    missing = [k for k in PER_FRAME["flagship"] if not counts.get(k)]
    emit("live", streams=LIVE_STREAMS, steps=LIVE_FRAMES,
         frames_per_s=LIVE_STREAMS * LIVE_FRAMES / wall,
         ms_per_step=wall * 1e3 / LIVE_FRAMES,
         waited_share=sum(s.waited for s in sources)
         / sum(s.served for s in sources),
         generator_ms_per_frame=gen_ms, clip_seed=seed,
         graphs_live=sum(len(r) for r in runner.graphs()), launches=counts)
    if missing:
        raise AssertionError(f"live: no launch of {missing}")


def changerate_phase(torch, np):
    """scripts/torch_bench_changerate.py's sweep on the card: the flagship
    at 720p over its seven points (clips from a clock seed), graphed CB
    against graphed dense in alternating pairs on frames made before
    timing; per point the stem's changed-tile share, the overflow rate,
    both fps, their ratio, the agreement mIoU and pixel agreement with
    dense and the GT-mIoU of both (recorded), gated on the repo's budget:
    GT-mIoU(dense) - GT-mIoU(CB) <= 0.005 at every point (the twin's
    ``gate``); then the interpolated break-even changed share. Every
    point's replay is held bit for bit against the eager loop."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    cr = _load_script("torch_bench_changerate")
    seed = cr.clock_seed()
    reset_launches()
    rec = cr.sweep(seed, H, W, T, CR_CHUNKS, CR_PAIRS,
                   log=lambda m: print(m, flush=True))
    counts = launches()
    rows = [{k: v for k, v in r.items() if k != "class_iou"}
            for r in rec["rows"]]
    low = {r["point"]: [(i + 1, c["cls"], c["iou"], c["cb_pixels"],
                         c["dense_pixels"])
                        for i, ch in enumerate(r["class_iou"]) for c in ch
                        if c["iou"] is not None and c["iou"] < 0.9]
           for r in rec["rows"]}
    emit("changerate", clip_seed=seed, chunks=CR_CHUNKS, T=T,
         refresh_every_chunks=rec["refresh_cadence_chunks"], rows=rows,
         classes_below_0_9={k: v for k, v in low.items() if v},
         break_even_changed_tile_frac=rec["break_even_changed_tile_frac"],
         seconds_with_frames=rec["seconds_with_frames"], launches=counts,
         smi=nvidia_smi("name,power.limit"))
    if rec["points_over_budget"]:
        raise AssertionError(f"changerate: GT-mIoU degradation over "
                             f"{cr.GT_BUDGET} at "
                             f"{rec['points_over_budget']}")
    if not all(r["graph_identical_to_eager"] for r in rows):
        raise AssertionError("changerate: a point skipped the eager check")
    missing = [k for k in PER_FRAME["flagship"] if not counts.get(k)]
    if missing:
        raise AssertionError(f"changerate: no launch of {missing}")


def dryrun_phase(torch):
    """parallel.dryrun_multistream over every card of the machine: the
    plain-stem flagship, the kernel path and the pose_graph DAG, one
    stream per card."""
    from cbinfer_tpu_torch.graph import convert_graph_flagship
    from cbinfer_tpu_torch.models.pose import pose_graph
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.parallel import dryrun
    n = torch.cuda.device_count()
    reset_launches()
    shapes = dryrun.dryrun_multistream(n)
    torch.cuda.synchronize()
    counts = launches()
    nodes, out = pose_graph(width=8)
    dag = per_frame_launches(convert_graph_flagship(
        nodes, (dryrun.GRAPH_H, dryrun.GRAPH_W, 3),
        dryrun.pipeline_config(torch.device("cuda", 0)), output=out))
    expected = set(PER_FRAME["flagship"]) | set(dag)
    missing = sorted(k for k in expected if not counts.get(k))
    emit("dryrun", devices=n, shapes={k: list(v) for k, v in shapes.items()},
         dag_per_frame=dag, launches=counts)
    if missing:
        raise AssertionError(f"dryrun: no launch of {missing}")


# ------------------------------ train, bench ---------------------------------

TRAIN_CUT_STEPS = 300   # pose and pose_graph here (their recipes: 3000)
TRAIN_ACC = 0.95        # scene's final train accuracy (the TPU run: 1.000)
TRAIN_DENSE_MIOU = 0.95  # dense GT-mIoU of the served net (shipped: 0.9998)
TRAIN_CHUNKS = 3        # served chunks of T frames (the first refreshes)
BENCH_SEED = 0          # of make_clips' video in the bench phase
BENCH_AGREEMENT = 0.995  # the repo's budget: CB's mIoU against dense


def _train_row(r):
    loss = r["losses"]
    first = float(sum(loss[:20]) / len(loss[:20]))
    last = float(sum(loss[-20:]) / len(loss[-20:]))
    row = {"steps": r["steps"], "ms_per_step": r["ms_per_step"],
           "steady_ms_per_step": r["steady_ms_per_step"],
           "seconds": r["seconds"], "data_seconds": r["data_seconds"],
           "steps_seconds": r["seconds"] - r["data_seconds"],
           "loss_first20": first, "loss_last20": last,
           r["metric"]: r[r["metric"]]}
    if not last < first:
        raise AssertionError(f"training loss did not fall: {row}")
    return row


def train_phase(torch, np):
    """scripts/torch_train.py's recipes on the card: scene at its whole
    recipe, served at 720p through the flagship, the npz round trip; pose
    and pose_graph cut to TRAIN_CUT_STEPS steps."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_train
    from cbinfer_tpu_torch import checkpoint, zoo
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.metrics import iu_counts, merge_iu
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.runner import scan_video_jit
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    precision = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                 "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    r = torch_train.train_workload("scene", device="cuda")
    rows = {"scene": _train_row(r)}
    if not r["train_acc"] >= TRAIN_ACC:
        raise AssertionError(f"scene train accuracy {r['train_acc']} < "
                             f"{TRAIN_ACC}")

    # serve the trained net in bf16 through the flagship, tuned taus
    specs = get_model("scene", num_classes=NUM_CLASSES, width=128)
    cfg = zoo.default_pipeline_config()
    taus = checkpoint.load_thresholds(
        os.path.join(REPO, "ckpts", "scene_w128_tau.json"))
    net = convert_flagship(specs, (H, W, 3), cfg, thresholds=taus)
    params = checkpoint.params_from_numpy(
        specs, [None if p is None else tuple(t.cpu().numpy() for t in p)
                for p in r["params"]], "cuda", torch.bfloat16)
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=0))
    clips = [video.clip_with_labels(T) for _ in range(TRAIN_CHUNKS)]
    out_u8 = _u8_map(torch)
    run = scan_video_jit(net)
    state = net.init_state()
    sums = {k: [0, 0] for k in ("cb", "dense", "agree")}
    reset_launches()
    for i, (fr, lab) in enumerate(clips):
        ch = torch.from_numpy(fr).cuda()
        lab = torch.from_numpy(lab[:, ::4, ::4]).cuda()
        cmap = no_sync(torch, lambda: run(
            params, ch, state, thresholds=taus, refresh_start=i == 0,
            collect_stats=False, out_map=out_u8)[0])
        dmap = torch.stack([out_u8(net.apply_dense(params, f)) for f in ch])
        skip = 8 if i == 0 else 0  # cold start is exact by construction
        for key, a, b in (("cb", cmap, lab), ("dense", dmap, lab),
                          ("agree", cmap, dmap)):
            it, un = iu_counts(a[skip:], b[skip:], NUM_CLASSES)
            sums[key][0] += it.cpu().numpy()
            sums[key][1] += un.cpu().numpy()
    torch.cuda.synchronize()
    counts = launches()
    # eager first call and capture of the refresh and the steady key, then
    # replays (which bypass the counters)
    expect_launches("flagship", counts, 2 * (T - 1) + 2 * T)
    _graph_launches("flagship", run.graphs.info(), [(T, True), (T, False)])
    miou = {k: merge_iu(*v) for k, v in sums.items()}

    # the npz writer and load_npz_params: one served chunk bit-identical
    path = os.path.join(REPO, "build", "smoke_train", "scene_w128.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    checkpoint.save_npz_params(path, r["params"])
    reloaded = checkpoint.load_npz_params(path, params, specs)
    same_params = all(p is None or (torch.equal(p[0], q[0])
                                    and torch.equal(p[1], q[1]))
                      for p, q in zip(params, reloaded))
    ch = torch.from_numpy(clips[0][0]).cuda()
    chunk = [scan_video_jit(net)(ps, ch, net.init_state(), thresholds=taus,
                                 refresh_start=True, out_map=out_u8)[0]
             for ps in (params, reloaded)]
    if not (same_params and torch.equal(*chunk)):
        raise AssertionError("the npz round trip changed the served chunk")
    del run, state, params, reloaded, chunk, r
    torch.cuda.empty_cache()

    for name in ("pose", "pose_graph"):
        rows[name] = _train_row(torch_train.train_workload(
            name, steps=TRAIN_CUT_STEPS, device="cuda"))
    emit("train", in_shape=list(torch_train.IN_SHAPE), rows=rows,
         precision=precision, served_clip_seed=0, served_chunks=TRAIN_CHUNKS,
         miou_gt_cb=miou["cb"], miou_gt_dense=miou["dense"],
         miou_degradation=miou["dense"] - miou["cb"],
         within_budget=miou["dense"] - miou["cb"] <= 0.005,
         miou_vs_dense=miou["agree"], launches=counts,
         npz_round_trip_identical=True, taus=taus,
         smi=nvidia_smi("name,power.limit"))
    if not miou["dense"] >= TRAIN_DENSE_MIOU:
        raise AssertionError(f"dense GT-mIoU of the trained net "
                             f"{miou['dense']} < {TRAIN_DENSE_MIOU}")


def bench_phase(torch, np):
    """benchmark.bench_network on the flagship at 720p over
    make_clips(RunConfig(...), 3): the graphed dense baseline against
    scan_video_jit, the refresh cadence of REFRESH_scene.json."""
    import dataclasses
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.benchmark import bench_network, make_clips
    from cbinfer_tpu_torch.config import RunConfig
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    wl, cadence = scene_workload()
    rc = RunConfig(model="scene", height=H, width=W, frames=T,
                   seed=BENCH_SEED, pipeline=zoo.default_pipeline_config())
    clips = make_clips(rc, 3)
    reset_launches()
    res = bench_network(wl.net, wl.params, clips, metric="miou",
                        num_classes=NUM_CLASSES, thresholds=wl.taus,
                        refresh_every=cadence * T, run_config=rc)
    torch.cuda.synchronize()
    counts = launches()
    print(res.to_json(), flush=True)
    g = RESULTS["graph_flagship"]
    emit("bench", result=dataclasses.asdict(res), headline=res.headline(),
         refresh_every=cadence * T, launches=counts,
         graph_flagship={k: g[k] for k in (
             "graph_fps", "graph_ms_per_frame", "dense_fps",
             "graph_vs_baseline")},
         smi=nvidia_smi("name,power.limit"))
    missing = [k for k in PER_FRAME["flagship"] if not counts.get(k)]
    if missing:
        raise AssertionError(f"bench: no launch of {missing}")
    if not (res.flop_reduction > 1
            and res.metric_value >= BENCH_AGREEMENT):
        raise AssertionError(f"bench: flop_reduction {res.flop_reduction},"
                             f" metric {res.metric_value}")


# ------------------------- the other layer backends --------------------------

# the backends phase's forms of the scene net: (pipeline backend, stem
# override, dtype); "torch" is the capacity-bounded plain backend (the JAX
# package's "jnp"), whose flagship stem is dense_cached
BACKEND_FORMS = {
    "flagship": ("cuda", None, "bfloat16"),
    "band_stem": ("cuda", {0: "band_cached"}, "bfloat16"),
    "flat_stem": ("cuda", {0: "dense_cached_flat"}, "bfloat16"),
    "torch_f32": ("torch", None, "float32"),
    "torch_bf16": ("torch", None, "bfloat16"),
}
BOUNDED_FORMS = ("band_stem", "torch_f32", "torch_bf16")
BK_ACC_CHUNKS = 2     # seed-0 chunks of the GT-mIoU pass (chunk 0 refreshes)
BK_PAN = (4.0, 8.0)   # the pan clip's camera, px/frame (changerate's pan_fast)
BK_PAN_SEED = 5
BK_REPLAYS = 3        # timed replays of a steady chunk per form
# the band and flat stems' out caches against the dense_cached stem's on
# the same frames: the band path rounds its float32 sum plus bias to bf16
# once; the dense conv's bf16 GEMM may round the dot product before its
# bias is added (the CPU's does). So within one bf16 ulp of the pre-bias
# dot product: 2^-7 (|larger output| + |bias|), plus an absolute 1e-4 for
# the float32 summation order. An ulp count of the outputs themselves is
# meaningless where a sum cancels next to zero (0 and 1e-7 are ~13000 bf16
# ulps apart, the ReLU clamping one side)
BK_STEM_RTOL = 2.0 ** -7
BK_STEM_ATOL = 1e-4
BK_BUDGET = 0.005     # GT-mIoU of dense minus that of the form


def _load_script(name):
    """A scripts/ twin as a module (its main() is not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backends_phase(torch, np):
    """The scene net (zoo.load, trained weights, shipped taus, 720p) on
    each of BACKEND_FORMS: GT-mIoU of CB and dense over the seed-0 clip,
    the overflow frames per layer and computed tiles on a panning clip,
    eager and graphed ms/frame of a steady chunk, the kernel launches of a
    steady chunk (PER_FRAME[form]), replays equal to the eager loop, and
    the band and flat stems' caches against the dense_cached stem's."""
    import dataclasses
    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.metrics import iu_counts, merge_iu
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    vk = workload_video_kwargs("scene")
    out_u8 = _u8_map(torch)

    def video(seed, pan=(0.0, 0.0)):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed, pan=pan, **vk))

    av = video(0)
    acc = []
    for _ in range(BK_ACC_CHUNKS):
        f, lab = av.clip_with_labels(T)
        acc.append((torch.from_numpy(f).cuda(), torch.from_numpy(
            np.ascontiguousarray(lab[:, ::4, ::4])).cuda()))
    pan = torch.from_numpy(video(BK_PAN_SEED, BK_PAN).clip(T)).cuda()
    base = zoo.default_pipeline_config()
    total = {}
    rows, stems = {}, {}
    forms = dict(BACKEND_FORMS,
                 dense_stem=("cuda", {0: "dense_cached"}, "bfloat16"))
    for form, (backend, extra, dt) in forms.items():
        cfg = dataclasses.replace(base, backend=backend, compute_dtype=dt,
                                  cache_dtype=dt)
        wl = zoo.load("scene", (H, W, 3), cfg)
        if wl.weights != "trained(npz)" or wl.tau_source != "tuned":
            raise AssertionError(f"{form}: {wl.weights} {wl.tau_source}")
        net = wl.net if extra is None else convert_flagship(
            wl.specs, (H, W, 3), cfg, extra_overrides=extra)
        params, taus = wl.params, wl.taus
        # GT-mIoU over the seed-0 chunks (a refresh prolog on chunk 0, the
        # REFRESH_scene.json cadence), the stem's stats kept
        sums = {k: [0, 0] for k in ("cb", "dense")}
        state = net.init_state()
        stem_stats = []
        for i, (ch, lab) in enumerate(acc):
            cmap, state, st = scan_video(net, params, ch, state,
                                         thresholds=taus,
                                         refresh_start=i == 0,
                                         out_map=out_u8)
            stem_stats.append({k: v.cpu().tolist() for k, v in st[0].items()
                               if k in ("changed_tiles", "changed_pixels",
                                        "detect_tiles")})
            dmap = torch.stack([out_u8(net.apply_dense(params, f))
                                for f in ch])
            skip = 8 if i == 0 else 0
            for key, m in (("cb", cmap), ("dense", dmap)):
                it, un = iu_counts(m[skip:], lab[skip:], NUM_CLASSES)
                sums[key][0] += it.cpu().numpy()
                sums[key][1] += un.cpu().numpy()
        miou = {k: merge_iu(*v) for k, v in sums.items()}
        if form in ("band_stem", "flat_stem", "dense_stem"):
            stems[form] = (state[0].out_cache.clone(), stem_stats)
        if form == "dense_stem":
            stem_bias = params[0][1].float().abs()
            del state
            continue
        # a steady chunk eagerly: launches and ms/frame, no host sync
        s_t = _clone_state(state)
        reset_launches()
        _, eager_ms, eager_host = timed(torch, lambda: no_sync(
            torch, lambda: scan_video(net, params, acc[1][0], s_t,
                                      collect_stats=False, thresholds=taus,
                                      out_map=out_u8)))
        counts = launches()
        expect_launches(form, counts, T)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        # the panning clip from the steady state: overflow frames per
        # layer (frame 0 is a new scene: frames 1..T-1 counted) and the
        # computed share of each layer
        _, _, ps = scan_video(net, params, pan, s_t, thresholds=taus)
        overflow = [int(s["overflow"][1:].sum()) if s else None for s in ps]
        computed = [float(s["computed_tiles"][1:].float().mean()
                          / s["n_tiles"][0]) if s else None for s in ps]
        del s_t
        # graphs: replays equal the eager loop (refresh, steady, the pan)
        s_e, s_g = _clone_state(state), _clone_state(state)
        run = scan_video_jit(net)
        for i, (refresh, ch) in enumerate(((True, acc[0][0]),
                                           (False, acc[1][0]),
                                           (False, pan))):
            eager = scan_video(net, params, ch, s_e, thresholds=taus,
                               refresh_start=refresh)
            graphed = no_sync(torch, lambda: run(
                params, ch, s_g, thresholds=taus, refresh_start=refresh))
            _same_run(torch, eager, graphed, f"{form}: graph vs eager, "
                      f"chunk {i}")
        del eager, graphed, s_e

        def replay():
            return run(params, acc[1][0], s_g, thresholds=taus,
                       collect_stats=False, out_map=out_u8)[0]
        replay()  # the key's eager call, then its capture
        replay()
        graph_ms = [timed(torch, lambda: no_sync(torch, replay))[1] / T
                    for _ in range(BK_REPLAYS)]
        rows[form] = dict(
            backends=[getattr(sp, "backend", None) for sp in net.specs],
            dtype=dt, miou_gt_cb=miou["cb"], miou_gt_dense=miou["dense"],
            miou_degradation=miou["dense"] - miou["cb"],
            eager_ms_per_frame=eager_ms / T,
            eager_host_cpu_ms_per_frame=eager_host / T,
            graph_ms_per_frame=float(np.median(graph_ms)),
            graph_ms_per_frame_all=graph_ms, launches=counts,
            pan_overflow_frames=overflow, pan_computed_share=computed,
            graphed="captured, replays equal the eager loop")
        del run, s_g, state, net, wl, params
        torch.cuda.empty_cache()
    ref_cache, ref_stats = stems.pop("dense_stem")
    ref = ref_cache.float()
    stem_cmp = {}
    for f, (c, st) in stems.items():
        d = (c.float() - ref).abs()
        bound = BK_STEM_RTOL * (torch.maximum(c.float().abs(), ref.abs())
                                + stem_bias) + BK_STEM_ATOL
        stem_cmp[f] = dict(max_abs_err=float(d.max()),
                           differing_share=float((d > 0).float().mean()),
                           within_tolerance=bool((d <= bound).all()),
                           stats_equal=st == ref_stats)
    emit("backends", forms=rows, stem_vs_dense_cached=stem_cmp,
         stem_rtol=BK_STEM_RTOL, stem_atol=BK_STEM_ATOL, launches=total,
         pan=list(BK_PAN), pan_seed=BK_PAN_SEED, acc_seed=0,
         smi=nvidia_smi("name,power.limit"))
    for form, r in rows.items():
        if not r["miou_degradation"] <= BK_BUDGET:
            raise AssertionError(f"{form}: GT-mIoU degradation "
                                 f"{r['miou_degradation']} > {BK_BUDGET}")
    for form in BOUNDED_FORMS:
        if not any(rows[form]["pan_overflow_frames"][i] or 0
                   for i in range(len(rows[form]["pan_overflow_frames"]))):
            raise AssertionError(f"{form}: no overflow on the pan clip")
    if not all(c["within_tolerance"] and c["stats_equal"]
               for c in stem_cmp.values()):
        raise AssertionError(f"stems against dense_cached: {stem_cmp}")


def policy_phase(torch):
    """scripts/torch_optimize_policy.py on scene in this process with few
    reps and chunks: the band_cached stem's fps against the flagship's and
    every flip's verdict (recorded; nothing is written)."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    mod = _load_script("torch_optimize_policy")
    reset_launches()
    # three windows per arm: one slow window does not move their median
    rec = mod.optimize("scene", H, W, T, chunks=2, reps=3, seed=0,
                       log=lambda m: print(m, flush=True))
    emit("policy", **rec, launches=launches())
    if [t["mode"] for t in rec["trials"]][0] != "band_cached":
        raise AssertionError("policy: the stem trial did not come first")


def refresh_phase(torch):
    """scripts/torch_validate_refresh.py on scene and pose at 720p with a
    short horizon: 4 chunks, cadences 2 and 0, seed 0."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    mod = _load_script("torch_validate_refresh")
    reset_launches()
    out = {}
    for model, t in (("scene", T), ("pose", 12)):
        rec = mod.validate(model, H, W, t, 4, [2, 0], [0], BK_BUDGET,
                           log=lambda m: print(m, flush=True))
        out[model] = rec
        if [r["cadence"] for r in rec["rows"]] != [2, 0]:
            raise AssertionError(f"refresh {model}: rows {rec['rows']}")
    emit("refresh", **out, launches=launches())


def headline_phase(torch):
    """One scripts/torch_eval_headline.py row for scene (tuned taus, the
    seed-0 clips)."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    mod = _load_script("torch_eval_headline")
    reset_launches()
    row = mod.bench_model("scene", H, W, T, seed=0,
                          log=lambda m: print(m, flush=True))
    emit("headline", row=row, launches=launches())
    if not (row["flop_reduction"] > 1 and row["cb_fps"] > 0
            and row["miou_degradation"] <= BK_BUDGET):
        raise AssertionError(f"headline: {row}")


# ------------------ the measurement and accuracy twins ----------------------

LAT_FRAMES = 32       # timed FrameStepper frames a model (the script: 96)
LAT_MODELS = (("scene", "flagship"), ("seg", "seg"), ("pose", "pose"),
              ("pose_graph", "pose_graph"))   # (workload, its path)
LONGRUN_CHUNKS = 16   # chunks of the long stream (the script: 64)
LONGRUN_WIN = 8       # chunks a window (the script's)
FOOTAGE_FRAMES = 64   # frames of the .y4m (the script: 96)
SWEEP_SEEDS = 1       # seeds of the pose and DAG sweeps (the scripts: 4)
SWEEP_CHUNKS = 4      # chunks a sweep stream (the scripts')


def _path_run(path, fn):
    """``fn()`` with every launch counter from 0; fails unless each kernel
    of ``PER_FRAME[path]`` launched. Returns (result, counts)."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    reset_launches()
    out = fn()
    counts = launches()
    missing = [k for k in PER_FRAME[path] if not counts.get(k)]
    if missing:
        raise AssertionError(f"{path}: no launch of {missing}")
    return out, counts


def _sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _finite(np, *xs):
    return all(x is not None and bool(np.isfinite(x)) for x in xs)


def latency_phase(torch, np):
    """scripts/torch_bench_latency.py on scene, seg, pose and pose_graph at
    720p, LAT_FRAMES timed frames each: wall p50/p95, the pipelined device
    ms of CB and dense (64-frame windows), the step_chunk forms, the
    refresh and the scan form. Gated: a row per model with finite times,
    every kernel of the model's path launched."""
    from cbinfer_tpu_torch.benchmark import measure_sync_overhead
    mod = _load_script("torch_bench_latency")
    rows, counts = [], {}
    for name, path in LAT_MODELS:
        row, counts[name] = _path_run(path, lambda: mod.bench(
            name, H, W, LAT_FRAMES, log=lambda m: print(m, flush=True)))
        rows.append(row)
        torch.cuda.empty_cache()
    emit("latency", rows=rows, launches=_sum_counts(counts.values()),
         launches_by_model=counts,
         sync_overhead_ms=measure_sync_overhead() * 1e3)
    keys = ("wall_ms_p50", "wall_ms_p95", "device_ms_pipelined",
            "dense_ms_pipelined", "device_ms_chunk4", "device_ms_chunk8",
            "refresh_ms_p50", "scan_ms_per_frame")
    bad = [r["model"] for r in rows if not _finite(np, *(r[k] for k in keys))]
    if [r["model"] for r in rows] != [m for m, _ in LAT_MODELS] or bad:
        raise AssertionError(f"latency: rows {[r['model'] for r in rows]}, "
                             f"times not finite at {bad}")


def longrun_phase(torch, np):
    """scripts/torch_bench_longrun.py: one flagship stream of
    LONGRUN_CHUNKS chunks (the script's 64 cut; seed 424242, windows of
    8): per window fps, GT-mIoU of CB and dense, device memory. Gated, as
    the script's budget: the worst window's degradation <= 0.005."""
    from cbinfer_tpu_torch import zoo
    mod = _load_script("torch_bench_longrun")
    wl, cadence = scene_workload()
    rec, counts = _path_run("flagship", lambda: mod.longrun(
        wl.net, wl.params, wl.taus, cadence, H, W, T, LONGRUN_CHUNKS,
        LONGRUN_WIN, 424242, zoo.output_stride(wl, H, W),
        log=lambda m: print(m, flush=True)))
    emit("longrun", **rec, launches=counts)
    if not rec["within_budget"]:
        raise AssertionError(f"longrun: worst window degradation "
                             f"{rec['worst_window_degradation']} over "
                             f"{rec['gt_budget']}")


def pose_graph_bench_phase(torch, np):
    """scripts/torch_bench_pose_graph.py at its defaults (360x640, 12
    frames x 2 chunks, a clock seed): the DAG's fps CB and dense, GT-PCK,
    flop_reduction. Gated: finite fps, every kernel of its path
    launched."""
    mod = _load_script("torch_bench_pose_graph")
    row, counts = _path_run("pose_graph", lambda: mod.bench(
        360, 640, 12, 2, log=lambda m: print(m, flush=True)))
    emit("pose_graph_bench", row=row, launches=counts)
    if not _finite(np, row["cb_fps"], row["dense_fps"],
                   row["flop_reduction"]):
        raise AssertionError(f"pose_graph_bench: {row}")


def profile_stages_phase(torch, np):
    """scripts/torch_profile_stages.py on scene at 720p (2 chunks of 32):
    per layer prefix the CB, dense and detect-only ms a frame. Gated: a
    finite row per prefix, the flagship's kernels launched."""
    mod = _load_script("torch_profile_stages")
    rec, counts = _path_run("flagship", lambda: mod.profile(
        "scene", H, W, T, 2, log=lambda m: print(m, flush=True)))
    emit("profile_stages", **rec, launches=counts)
    keys = ("cb_ms_total", "dense_ms_total", "detect_ms_total")
    ks = [r["k"] for r in rec["rows"]]
    if not ks or ks != list(range(1, len(ks) + 1)) or not all(
            _finite(np, *(r[k] for k in keys)) for r in rec["rows"]):
        raise AssertionError(f"profile_stages: rows {rec['rows']}")


def footage_phase(torch, np):
    """scripts/torch_real_footage_demo.py with FOOTAGE_FRAMES frames (the
    script's 96 cut): the native generator's 720p clip through a .y4m,
    read back, through the flagship, CB and dense fps, agreement, then the
    CLI on the file. Gated: finite fps, the CLI's record, the flagship's
    kernels launched."""
    mod = _load_script("torch_real_footage_demo")
    rec, counts = _path_run("flagship", lambda: mod.demo(
        FOOTAGE_FRAMES, H, W, log=lambda m: print(m, flush=True)))
    emit("footage", **rec, launches=counts)
    if not (_finite(np, rec["cb_fps"], rec["dense_fps"])
            and "miou_vs_dense" in rec["cli"]):
        raise AssertionError(f"footage: {rec}")


def sweeps_phase(torch, np):
    """scripts/torch_pose_acc_sweep.py and torch_graph_acc_sweep.py at
    720p with SWEEP_SEEDS seed (the scripts' 4 cut), the tuned vector
    only, cadences 2 and 1, 4 chunks (T 12 pose, 16 the DAG): GT-PCK per
    chunk of dense and CB, PCK against dense, the degradation. Gated: a
    row per cadence, every kernel of each path launched."""
    from cbinfer_tpu_torch import zoo
    mod = _load_script("torch_pose_acc_sweep")
    out = {}
    for name, t in (("pose", 12), ("pose_graph", 16)):
        wl = zoo.load(name, (H, W, 3))
        rows, counts = _path_run(name, lambda: mod.sweep(
            wl, H, W, t, SWEEP_CHUNKS, SWEEP_SEEDS, ("tuned",), (2, 1),
            log=lambda m: print(m, flush=True)))
        out[name] = dict(rows=rows, launches=counts, T=t)
        if [r["cadence"] for r in rows] != [2, 1]:
            raise AssertionError(f"sweeps {name}: rows {rows}")
        del wl
        torch.cuda.empty_cache()
    emit("sweeps", **out,
         launches=_sum_counts(o["launches"] for o in out.values()))


def seg_repro_phase(torch, np):
    """scripts/torch_repro_seg_acc.py at its defaults (seed 65601, bf16
    caches, 2 chunks of 32 at 720p): per chunk dense and CB GT-mIoU and
    the agreement. Gated: two finite rows, seg's kernels launched."""
    mod = _load_script("torch_repro_seg_acc")
    rec, counts = _path_run("seg", lambda: mod.repro(
        log=lambda m: print(m, flush=True)))
    emit("seg_repro", **rec, launches=counts)
    if len(rec["rows"]) != 2 or not all(
            _finite(np, r["miou_gt_dense"], r["miou_gt_cb"])
            for r in rec["rows"]):
        raise AssertionError(f"seg_repro: {rec['rows']}")


# ------------- the last reference scripts' twins (queue E) -----------------

MSB_STREAMS = (4, 8)  # streams per card (the script's)
MSB_T = 8             # frames a chunk per stream (the script: 16)
EXP_CHUNKS = 3        # chunks of the A/Bs: the first warms, 2 timed
EXP_REPS = 2          # interleaved reps (the scripts: 3 or 5)
EXP_T = 16            # frames a chunk of the fused A/B and the variants
                      # (the scripts: 32)
TRACE_T = 12          # traced frames a model (the script: 24, pose 12)
TRACE_MODELS = (("scene", "flagship"), ("seg", "seg"),
                ("pose", "pose_unfused"), ("pose_graph", "pose_graph"))
TRACE_TOL = 0.02      # stage self-time sums against device busy time
POINTWISE_AGREE = 0.999   # argmax agreement, bf16 conv against matmul
# the configurations a kernel refuses on the card, with the kernel: the
# plain converter's cin = 3 stem as a CB conv on the kernel path (B7 takes
# an even channel count, B2 a multiple of 8; the converters put a
# small-cin stem on patch_stem or dense_cached)
VARIANTS_REFUSED = {"stem=cb_banded": "detect_full"}


def multistream_bench_phase(torch, np):
    """scripts/torch_bench_multistream.py at 720p, S = 4 and 8 flagship
    streams, one timed chunk of MSB_T frames a stream, 2 reps (the
    script's 2 chunks of 16 and 3 reps cut): the sequential, runner
    (gathered and not) and side-stream arms. Gated: finite rates, the
    flagship's kernels launched."""
    mod = _load_script("torch_bench_multistream")
    rec, counts = _path_run("flagship", lambda: mod.run(
        MSB_STREAMS, H, W, MSB_T, 1, EXP_REPS,
        log=lambda m: print(m, flush=True)))
    emit("multistream_bench", **rec, launches=counts)
    keys = ("sequential_fps_per_chip", "batched_fps_per_chip",
            "batched_nogather_fps_per_chip", "side_streams_fps_per_chip")
    if [r["streams"] for r in rec["rows"]] != list(MSB_STREAMS) or not all(
            _finite(np, *(r[k] for k in keys)) for r in rec["rows"]):
        raise AssertionError(f"multistream_bench: {rec['rows']}")


def profile_trace_phase(torch, np):
    """scripts/torch_profile_trace.py on scene, seg, pose and pose_graph at
    720p (TRACE_T frames; the script: 24, 12 for the pose models): per
    stage the device self time
    per frame of one graph replay (by kernel name) and of the eager loop
    (by stage scope). Gated: every row's stage sum within TRACE_TOL of the
    device's busy time, each path's kernels launched."""
    mod = _load_script("torch_profile_trace")
    rows, counts = {}, {}
    for name, path in TRACE_MODELS:
        got, counts[name] = _path_run(path, lambda: mod.trace(
            name, H, W, TRACE_T, log=lambda m: print(m, flush=True)))
        rows.update(got)
        torch.cuda.empty_cache()
    emit("profile_trace", stages=rows, launches=_sum_counts(counts.values()),
         launches_by_model=counts)
    bad = {k: r["stage_sum_over_busy"] for k, r in rows.items()
           if not _finite(np, r["stage_sum_over_busy"])
           or abs(r["stage_sum_over_busy"] - 1.0) > TRACE_TOL}
    if len(rows) != 2 * len(TRACE_MODELS) or bad:
        raise AssertionError(f"profile_trace: stage sums off the busy "
                             f"time: {bad}")


def tau_ab_phase(torch, np):
    """scripts/torch_exp_tau_ab.py on the flagship: the tuned vector and
    four flat ones over one chunk after the cold start, EXP_REPS reps (the
    script's 3 chunks and 3 reps cut), plus the untimed stats pass. Gated:
    one graph per stats form for every vector, finite rates."""
    mod = _load_script("torch_exp_tau_ab")
    wl, _ = scene_workload()
    rec, counts = _path_run("flagship", lambda: mod.tau_ab(
        wl, "scene", H, W, T, EXP_REPS, EXP_CHUNKS - 1,
        log=lambda m: print(m, flush=True)))
    emit("tau_ab", **rec, launches=counts)
    if rec["graph_captures"] != 2 or len(rec["rows"]) != 5 or not all(
            _finite(np, r["best_fps"]) for r in rec["rows"]):
        raise AssertionError(f"tau_ab: {rec['graph_captures']} graphs, "
                             f"rows {rec['rows']}")


def forward_phase(torch, np):
    """scripts/torch_exp_forward.py on seg and pose at 720p, one timed
    chunk (the script's 2 cut): base, fwd_deep and fwd_all, cb_fps and
    flop_reduction. Gated: each variant runs (a refusal names its layer
    and fails here: every map of these nets is on the kernels' gate),
    finite numbers, the path's kernels and the tile copy launched."""
    mod = _load_script("torch_exp_forward")
    out, counts = {}, {}
    for name, path in (("seg", "seg"), ("pose", "pose_unfused")):
        rec, counts[name] = _path_run(path, lambda: mod.forward(
            name, H, W, T, 1, log=lambda m: print(m, flush=True)))
        out[name] = rec
        bad = {k: v for k, v in rec["variants"].items()
               if "refused" in v or not _finite(np, v["cb_fps"],
                                                v["flop_reduction"])}
        if bad or not counts[name].get("accept_tiles"):
            raise AssertionError(f"forward {name}: {bad}, launches "
                                 f"{counts[name]}")
        torch.cuda.empty_cache()
    emit("forward", **out, launches=_sum_counts(counts.values()),
         launches_by_model=counts)


def fused_ab_phase(torch, np):
    """scripts/torch_exp_fused_ab.py on pose and pose_graph at 720p, 2
    timed chunks of EXP_T frames after the refresh chunk, EXP_REPS reps
    (the script's 5 chunks of 32 and 5 reps cut). Gated: the arms'
    outputs and stats equal, each path's kernels launched."""
    from cbinfer_tpu_torch import zoo
    mod = _load_script("torch_exp_fused_ab")
    out, counts = {}, {}
    for name in ("pose", "pose_graph"):
        wl = zoo.load(name, (H, W, 3))
        rec, counts[name] = _path_run(name, lambda: mod.fused_ab(
            wl, name, H, W, EXP_T, EXP_REPS, EXP_CHUNKS,
            log=lambda m: print(m, flush=True)))
        out[name] = rec
        if not rec["outputs_identical"]:
            raise AssertionError(f"fused_ab {name}: the arms differ")
        del wl
        torch.cuda.empty_cache()
    emit("fused_ab", **out, launches=_sum_counts(counts.values()),
         launches_by_model=counts)


def variants_phase(torch, np):
    """scripts/torch_exp_variants.py, every mode, at 720p with chunks of
    EXP_T frames (the script's 32 cut), 2 passes: the stem policies, the
    bounded
    "torch" stem, the output forms and the tile sizes. Gated: finite
    times for every configuration but those of VARIANTS_REFUSED, which
    must be refused by their kernel; the flagship's kernels launched."""
    mod = _load_script("torch_exp_variants")
    rec, counts = _path_run("flagship", lambda: mod.variants(
        mod.MODES, H, W, EXP_T, 2, 2, log=lambda m: print(m, flush=True)))
    emit("variants", **rec, launches=counts)
    refused = {k: v["kernel"] for k, v in rec["refused"].items()}
    if refused != VARIANTS_REFUSED or not all(
            _finite(np, v) for v in rec["ms_per_frame"].values()):
        raise AssertionError(f"variants: refused {rec['refused']}")


def stats_ab_phase(torch, np):
    """scripts/torch_exp_stats_ab.py on the flagship: collect_stats="mean"
    against False, 2 timed chunks after the refresh chunk, EXP_REPS reps
    (the script's 5 and 5 cut). Gated: the arms' outputs bit-identical."""
    mod = _load_script("torch_exp_stats_ab")
    wl, _ = scene_workload()
    rec, counts = _path_run("flagship", lambda: mod.stats_ab(
        wl, "scene", H, W, T, EXP_REPS, EXP_CHUNKS,
        log=lambda m: print(m, flush=True)))
    emit("stats_ab", **rec, launches=counts)
    if not rec["outputs_identical"]:
        raise AssertionError("stats_ab: the arms' outputs differ")


def pointwise_ab_phase(torch, np):
    """scripts/torch_exp_pointwise_ab.py on the flagship: the classifier as
    F.conv2d (POINTWISE_DOT False) against the matmul (True), CB and
    dense, 2 timed chunks, EXP_REPS reps (the script's 5 and 5 cut).
    Gated: the arms' class maps agree on POINTWISE_AGREE of the pixels,
    the flag is back at its default."""
    from cbinfer_tpu_torch import network
    mod = _load_script("torch_exp_pointwise_ab")
    wl, _ = scene_workload()
    rec, counts = _path_run("flagship", lambda: mod.pointwise_ab(
        wl, "scene", H, W, T, EXP_REPS, EXP_CHUNKS,
        log=lambda m: print(m, flush=True)))
    emit("pointwise_ab", **rec, launches=counts)
    if rec["argmax_agreement"] < POINTWISE_AGREE \
            or network.POINTWISE_DOT is not True:
        raise AssertionError(f"pointwise_ab: agreement "
                             f"{rec['argmax_agreement']}, flag "
                             f"{network.POINTWISE_DOT}")


def probe_dma_phase(torch, np):
    """scripts/torch_probe_dma_constraints.py's eleven cases on the card,
    the path of P1 and P2: each case's verdict (the card's encoder) beside
    the encoder rules' prediction, its launches; then, per case, the
    kernel against its plain version on the same inputs (an accepted case
    bit for bit; a refused one raises and leaves the buffer untouched),
    ms per launch with L2 flushed, the plain version's and one PyTorch
    copy's, and the bound: the window's bytes moved once at PEAK_BYTES."""
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.ops.kernels import tma_window as K
    mod = _load_script("torch_probe_dma_constraints")
    reset_launches()
    records = mod.run_cases("cuda", log=lambda m: print(m, flush=True))
    counts = {k: v for k, v in launches().items() if k in (
        K.KERNEL_WRITE.name, K.KERNEL_READ.name)}
    cases = [(n, (mod.R, mod.G, mod.L), w, True)
             for n, w in mod.WRITE_CASES] \
        + [(n, sh, w, False) for n, sh, w in mod.READ_CASES]
    rows, out = {}, []
    for rec, (name, shape, window, write) in zip(records, cases):
        _, box = K.window_bounds(shape, window)
        nbytes = int(np.prod(box)) * 2 * (1 if write else 2)
        one = dict(case=name, kernel=rec["kernel"], verdict=rec["verdict"],
                   cu_result=rec["cu_result"], rules=rec["rules"],
                   rules_agree=(rec["verdict"] == "refused")
                   == bool(rec["rules"]), window=rec["window"],
                   bytes=nbytes)
        zero = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
        src = None if write else mod.read_source(shape).cuda()
        if rec["verdict"] == "refused":
            # reported, never copied another way
            buf = zero.clone()
            try:
                if write:
                    K.window_write(buf, window)
                else:
                    K.window_read(src, window)
            except K.WindowRefused:
                one["raises"] = True
            else:
                raise AssertionError(f"probe_dma {name}: refused by the "
                                     "card once, then copied")
            one["untouched"] = bool(torch.equal(buf, zero))
            if not one["untouched"]:
                raise AssertionError(f"probe_dma {name}: a refused window "
                                     "changed the buffer")
            out.append(one)
            continue
        if write:
            k_out = K.window_write(zero.clone(), window)
            p_out = K.window_write_plain(zero.clone(), window)
            buf_k, buf_p, buf_l = zero.clone(), zero.clone(), zero.clone()
            tile = K.ramp(box, "cuda").contiguous()
            view = buf_l[window]
            ms = _time_launches(torch, lambda: K.window_write(buf_k, window),
                                buf_k.zero_, 20)
            pms = _time_launches(
                torch, lambda: K.window_write_plain(buf_p, window),
                buf_p.zero_, 20)
            lms = _time_launches(torch, lambda: view.copy_(tile),
                                 buf_l.zero_, 20)
        else:
            k_out = K.window_read(src, window)
            p_out = K.window_read_plain(src, window)
            dense = torch.empty(box, dtype=torch.bfloat16, device="cuda")
            ms = _time_launches(torch, lambda: K.window_read(src, window),
                                lambda: None, 20)
            pms = _time_launches(
                torch, lambda: K.window_read_plain(src, window),
                lambda: None, 20)
            lms = _time_launches(torch, lambda: dense.copy_(src[window]),
                                 lambda: None, 20)
        exact = bool(torch.equal(k_out, p_out))
        err = float((k_out.float() - p_out.float()).abs().max())
        bound, by = _bound_ms(0.0, nbytes)
        one.update(values_ok=rec["values_ok"], exact=exact,
                   max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
                   bound_ms=bound, bound_by=by)
        out.append(one)
        if not (exact and rec["values_ok"]):
            raise AssertionError(f"probe_dma {name}: kernel and plain "
                                 f"version differ: {one}")
        rows.setdefault(rec["kernel"], one)
    emit("probe_dma", cases=out, launches=counts,
         smi=nvidia_smi("name,power.limit"))
    for k in (K.KERNEL_WRITE, K.KERNEL_READ):
        accepted = sum(1 for c in out
                       if c["kernel"] == k.name and c["verdict"] == "accepted")
        if not accepted or counts[k.name] != accepted:
            raise AssertionError(f"probe_dma: {k.name} accepted {accepted} "
                                 f"cases, launched {counts[k.name]}")
    # each row's numbers: its first accepted case's
    RESULTS["_probe_rows"] = probe_rows = {}
    for k in (K.KERNEL_WRITE, K.KERNEL_READ):
        r = rows[k.name]
        probe_rows[k.name] = {
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": counts[k.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"],
            "paths": {"probe_dma": {"launches": counts[k.name]}},
            "cases": [c for c in out if c["kernel"] == k.name]}


def emit_kernels():
    from cbinfer_tpu_torch.ops.kernels import KERNELS
    per = RESULTS.pop("_per_kernel")
    context = RESULTS.pop("_context")
    probe_rows = RESULTS.pop("_probe_rows")
    launches = {"flagship": RESULTS["main"]["launches"],
                "dense_stem": RESULTS["main_dense_stem"]["launches"],
                "hintless": RESULTS["hintless"]["launches"],
                "pose": RESULTS["pose"]["launches"],
                "pose_unfused": RESULTS["pose_unfused"]["launches"],
                "pose_fwd": RESULTS["pose_fwd"]["launches"],
                "seg": RESULTS["seg"]["launches"],
                "pose_graph": RESULTS["pose_graph"]["launches"],
                "import": RESULTS["import"]["launches"],
                "tune": RESULTS["tune"]["launches"],
                "cli": RESULTS["cli"]["launches"],
                "multistream": RESULTS["multistream"]["launches"],
                "live": RESULTS["live"]["launches"],
                "changerate": RESULTS["changerate"]["launches"],
                "dryrun": RESULTS["dryrun"]["launches"],
                "train": RESULTS["train"]["launches"],
                "bench": RESULTS["bench"]["launches"],
                "backends": RESULTS["backends"]["launches"],
                "policy": RESULTS["policy"]["launches"],
                "refresh": RESULTS["refresh"]["launches"],
                "headline": RESULTS["headline"]["launches"],
                **{p: RESULTS[p]["launches"] for p in (
                    "latency", "longrun", "pose_graph_bench",
                    "profile_stages", "footage", "sweeps", "seg_repro",
                    "multistream_bench", "profile_trace", "tau_ab",
                    "forward", "fused_ab", "variants", "stats_ab",
                    "pointwise_ab")}}
    rows = []
    for k in KERNELS:
        if k.name in probe_rows:
            # P1 and P2: their own path is the probe script's cases
            rows.append(probe_rows[k.name])
            continue
        paths = {}
        for path in launches:
            p = per.get((path, k.name))
            if p is None:
                if launches[path].get(k.name):
                    paths[path] = {"launches": launches[path][k.name]}
                continue
            paths[path] = {
                "launches": launches[path][k.name],
                "calls_per_frame": p["n"], "max_abs_err": p["err"],
                "ms": p["ms"] / p["n"], "plain_ms": p["plain_ms"] / p["n"],
                "bound_ms": p["bound_ms"] / p["n"],
                "bound_by": "/".join(sorted(p["by"]))}
        # the row's own numbers: those of the first path that runs it
        main = next((paths[p] for p in ("flagship", "hintless", "pose",
                                        "pose_fwd")
                     if "ms" in paths.get(p, {})), None)
        if main is None or not main["launches"]:
            raise AssertionError(f"{k.name}: no call captured or launched")
        rows.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": main["launches"],
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            # no single PyTorch call computes these sparse, in-place
            # functions (a dense conv or pool recomputes the whole map,
            # the tile copy is an index_select and an index_copy_ over
            # indices the count has to be read for: see "context"); the
            # window copies of P1 and P2 have one (their rows above)
            "library_ms": None,
            "calls_per_frame": main["calls_per_frame"], "paths": paths,
            "context": context.get(k.name),
        })
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
