#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cbinfer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  card      the card's name and power limit (nvidia-smi), torch and CUDA
  build     nvcc builds the kernels from cbinfer_tpu_torch/csrc/ (sm_90a)
  small     the slice at 64x128 (scene w16, float32) on the card against
            the same run on the CPU's plain versions: identical per-layer
            stats and argmax maps, logits within 1e-3
  main      the 720p scene path (w128, trained weights, tuned taus, stem
            override {0: "dense_cached"}, bf16, T=32 chunks with the
            REFRESH_scene.json cadence): CB and dense fps timed with CUDA
            events over distinct chunks, argmax-u8 on both paths; the
            launch counters over the timed CB run, which runs under
            torch.cuda.set_sync_debug_mode("error") (no host sync in the
            frame loop); an untimed pass for
            GT-mIoU (CB and dense) and the effective-FLOP reduction
  check     each kernel against its plain version on the inputs the main
            path gave it on one steady-state frame, plus count = 0 and an
            all-dirty hint grid (the clamped bottom edge)
  kernels   every kernel: launches, ms per launch, plain ms, bound ms
The last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without that line; without CUDA it exits 2 at once.
"""

import json
import os
import subprocess
import sys
import time

H, W, T = 720, 1280, 32
CHUNKS = 8            # timed chunks of distinct frames
NUM_CLASSES = 8
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
REPO = os.path.dirname(os.path.abspath(__file__))
RESULTS = {}


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

    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from cbinfer_tpu_torch.ops.kernels import build
    info = build.build_all()
    emit("build", seconds=info["seconds"],
         ptxas={k: [ln.strip() for ln in v.splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in info["ptxas"].items()})

    small_parity(torch, np)
    main_path(torch, np)
    emit_kernels()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------- small parity --------------------------------


def small_parity(torch, np):
    """The 64x128 slice of tests/test_torch_scene_slice.py, card vs CPU."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    h, w, n = 64, 128, 6
    specs = get_model("scene", num_classes=NUM_CLASSES, width=16)
    clip = SpriteVideo(SpriteVideoConfig(height=h, width=w, n_sprites=2,
                                         sprite_size=12, seed=3)).clip(n)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device=dev)
        net = convert_flagship(specs, (h, w, 3), cfg, thresholds=[0.05] * 6,
                               extra_overrides={0: "dense_cached"})
        params = init_params(specs, (h, w, 3), seed=3, device=dev)
        ys, _, stats = scan_video(net, params,
                                  torch.from_numpy(clip).to(dev),
                                  refresh_start=True)
        out[dev] = (ys.cpu(), [{k: torch.as_tensor(v).cpu().tolist()
                                for k, v in s.items()} for s in stats])
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    same_maps = bool(torch.equal(out["cuda"][0].argmax(-1),
                                 out["cpu"][0].argmax(-1)))
    emit("small", max_abs_err=err, stats_equal=out["cuda"][1] == out["cpu"][1],
         argmax_equal=same_maps)
    if not (err < 1e-3 and same_maps and out["cuda"][1] == out["cpu"][1]):
        raise AssertionError(f"card run disagrees with the CPU run: {err}")


# --------------------------------- main path ---------------------------------


def main_path(torch, np):
    from cbinfer_tpu_torch import layers as L
    from cbinfer_tpu_torch.checkpoint import load_npz_params
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship, num_cb_layers
    from cbinfer_tpu_torch.metrics import effective_flops, iu_counts, merge_iu
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params, out_shapes
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

    specs = get_model("scene", num_classes=NUM_CLASSES, width=128)
    with open(os.path.join(REPO, "ckpts", "scene_w128_tau.json")) as f:
        taus = json.load(f)["thresholds"]
    with open(os.path.join(REPO, "REFRESH_scene.json")) as f:
        rj = json.load(f)
    if rj["T"] != T or rj["shape"] != [H, W]:
        raise AssertionError(f"REFRESH_scene.json is for {rj['T']} "
                             f"{rj['shape']}, not {T} {[H, W]}")
    cadence = min(int(rj["refresh_every_chunks"]), CHUNKS)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375),
                         compute_dtype="bfloat16", cache_dtype="bfloat16",
                         device="cuda")
    net = convert_flagship(specs, (H, W, 3), cfg, thresholds=taus,
                           extra_overrides={0: "dense_cached"})
    assert num_cb_layers(net.specs) == len(taus)
    params = load_npz_params(
        os.path.join(REPO, "ckpts", "scene_w128.npz"),
        init_params(specs, (H, W, 3), device="cuda", dtype=torch.bfloat16),
        specs)

    def out_u8(y):
        return y.argmax(-1).to(torch.uint8)

    def video(seed):
        return SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
            noise_std=0.002, seed=seed))

    tv = video(int(time.time() * 1e3) % 100000)
    warm = torch.from_numpy(tv.clip(T)).cuda()
    chunks = [torch.from_numpy(tv.clip(T)).cuda() for _ in range(CHUNKS)]

    def cb_chunk(ch, state, refresh, stats=False):
        return scan_video(net, params, ch, state, collect_stats=stats,
                          refresh_start=refresh, out_map=out_u8)

    def dense_chunk(ch):
        return torch.stack([out_u8(net.apply_dense(params, f)) for f in ch])

    def timed(fn):
        """(result, device ms between events, host CPU ms of this thread
        while enqueuing: the host's own work, whatever else the host runs)"""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        c0 = time.thread_time()
        e0.record()
        r = fn()
        e1.record()
        c1 = time.thread_time()
        torch.cuda.synchronize()
        return r, e0.elapsed_time(e1), (c1 - c0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    # warm-up (untimed): cold start, allocator, cuDNN algorithm choice
    state = net.init_state()
    state = cb_chunk(warm, state, True)[1]
    state = cb_chunk(warm, state, False)[1]
    dense_chunk(warm)
    torch.cuda.synchronize()

    # an event after every chunk too: the host-bound CB loop swings with
    # the host's load, and per-chunk times show the spread
    marks = {k: [torch.cuda.Event(enable_timing=True)
                 for _ in range(CHUNKS + 1)] for k in ("cb", "dense")}

    def cb_run():
        # the frame loop must never wait for the card: any implicit host
        # sync (a .item(), a host-to-device copy of a Python value) raises
        nonlocal state
        ys = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            marks["cb"][0].record()
            for i, ch in enumerate(chunks):
                ys, state, _ = cb_chunk(ch, state, i % cadence == 0)
                marks["cb"][i + 1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return ys

    def dense_run():
        marks["dense"][0].record()
        for i, ch in enumerate(chunks):
            dn = dense_chunk(ch)
            marks["dense"][i + 1].record()
        return dn

    def chunk_ms(key):
        m = marks[key]
        return [m[i].elapsed_time(m[i + 1]) / T for i in range(CHUNKS)]

    reset_launches()
    ys, cb_ms, cb_host_ms = timed(cb_run)
    counts = launches()
    n_refresh = sum(1 for i in range(CHUNKS) if i % cadence == 0)
    steady = CHUNKS * T - n_refresh
    want = {"detect_sparse": 3 * steady, "delta_conv": 3 * steady,
            "detect_pool_fused": 2 * steady}
    if counts != want:
        raise AssertionError(f"launches {counts} != {want}")
    if ys.shape != (T, H // 4, W // 4) or ys.dtype != torch.uint8:
        raise AssertionError(f"CB output {tuple(ys.shape)} {ys.dtype}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    dn, dense_ms, dense_host_ms = timed(dense_run)
    frames = CHUNKS * T
    cb_fps, dense_fps = frames / (cb_ms / 1e3), frames / (dense_ms / 1e3)

    # ---- untimed accuracy + FLOP pass on the fixed seed-0 clip ----
    av = video(0)
    stride = H // out_shapes(net.specs, (H, W, 3))[-1][0]
    sums = {k: [0, 0] for k in ("cb", "dense", "agree")}
    chunk_stats = []
    acc_state = net.init_state()
    for i in range(max(2, cadence)):
        ch, lab = av.clip_with_labels(T)
        ch = torch.from_numpy(ch).cuda()
        lab = torch.from_numpy(lab[:, ::stride, ::stride]).cuda()
        dmap = dense_chunk(ch)
        cmap, acc_state, st = cb_chunk(ch, acc_state, i % cadence == 0,
                                       stats="mean")
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
    m_cb, m_dense = merge_iu(*sums["cb"]), merge_iu(*sums["dense"])
    emit("main", cb_fps=cb_fps, dense_fps=dense_fps,
         vs_baseline=cb_fps / dense_fps, cb_ms_per_frame=cb_ms / frames,
         dense_ms_per_frame=dense_ms / frames, frames_timed=frames,
         cb_host_cpu_ms_per_frame=cb_host_ms / frames,
         dense_host_cpu_ms_per_frame=dense_host_ms / frames,
         cb_chunk_ms_per_frame=chunk_ms("cb"),
         dense_chunk_ms_per_frame=chunk_ms("dense"),
         refresh_every_chunks=cadence, launches=counts,
         miou_gt_cb=m_cb, miou_gt_dense=m_dense,
         miou_degradation=m_dense - m_cb,
         miou_vs_dense=merge_iu(*sums["agree"]),
         flop_reduction=ef["flop_reduction"], peak_mem_gib=peak_gib,
         smi_after_cb=clocks, weights="ckpts/scene_w128.npz",
         taus=taus, stem="dense_cached")
    if not m_dense - m_cb <= 0.005:
        raise AssertionError(f"GT-mIoU degradation {m_dense - m_cb} > 0.005")

    # ---- capture one steady-state frame's kernel calls ----
    calls = []
    names = ("detect_sparse", "delta_conv", "detect_pool_fused")
    saved = {n: getattr(L, n) for n in names}

    def recorder(name):
        def wrapper(*args, **kw):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a
                                 for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()}))
            return saved[name](*args, **kw)
        return wrapper

    nxt = torch.from_numpy(av.clip(1)).cuda()
    try:
        for n in names:
            setattr(L, n, recorder(n))
        logits = net.apply(params, acc_state, nxt[0])[0]
    finally:
        for n in names:
            setattr(L, n, saved[n])
    if (tuple(logits.shape) != (H // 4, W // 4, NUM_CLASSES)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or "
                             "of the wrong shape")
    check_kernels(torch, np, calls)


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


def check_kernels(torch, np, calls):
    from cbinfer_tpu_torch.ops.kernels import KERNELS
    from cbinfer_tpu_torch.ops.kernels import delta_conv as KC
    from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
    from cbinfer_tpu_torch.ops.kernels import pool_fused as KP
    per = {k.name: dict(n=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0,
                        by=set()) for k in KERNELS}
    checks = []
    zero = torch.zeros((), dtype=torch.int32, device="cuda")

    def acc(name, ms, pms, bound, by, err):
        p = per[name]
        p["n"] += 1
        p["ms"] += ms
        p["plain_ms"] += pms
        p["bound_ms"] += bound
        p["by"].add(by)
        p["err"] = max(p["err"], err)

    for li, (name, args, kw) in enumerate(calls):
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
            checks.append(dict(kernel=name, call=li, exact=ok,
                               count0_noop=ok0, all_dirty_exact=oka,
                               clamped=g.in_h % 8 != 0, count=int(count),
                               npix=int(nk)))
            if not (ok and ok0 and oka):
                raise AssertionError(f"detect_sparse mismatch {checks[-1]}")
            ms = _time_launches(
                torch, lambda: KD.detect_sparse(x, st, tau, idx, count, g),
                lambda: st.copy_(st0), 20)
            pms = _time_launches(
                torch, lambda: KD.detect_sparse_plain(x, sp, tau, idx, count,
                                                      g),
                lambda: sp.copy_(st0), 5, sleep_cycles=0)
            c = int(count)
            hm = torch.zeros(n_hint, dtype=torch.bool, device="cuda")
            hm[idx[:c].long()] = True
            own = int(hm.view(-1, g.in_w // 8).repeat_interleave(8, 0)
                      [:g.in_h].sum()) * 8
            C, es = st0.shape[-1], st0.element_size()
            nbytes = (2 * own * C * es + int(nk) * C * es
                      + g.tiles_h * g.tiles_w * 4 + c * 4 + 8)
            acc(name, ms, pms, *_bound_ms(0.0, nbytes), err)
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
            checks.append(dict(kernel=name, call=li, max_abs_err=err,
                               within_2e2=close, untouched_bit_identical=kept,
                               count0_noop=ok0, count=c))
            if not (close and kept and ok0):
                raise AssertionError(f"delta_conv mismatch {checks[-1]}")
            out_k = out0.clone()
            ms = _time_launches(
                torch, lambda: KC.delta_conv(xp, idx, w, b, out_k, g, act, cd,
                                             count=count),
                lambda: out_k.copy_(out0), 20)
            out_p = out0.clone()
            pms = _time_launches(
                torch, lambda: KC.delta_conv_plain(xp, idx, w, b, out_p, g,
                                                   act, cd, count=count),
                lambda: out_p.copy_(out0), 5, sleep_cycles=0)
            kh, kw_ = g.kernel
            cin = g.cin
            flops = 2 * g.th * g.tw * kh * kw_ * cin * cout * c
            # input bytes: the union of the listed tiles' windows, once
            cover = np.zeros(xp.shape[:2], bool)
            for t in idx[:c].cpu().numpy():
                ti, tj = divmod(int(t), g.tiles_w)
                r0 = ti * g.th * g.stride[0]
                c0 = tj * g.tw * g.stride[1] + g.dx0
                cover[r0:r0 + g.win_h, c0:c0 + g.win_w] = True
            es = xp.element_size()
            nbytes = (int(cover.sum()) * cin * es
                      + c * g.th * g.tw * cout * es
                      + w.numel() * es + cout * 4 + c * 4)
            acc(name, ms, pms, *_bound_ms(flops, nbytes), err)
        else:  # detect_pool_fused
            x, out0, idx, count, g = args
            ok_, mk = KP.detect_pool_fused(x, out0.clone(), idx, count, g,
                                           **kw)
            op_, mp = KP.detect_pool_fused_plain(x, out0.clone(), idx, count,
                                                 g, **kw)
            err = float((ok_.float() - op_.float()).abs().max())
            ok = torch.equal(ok_, op_) and torch.equal(mk, mp)
            z, m0 = KP.detect_pool_fused(x, out0.clone(), idx, zero, g, **kw)
            ok0 = torch.equal(z, out0) and not m0.any()
            checks.append(dict(kernel=name, call=li, exact=ok,
                               count0_noop=ok0, count=int(count)))
            if not (ok and ok0):
                raise AssertionError(f"detect_pool_fused mismatch "
                                     f"{checks[-1]}")
            out_k, out_p = out0.clone(), out0.clone()
            ms = _time_launches(
                torch, lambda: KP.detect_pool_fused(x, out_k, idx, count, g,
                                                    **kw),
                lambda: out_k.copy_(out0), 20)
            pms = _time_launches(
                torch, lambda: KP.detect_pool_fused_plain(x, out_p, idx,
                                                          count, g, **kw),
                lambda: out_p.copy_(out0), 5, sleep_cycles=0)
            c, C, es = int(count), out0.shape[-1], out0.element_size()
            nbytes = (c * (kw["hint_h"] * kw["hint_w"]
                           + kw["hint_h"] * kw["hint_w"] // 4) * C * es
                      + g.tiles_h * g.tiles_w * 4 + c * 4)
            acc(name, ms, pms, *_bound_ms(0.0, nbytes), err)
    emit("check", calls=checks)
    RESULTS["_per_kernel"] = per


def emit_kernels():
    from cbinfer_tpu_torch.ops.kernels import KERNELS
    per = RESULTS.pop("_per_kernel")
    launches = RESULTS["main"]["launches"]
    rows = []
    for k in KERNELS:
        p = per[k.name]
        if p["n"] == 0:
            raise AssertionError(f"{k.name}: no call captured")
        rows.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": p["err"], "ms": p["ms"] / p["n"],
            "plain_ms": p["plain_ms"] / p["n"],
            "bound_ms": p["bound_ms"] / p["n"],
            "bound_by": "/".join(sorted(p["by"])),
            # no single PyTorch call computes these sparse, in-place
            # functions (a dense conv or pool recomputes the whole map)
            "library_ms": None,
            "calls_per_frame": p["n"],
        })
    print(json.dumps({"kernels": rows}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
