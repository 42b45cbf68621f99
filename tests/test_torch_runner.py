"""The runner's one-dispatch and live forms, packed stats, profiling and
state checkpoints of the port against the JAX package, on the CPU (where
``scan_video_jit`` and ``FrameStepper`` run the eager loop: the card's CUDA
graphs are held against that loop in ``tests/test_torch_gpu.py``).

The net, clips and knobs are those of the JAX package's own
``tests/test_streaming.py`` (a 4-layer net at 32x48, 4x4 tiles, its
default ``"jnp"`` backend), with its ``init_params`` carried across. Outputs
agree within the slice tests' float32 reassociation bound (1e-4, as in
``test_torch_scene_slice.py``); uint8 class maps and every counter are
exact.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import checkpoint as jckpt
from cbinfer_tpu import profiling as jprof
from cbinfer_tpu import runner as jrunner
from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.convert import convert as jconvert
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.video import SpriteVideo, SpriteVideoConfig

from cbinfer_tpu_torch import checkpoint, profiling, runner
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, PoolSpec
from cbinfer_tpu_torch.config import TileConfig
from cbinfer_tpu_torch.convert import convert, num_cb_layers
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import init_params
from cbinfer_tpu_torch.runner import FrameStepper, scan_video, scan_video_jit
from cbinfer_tpu_torch.video import SpriteVideo as TSpriteVideo
from cbinfer_tpu_torch.video import SpriteVideoConfig as TSpriteVideoConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import build_net  # noqa: E402  (the six paths' converters)

H, W = 32, 48
TOL = 1e-4  # the slice tests' float32 reassociation bound
TAUS = [0.03, 0.03, 0.02, 0.02]


def _specs(conv, pool, tau=0.02):
    return [conv(features=8, threshold=tau), pool(threshold=tau),
            conv(features=8, threshold=tau),
            conv(features=5, kernel=(1, 1), activation=None, threshold=tau)]


def _nets():
    """The reference's ``_net()`` and the port's twin on the same
    weights."""
    jspecs = _specs(JConv, JPool)
    jnet = jconvert(jspecs, (H, W, 3), JCfg(tile=JTile(tile_h=4, tile_w=4)))
    jparams = j_init_params(jspecs, (H, W, 3), jax.random.PRNGKey(1))
    tnet = convert(_specs(ConvSpec, PoolSpec), (H, W, 3),
                   PipelineConfig(tile=TileConfig(4, 4), device="cpu"))
    tparams = params_from_numpy(
        tnet.specs, [None if p is None else (np.asarray(p[0]),
                                             np.asarray(p[1]))
                     for p in jparams], device="cpu")
    return jnet, jparams, tnet, tparams


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _clip(seed, n):
    return SpriteVideo(SpriteVideoConfig(height=H, width=W, seed=seed)).clip(n)


def _j_argmax(y):
    return jnp.argmax(y, axis=-1).astype(jnp.uint8)


def _t_argmax(y):
    return y.argmax(-1).to(torch.uint8)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL)


def _same_counters(tstats, jstats):
    """Per-layer counter dicts equal value for value (either form)."""
    assert len(tstats) == len(jstats)
    for k, (ts, js) in enumerate(zip(tstats, jstats)):
        assert set(ts) == set(js), k
        for key in js:
            np.testing.assert_array_equal(
                np.asarray(torch.as_tensor(ts[key])),
                np.asarray(js[key]), err_msg=f"layer {k} {key}")


# ------------------------------ scan_video_jit -------------------------------


def test_scan_jit_with_donation_runs_twice(nets):
    """A fresh state each call: the second run equals the first, and both
    equal the reference's jitted scan, outputs and counters."""
    jnet, jparams, tnet, tparams = nets
    clip = _clip(1, 4)
    jy, _, jstats = jrunner.scan_video_jit(jnet)(jparams, jnp.asarray(clip),
                                                 jnet.init_state())
    run = scan_video_jit(tnet)
    y1, st1, s1 = run(tparams, torch.from_numpy(clip), tnet.init_state())
    y2, _, s2 = run(tparams, torch.from_numpy(clip), tnet.init_state())
    assert torch.equal(y1, y2)
    _close(y1, jy)
    _same_counters(s1, jstats)
    _same_counters(s2, jstats)
    assert len(st1) == len(tnet.specs)


@pytest.mark.parametrize("kw", [{}, {"refresh_start": True},
                                {"refresh_every": 3}])
def test_mean_stats_match_stacked_means(nets, kw):
    """The mean form equals the stacked counters' means, and both equal
    the reference's forms (plain, refresh prolog, periodic refresh)."""
    jnet, jparams, tnet, tparams = nets
    clip = _clip(3, 6)
    ys_a, _, stacked = scan_video(tnet, tparams, torch.from_numpy(clip), **kw)
    ys_b, _, means = scan_video(tnet, tparams, torch.from_numpy(clip),
                                collect_stats="mean", **kw)
    assert torch.equal(ys_a, ys_b)
    for s, m in zip(stacked, means):
        for key in s:
            assert m[key].dtype == torch.float32 and m[key].dim() == 0
            np.testing.assert_allclose(float(m[key]),
                                       np.mean(s[key].numpy().astype(
                                           np.float64)), rtol=1e-6)
    _, _, jmeans = jrunner.scan_video(jnet, jparams, jnp.asarray(clip),
                                      collect_stats="mean", **kw)
    _same_counters(means, jmeans)


# ----------------------------- C3: empty clips -------------------------------


@pytest.mark.parametrize("form", ["stacked", "no_stats", "argmax_u8"])
def test_empty_clip_returns_what_the_reference_returns(nets, form):
    jnet, jparams, tnet, tparams = nets
    kw_j, kw_t = {}, {}
    if form == "no_stats":
        kw_j = kw_t = {"collect_stats": False}
    if form == "argmax_u8":
        kw_j, kw_t = {"out_map": _j_argmax}, {"out_map": _t_argmax}
    jys, _, jstats = jrunner.scan_video(jnet, jparams,
                                        jnp.zeros((0, H, W, 3)), **kw_j)
    state = tnet.init_state()
    before = [(s.in_cache.clone(), s.out_cache.clone()) if s else None
              for s in state]
    ys, st, stats = scan_video(tnet, tparams, torch.zeros((0, H, W, 3)),
                               state, **kw_t)
    assert tuple(ys.shape) == tuple(jys.shape)
    # the dtype a one-frame run gives
    y1 = scan_video(tnet, tparams, torch.zeros((1, H, W, 3)), **kw_t)[0]
    assert ys.dtype == y1.dtype
    if form == "argmax_u8":
        assert ys.dtype == torch.uint8 and jys.dtype == jnp.uint8
    assert st is state
    for s, b in zip(st, before):
        if s is not None:
            assert torch.equal(s.in_cache, b[0])
            assert torch.equal(s.out_cache, b[1])
    if form == "no_stats":
        assert stats == [] and jstats == []
        return
    assert len(stats) == len(jstats)
    for ts, js in zip(stats, jstats):
        assert set(ts) == set(js)
        for key in js:
            assert tuple(ts[key].shape) == tuple(np.shape(js[key])) == (0,)


def test_empty_clip_raises_with_refresh_start_or_mean(nets):
    _, _, tnet, tparams = nets
    empty = torch.zeros((0, H, W, 3))
    with pytest.raises(ValueError, match="refresh_start"):
        scan_video(tnet, tparams, empty, refresh_start=True)
    with pytest.raises(ValueError, match="mean"):
        scan_video(tnet, tparams, empty, collect_stats="mean")


# ------------------------------- FrameStepper --------------------------------


def test_frame_stepper_matches_scan(nets):
    jnet, jparams, tnet, tparams = nets
    clip = _clip(2, 5)
    jys, _, _ = jrunner.scan_video(jnet, jparams, jnp.asarray(clip))
    ys_scan, _, _ = scan_video(tnet, tparams, torch.from_numpy(clip))
    stepper = FrameStepper(tnet, tparams)
    for t in range(5):
        y, stats = stepper(clip[t])
        assert stats == []
        # frame 0 refreshes (a dense conv) where the scan computes every
        # tile: another summation order
        _close(y, ys_scan[t])
        _close(y, jys[t])
    stepper.reset()
    y0, _ = stepper(clip[0])
    _close(y0, ys_scan[0])


def test_frame_stepper_deployment_knobs(nets):
    """Runtime thresholds + periodic refresh + out_map together equal the
    reference's scan_video(refresh_every=K) with the same knobs."""
    jnet, jparams, tnet, tparams = nets
    clip = _clip(4, 7)
    jys, _, _ = jrunner.scan_video(jnet, jparams, jnp.asarray(clip),
                                   thresholds=jnp.asarray(TAUS, jnp.float32),
                                   refresh_every=3, out_map=_j_argmax)
    stepper = FrameStepper(tnet, tparams, thresholds=TAUS, refresh_every=3,
                           out_map=_t_argmax)
    for t in range(7):
        y, _ = stepper(clip[t])
        assert y.dtype == torch.uint8
        np.testing.assert_array_equal(y.numpy(), np.asarray(jys[t]))
    stepper.reset()
    y0, _ = stepper(clip[0])
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jys[0]))


def test_frame_stepper_micro_batch_matches_per_frame(nets):
    """step_chunk gives the per-frame path's outputs and refreshes at
    chunk granularity, with the reference's mean stats; with K not
    dividing the interval it refreshes at the first chunk whose span
    crosses it (3 + 3 > 5)."""
    jnet, jparams, tnet, tparams = nets
    clip = _clip(6, 12)
    per_frame = FrameStepper(tnet, tparams, thresholds=TAUS, refresh_every=4,
                             out_map=_t_argmax)
    ys_ref = [per_frame(clip[t])[0] for t in range(12)]
    jmb = jrunner.FrameStepper(jnet, jparams, thresholds=TAUS,
                               refresh_every=4, out_map=_j_argmax)
    mb = FrameStepper(tnet, tparams, thresholds=TAUS, refresh_every=4,
                      out_map=_t_argmax)
    for c in range(3):
        ys, stats = mb.step_chunk(clip[4 * c:4 * (c + 1)])
        jys, jstats = jmb.step_chunk(jnp.asarray(clip[4 * c:4 * (c + 1)]))
        assert ys.shape[0] == 4 and ys.dtype == torch.uint8
        for j in range(4):
            assert torch.equal(ys[j], ys_ref[4 * c + j]), 4 * c + j
        np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
        _same_counters(stats, jstats)
    mb2 = FrameStepper(tnet, tparams, thresholds=TAUS, refresh_every=5,
                       out_map=_t_argmax)
    mb2.step_chunk(clip[0:3])
    assert mb2._since_refresh == 3
    mb2.step_chunk(clip[3:6])       # 3 + 3 > 5 -> refresh prolog
    assert mb2._since_refresh == 3
    mb2(clip[6])
    assert mb2._t == 7 and mb2._since_refresh == 4
    mb2(clip[7])                    # 4 + 1 > 5 is false: no refresh yet
    assert mb2._since_refresh == 5
    mb2(clip[8])                    # 5 + 1 > 5: refresh
    assert mb2._since_refresh == 1


@pytest.fixture(scope="module")
def k1_reference(nets):
    """The reference stepper with per-layer stats over 8 frames."""
    jnet, jparams, _, _ = nets
    clip = _clip(9, 8)
    ref = jrunner.FrameStepper(jnet, jparams, thresholds=TAUS,
                               refresh_every=4, collect_stats=True)
    ys, stats = zip(*[ref(clip[t]) for t in range(8)])
    return clip, ys, stats


K1_VARIANTS = {
    "dict_stats": dict(collect_stats=True),
    "packed_stats": dict(collect_stats="packed"),
    "no_stats": dict(collect_stats=False),
    "default_is_no_stats": {},
    "arena": dict(pack_small_buffers=1 << 20),   # packs every cache
    "arena_partial": dict(pack_small_buffers=8 * 32 * 48),
    "bound": dict(bind_params=True),
    "all": dict(collect_stats="packed", pack_small_buffers=1 << 20,
                bind_params=True),
}


@pytest.mark.parametrize("name", list(K1_VARIANTS))
def test_frame_stepper_k1_dispatch_floor_knobs(nets, k1_reference, name):
    """Every knob combination gives the reference stepper's outputs
    across refreshes and a mode mix; packed stats decode to the
    reference's counters; the arena survives step_chunk and reset."""
    _, _, tnet, tparams = nets
    clip, ys_ref, stats_ref = k1_reference
    kw = K1_VARIANTS[name]
    s = FrameStepper(tnet, tparams, thresholds=TAUS, refresh_every=4, **kw)
    if kw.get("pack_small_buffers"):
        assert s._n_packed > 0
    for t in range(8):
        y, stats = s(clip[t])
        _close(y, ys_ref[t])
        if kw.get("collect_stats") == "packed":
            assert stats.dtype == torch.int32
            dec = runner.unpack_stats(stats)
            refd = [d for d in stats_ref[t] if d]
            assert len(dec) == len(refd)
            for a, b in zip(dec, refd):
                for key in runner.STAT_KEYS:
                    assert int(a[key]) == int(np.asarray(b[key])), key
        elif kw.get("collect_stats") is True:
            _same_counters(stats, stats_ref[t])
        else:
            assert stats == []
    if kw.get("pack_small_buffers"):
        s.step_chunk(clip[:4])
        s.reset()
        y0, _ = s(clip[0])
        _close(y0, ys_ref[0])


def test_state_packer_views_live_in_aligned_arenas(nets):
    _, _, tnet, _ = nets
    state = tnet.init_state()
    fresh = tnet.init_state()
    arenas, n = runner._make_state_packer(state, 8 * 32 * 48)
    small = [t for s in fresh if s for t in (s.in_cache, s.out_cache)
             if t.numel() * t.element_size() <= 8 * 32 * 48]
    assert n == len(small) > 0
    bases = {a.data_ptr() for a in arenas.values()}
    packed = 0
    for s, f in zip(state, fresh):
        if s is None:
            continue
        for name in ("in_cache", "out_cache"):
            t, t0 = getattr(s, name), getattr(f, name)
            assert torch.equal(t, t0)
            if t._base is not None and t._base.data_ptr() in bases:
                packed += 1
                assert (t.data_ptr() - t._base.data_ptr()) % 256 == 0
    assert packed == n


# --------------------------- packed stats, summary ---------------------------


def test_pack_unpack_stats_match_reference(nets):
    jnet, jparams, tnet, tparams = nets
    clip = _clip(5, 3)
    jy, jst, jstats = jnet.apply_refresh(jparams, jnet.init_state(),
                                         jnp.asarray(clip[0]))
    jstats = jnet.apply(jparams, jst, jnp.asarray(clip[1]))[2]
    st = tnet.init_state()
    tnet.apply_refresh(tparams, st, torch.from_numpy(clip[0]))
    tstats = tnet.apply(tparams, st, torch.from_numpy(clip[1]))[2]
    packed = runner.pack_stats(tstats)
    jpacked = jrunner.pack_stats(jstats)
    assert packed.dtype == torch.int32
    assert tuple(packed.shape) == tuple(jpacked.shape) == (
        num_cb_layers(tnet.specs), 6)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert runner.STAT_KEYS == jrunner.STAT_KEYS
    dec, jdec = runner.unpack_stats(packed), jrunner.unpack_stats(jpacked)
    assert [{k: int(v) for k, v in d.items()} for d in dec] == \
        [{k: int(v) for k, v in d.items()} for d in jdec]
    # a refresh frame: every counter known on the host
    refresh = tnet.apply_refresh(tparams, st, torch.from_numpy(clip[2]))[2]
    np.testing.assert_array_equal(
        runner.pack_stats(refresh).numpy(),
        np.asarray(jrunner.pack_stats(jnet.apply_refresh(
            jparams, jst, jnp.asarray(clip[2]))[2])))
    assert tuple(runner.pack_stats([{}, {}]).shape) == (0, 6)


@pytest.mark.parametrize("form", [True, "mean"])
def test_summarize_stats_same_string(nets, form):
    jnet, jparams, tnet, tparams = nets
    clip = _clip(7, 5)
    _, _, jstats = jrunner.scan_video(jnet, jparams, jnp.asarray(clip),
                                      collect_stats=form)
    _, _, tstats = scan_video(tnet, tparams, torch.from_numpy(clip),
                              collect_stats=form)
    for specs in (None, tnet.specs):
        assert profiling.summarize_stats(tstats, specs) == \
            jprof.summarize_stats(jstats, jnet.specs if specs else None)


def test_stage_timer_and_trace(tmp_path, nets):
    _, _, tnet, tparams = nets
    record = {}
    with profiling.stage_timer(record, "scan"):
        with profiling.trace(str(tmp_path / "trace")) as logdir:
            scan_video(tnet, tparams, torch.from_numpy(_clip(8, 2)))
    with profiling.stage_timer(record, "scan"):
        pass
    assert record["scan"] > 0
    files = os.listdir(logdir)
    assert any(f.endswith(".json") for f in files), files


# -------------------------------- checkpoints --------------------------------


def test_threshold_files_read_across_packages(tmp_path):
    taus, meta = [0.05, 0.125, 0.0, 1e-3], {"source": "tune", "frames": 64}
    jckpt.save_thresholds(str(tmp_path / "j.json"), taus, meta)
    checkpoint.save_thresholds(str(tmp_path / "t.json"), taus, meta)
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    assert checkpoint.load_thresholds(str(tmp_path / "j.json")) == taus
    assert jckpt.load_thresholds(str(tmp_path / "t.json")) == taus
    assert json.loads((tmp_path / "t.json").read_text())["metadata"] == meta


@pytest.mark.parametrize("in_place", [False, True])
def test_checkpoint_resume_mid_clip(tmp_path, nets, in_place):
    """Save after 3 frames, restore, run the other 4: equal to the run
    without the pause, outputs and caches."""
    _, _, tnet, tparams = nets
    clip = torch.from_numpy(_clip(10, 7))
    ys_all, st_all, _ = scan_video(tnet, tparams, clip, thresholds=TAUS)
    ys_a, st_a, _ = scan_video(tnet, tparams, clip[:3], thresholds=TAUS)
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save(path, tparams, st_a, extra={"frame": 3})
    like = {"params": tparams, "state": tnet.init_state()}
    ptrs = [t.data_ptr() for t in runner._tensors(like["state"])]
    got = checkpoint.restore(path, like=like, in_place=in_place)
    assert got["extra"] == {"frame": 3}
    if in_place:
        assert got["state"] is like["state"]
        assert [t.data_ptr() for t in runner._tensors(got["state"])] == ptrs
    ys_b, st_b, _ = scan_video(tnet, got["params"], clip[3:], got["state"],
                               thresholds=TAUS)
    assert torch.equal(torch.cat([ys_a, ys_b]), ys_all)
    for a, b in zip(runner._tensors(st_b), runner._tensors(st_all)):
        assert torch.equal(a, b)
    plain = checkpoint.restore(path)
    assert set(plain["state"][0]) == {"in_cache", "out_cache"}


# ----------------------------- address stability -----------------------------


SIX_PATHS = ["flagship", "dense_stem", "hintless", "pose", "pose_unfused",
             "pose_fwd"]


@pytest.mark.parametrize("path", SIX_PATHS)
def test_state_tensors_keep_their_storage(path):
    """Every state tensor's address is unchanged across refresh and steady
    frames (scan_video, FrameStepper.__call__ and step_chunk) and across
    reset(): what a captured CUDA graph relies on."""
    h, w = 64, 128
    pose = path.startswith("pose")
    specs = get_model("pose", width=8) if pose else \
        get_model("scene", num_classes=8, width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    net = build_net(path, specs, (h, w, 3), cfg)
    params = init_params(specs, (h, w, 3), seed=3, device="cpu")
    clip = torch.from_numpy(TSpriteVideo(TSpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, seed=3,
        distinct_classes=pose)).clip(5))
    taus = [0.05] * num_cb_layers(net.specs)

    def ptrs(state):
        return [t.data_ptr() for t in runner._tensors(state)]
    state = net.init_state()
    before = ptrs(state)
    scan_video(net, params, clip[:3], state, thresholds=taus,
               refresh_start=True)
    scan_video(net, params, clip[3:], state, thresholds=taus)
    assert ptrs(state) == before
    stepper = FrameStepper(net, params, thresholds=taus, refresh_every=3)
    before = ptrs(stepper.state)
    for t in range(3):
        stepper(clip[t])
    stepper.step_chunk(clip[3:5])
    assert ptrs(stepper.state) == before
    stepper.reset()
    assert ptrs(stepper.state) == before
    for a, b in zip(runner._tensors(stepper.state),
                    runner._tensors(net.init_state())):
        assert torch.equal(a, b)
