"""The pose slice on the CPU: the port's pose model, converter flags,
``zoo.load("pose")``, graded-dynamics video, ``pck_gt`` and a small pose net
(width 8 at 64x128) streamed through ``scan_video`` against the JAX
package's ``"pallas"`` path in interpret mode with the fused consumer
detect on, on the same clip with the JAX package's ``init_params`` carried
across.

The seed of the small run is picked so that no detect input of the
reference run lies within 1.5e-5 of tau (asserted; 21 layers leave no seed
a wider margin), while outputs and caches of the two packages agree within
5e-6 (float32, other summation order): a rounding difference can then
never flip a detect decision. Stats (masks' counts, changed pixels, detect
tiles) must be identical. Inside the port, fused and
unfused runs are bit-identical, and a forward-hint conv equals the same
layer re-detecting at tau = -1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import metrics as jmetrics
from cbinfer_tpu import video as jvideo
from cbinfer_tpu import zoo as jzoo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import init_params as j_init_params

from _torch_carry import cache_from_lanes, cache_to_lanes
from cbinfer_tpu_torch import metrics as tmetrics
from cbinfer_tpu_torch import video as tvideo
from cbinfer_tpu_torch import zoo
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.convert import convert_flagship, num_cb_layers
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
from cbinfer_tpu_torch.runner import scan_video

H, W, T, TAU, SEED, WIDTH = 64, 128, 6, 0.05, 3, 8
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=12, speed=2.0,
             noise_std=0.0, seed=SEED, distinct_classes=True)
FWD = {15: "forward_hint", 16: "forward_hint", 20: "forward_hint"}
FUSED_720P = [3, 6, 7] + list(range(10, 20))
JCFG = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
TCFG = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")


def _as_cuda(specs):
    out = [dataclasses.asdict(s) for s in specs]
    for d in out:
        if d.get("backend") == "pallas":
            d["backend"] = "cuda"
    return out


# ------------------------------ model, converter -----------------------------


@pytest.mark.parametrize("name,kw", [("pose", {}), ("pose", {"width": 8}),
                                     ("pose", {"stages": 1}),
                                     ("pose_backbone", {"width": 16})])
def test_model_matches_reference(name, kw):
    want = [dataclasses.asdict(s) for s in j_get_model(name, **kw)]
    assert [dataclasses.asdict(s) for s in get_model(name, **kw)] == want
    if name == "pose" and not kw:
        assert len(want) == 22 and want[-1]["features"] == 56


@pytest.mark.parametrize("shape", [(720, 1280, 3), (H, W, 3), (360, 640, 3)])
@pytest.mark.parametrize("kw", [
    dict(fuse_detect=True), dict(fuse_detect=False),
    dict(fuse_detect=True, extra_overrides=FWD),
    dict(fuse_detect=True, extra_overrides={0: "dense_cached", 12: "forward_hint"}),
])
def test_convert_flagship_marks_the_same_layers(shape, kw):
    jnet = jconvert.convert_flagship(j_get_model("pose"), shape, JCFG, **kw)
    tnet = convert_flagship(get_model("pose"), shape, TCFG, **kw)
    assert [dataclasses.asdict(s) for s in tnet.specs] == _as_cuda(jnet.specs)
    fused = [i for i, s in enumerate(tnet.specs)
             if getattr(s, "fuse_next_detect", False)]
    if shape[0] == 720 and kw == dict(fuse_detect=True):
        assert fused == FUSED_720P
        # the 180-row pool fails the fused-pool gate: it keeps its cache
        assert [s.elide_in_cache for s in tnet.specs if s.kind == "pool"] \
            == [True, True, False]
    if "extra_overrides" in kw and 15 in kw["extra_overrides"]:
        # a forwarding consumer is not pre-detected
        assert not set(fused) & {14, 15, 19}
        assert [i for i, s in enumerate(tnet.specs)
                if s.kind == "conv" and s.forward_hint] == [15, 16, 20]
    if not kw["fuse_detect"]:
        assert fused == []
    assert num_cb_layers(tnet.specs) == 21


def test_convert_flagship_refuses_a_stale_override():
    with pytest.raises(ValueError, match="out of range"):
        convert_flagship(get_model("pose"), (H, W, 3), TCFG,
                         extra_overrides={40: "forward_hint"})


# ------------------------------------ zoo ------------------------------------


@pytest.mark.parametrize("kw", [{}, {"apply_policy": False}, {"tau": 0.03}])
def test_zoo_load_pose_matches_reference(kw):
    shape = (720, 1280, 3)
    jw = jzoo.load("pose", shape, JCFG, **kw)
    tw = zoo.load("pose", shape, TCFG, **kw)
    assert [dataclasses.asdict(s) for s in tw.net.specs] \
        == _as_cuda(jw.net.specs)
    for f in ("name", "kind", "metric", "weights", "tau_source",
              "policy_source", "warnings", "upsample_scale", "fuse_detect",
              "taus", "refresh_every"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert tw.weights == "trained(npz)" and len(tw.taus) == 21
    if not kw:
        assert tw.tau_source == "tuned" and tw.fuse_detect is True
        assert tw.policy_source.endswith("POLICY_pose.json")
        assert [i for i, s in enumerate(tw.net.specs)
                if getattr(s, "fuse_next_detect", False)] == FUSED_720P
    if kw.get("apply_policy") is False:
        assert tw.fuse_detect is False and tw.policy_source == "none"
        assert not any(getattr(s, "fuse_next_detect", False)
                       for s in tw.net.specs)
    for i, (tp, jp) in enumerate(zip(tw.params, jw.params)):
        if jp is None:
            assert tp is None
            continue
        np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
        np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
    assert tuple(tw.params[17][0].shape) == (3, 3, 56, 256)
    assert tuple(tw.params[16][0].shape) == (1, 1, 128, 56)


def test_zoo_policy_fallback_drops_fuse_detect(tmp_path, monkeypatch):
    """A stale policy file degrades to a no-policy build, and the fused
    kernel's adoption, which comes from the same file, goes with it."""
    import json
    bad = tmp_path / "POLICY_pose.json"
    bad.write_text(json.dumps({"overrides": {"99": "dense_cached"},
                               "fuse_detect": True}))
    entry = dataclasses.replace(zoo.REGISTRY["pose"], policy_json=str(bad))
    monkeypatch.setitem(zoo.REGISTRY, "pose", entry)
    wl = zoo.load("pose", (H, W, 3), TCFG)
    assert wl.policy_source == "none" and wl.fuse_detect is False
    assert any("NOT applied" in w for w in wl.warnings)
    assert not any(getattr(s, "fuse_next_detect", False)
                   for s in wl.net.specs)


@pytest.mark.parametrize("t,h,w", [(32, 720, 1280), (12, 720, 1280)])
def test_pose_refresh_cadence_matches_reference(t, h, w):
    got = zoo.load_refresh_cadence("pose", t, h, w)
    assert got == jzoo.load_refresh_cadence("pose", t, h, w)
    assert got[0] == 2 and "no cadence validated" in got[1]


# ----------------------------- video and metrics -----------------------------


@pytest.mark.parametrize("cfg", [
    dict(height=48, width=64, n_sprites=3, sprite_size=10, speed=3.0,
         noise_std=0.002, seed=4, distinct_classes=True),
    dict(height=72, width=128, n_sprites=6, sprite_size=12, seed=0,
         distinct_classes=True),
    dict(height=48, width=64, n_sprites=0, seed=5),
    dict(height=40, width=56, n_sprites=2, seed=9, palette="hard"),
])
def test_pose_video_is_byte_identical(cfg):
    kw = tvideo.workload_video_kwargs("pose")
    assert kw == jvideo.workload_video_kwargs("pose") == tvideo.GRADED_DYNAMICS
    want = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**cfg, **kw))
    got = tvideo.SpriteVideo(tvideo.SpriteVideoConfig(**cfg, **kw))
    np.testing.assert_array_equal(got.classes, want.classes)
    for _ in range(2):
        wf, wk, wv = want.clip_with_keypoints(3)
        gf, gk, gv = got.clip_with_keypoints(3)
        assert gf.tobytes() == wf.tobytes()
        assert gk.tobytes() == wk.tobytes() and gv.tobytes() == wv.tobytes()
    assert (tvideo.NUM_KEYPOINTS, tvideo.NUM_PAFS, tvideo.POSE_CLASSES) == (
        jvideo.NUM_KEYPOINTS, jvideo.NUM_PAFS, jvideo.POSE_CLASSES)
    wf, wl = want.clip_with_labels(2)
    gf, gl = got.clip_with_labels(2)
    assert gf.tobytes() == wf.tobytes() and gl.tobytes() == wl.tobytes()


def test_video_profiles_and_distinct_classes_checks():
    assert tvideo.workload_video_kwargs("seg") \
        == jvideo.workload_video_kwargs("seg")
    with pytest.raises(KeyError):
        tvideo.workload_video_kwargs("nope")
    with pytest.raises(ValueError, match="distinct_classes"):
        tvideo.SpriteVideo(tvideo.SpriteVideoConfig(n_sprites=7,
                                                    distinct_classes=True))


@pytest.mark.parametrize("alpha", [0.05, 0.02])
@pytest.mark.parametrize("lead", [(), (5,)])
def test_pck_gt_matches_reference(alpha, lead):
    rng = np.random.default_rng(7)
    pred = rng.standard_normal(lead + (9, 16, 56)).astype(np.float32)
    kps = rng.uniform(0, 64, lead + (18, 2)).astype(np.float32)
    valid = rng.uniform(size=lead + (18,)) < 0.6
    # plant hits, so the score is neither 0 nor 1
    p2, k2 = pred.reshape(-1, 9, 16, 56), kps.reshape(-1, 18, 2)
    for n in range(p2.shape[0]):
        for k in range(0, 18, 3):
            y, x = int(k2[n, k, 0] // 8) % 9, int(k2[n, k, 1] // 8) % 16
            p2[n, y, x, 38 + k] = 50.0
            k2[n, k] = (8 * y, 8 * x)  # exactly on the output grid
    want = jmetrics.pck_gt(pred, kps, valid, 8, alpha)
    assert tmetrics.pck_gt(pred, kps, valid, 8, alpha) == want
    assert tmetrics.pck_gt(torch.from_numpy(pred), kps, valid, 8, alpha) \
        == want
    assert 0.0 < want < 1.0
    # the 18 argmaxes a streaming loop keeps per frame give the same score
    flat = torch.stack([tmetrics.heat_argmax(torch.from_numpy(p))
                        for p in p2])
    assert tmetrics.pck_gt_from_argmax(flat, (9, 16), kps, valid, 8,
                                       alpha) == want
    none = np.zeros_like(valid)
    assert tmetrics.pck_gt(pred, kps, none, 8, alpha) \
        == jmetrics.pck_gt(pred, kps, none, 8, alpha) == 1.0


# --------------------------- the small pose net ------------------------------


def _port_params(tspecs, jparams):
    return params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")


@pytest.fixture(scope="module")
def runs():
    specs = j_get_model("pose", width=WIDTH)
    jnet = jconvert.convert_flagship(specs, (H, W, 3), JCFG,
                                     thresholds=[TAU] * 21, fuse_detect=True)
    jparams = j_init_params(specs, (H, W, 3), jax.random.PRNGKey(SEED))
    frames, kps, valid = jvideo.SpriteVideo(
        jvideo.SpriteVideoConfig(**VIDEO)).clip_with_keypoints(T)
    apply = jax.jit(jnet.apply)
    y, st, s = jax.jit(jnet.apply_refresh)(jparams, jnet.init_state(),
                                           jnp.asarray(frames[0]))
    jys, jstates, jstats = [y], [st], [s]
    for t in range(1, T):
        y, st, s = apply(jparams, st, jnp.asarray(frames[t]))
        jys.append(y)
        jstates.append(st)
        jstats.append(s)
    tspecs = get_model("pose", width=WIDTH)
    tparams = _port_params(tspecs, jparams)
    out = {}
    for name, kw in (("fused", dict(fuse_detect=True)),
                     ("unfused", dict(fuse_detect=False))):
        tnet = convert_flagship(tspecs, (H, W, 3), TCFG,
                                thresholds=[TAU] * 21, **kw)
        ys, state, stats = scan_video(tnet, tparams,
                                      torch.from_numpy(frames),
                                      collect_stats=True, refresh_start=True)
        out[name] = dict(net=tnet, ys=ys, state=state, stats=stats)
    return dict(jnet=jnet, jparams=jparams, frames=frames, kps=kps,
                valid=valid, jys=jys, jstates=jstates, jstats=jstats,
                tparams=tparams, tspecs=tspecs, **out)


def test_small_net_specs_match_and_fuse(runs):
    tnet = runs["fused"]["net"]
    assert [dataclasses.asdict(s) for s in tnet.specs] \
        == _as_cuda(runs["jnet"].specs)
    assert [i for i, s in enumerate(tnet.specs)
            if getattr(s, "fuse_next_detect", False)] == FUSED_720P


def test_reference_diffs_keep_clear_of_tau(runs):
    """No detect input of the reference run sits within 1.5e-5 of tau."""
    from cbinfer_tpu.layers import _geometry as j_geometry
    from cbinfer_tpu.layers import _layer_cfg as j_layer_cfg
    from cbinfer_tpu.network import out_shapes as j_out_shapes
    from cbinfer_tpu.ops import flat4 as jflat4
    from cbinfer_tpu.ops.delta_conv import storage_interior as j_interior
    net, states, frames = runs["jnet"], runs["jstates"], runs["frames"]
    shapes = [(H, W, 3)] + j_out_shapes(net.specs, (H, W, 3))
    margin = np.inf
    for t in range(1, T):
        for k, spec in enumerate(net.specs[:-1]):
            if spec.kind == "pool":  # forward-hint pools compare nothing
                continue
            h, w, c = shapes[k]
            lcfg = j_layer_cfg(spec, net.cfg)
            if k == 0:
                before = np.asarray(jflat4.from_flat4(
                    states[t - 1][0].in_cache, jflat4.flat4_geom(h, w, c)))
                x = frames[t]
            else:
                cst = states[t][k].in_cache.shape[-1]
                g = j_geometry(spec, (h, w, cst), lcfg)
                before = np.asarray(j_interior(states[t - 1][k].in_cache, g))
                x = np.asarray(states[t][k - 1].out_cache)[:h, :w]
            d = np.abs(x.astype(np.float32)[..., :c] - before[..., :c]).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    assert margin > 1.5e-5, margin


def test_small_net_stats_identical_to_reference(runs):
    jstats = runs["jstats"]
    for name in ("fused", "unfused"):
        tstats = runs[name]["stats"]
        assert len(tstats) == len(jstats[0]) == 22
        for k, ts in enumerate(tstats):
            if not jstats[0][k]:
                assert ts == {}
                continue
            for key in jstats[0][k]:
                want = [int(np.asarray(s[k][key])) for s in jstats]
                got = [int(v) for v in ts[key].tolist()]
                assert got == want, (name, k, key, got, want)
    # the consumers of fused producers report the producer's tile count
    st = runs["fused"]["stats"]
    assert st[4]["detect_tiles"].tolist()[1:] \
        == st[3]["computed_tiles"].tolist()[1:]
    assert 0 < int(st[4]["detect_tiles"][-1]) < int(st[4]["n_tiles"][-1])


def test_small_net_outputs_and_caches_match_reference(runs):
    jys = np.stack([np.asarray(y) for y in runs["jys"]])
    ys = runs["fused"]["ys"].numpy()
    assert ys.shape == (T, H // 8, W // 8, 56)
    np.testing.assert_allclose(ys, jys, atol=5e-6)
    assert tmetrics.pck_gt(ys, runs["kps"], runs["valid"], 8) \
        == jmetrics.pck_gt(jys, runs["kps"], runs["valid"], 8)
    jstats = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *runs["jstats"])
    assert tmetrics.effective_flops(
        runs["fused"]["stats"], runs["fused"]["net"].specs, (H, W, 3), 8, 8) \
        == jmetrics.effective_flops(jstats, runs["jnet"].specs, (H, W, 3),
                                    8, 8)
    net = runs["fused"]["net"]
    shapes = [(H, W, 3)] + out_shapes(net.specs, (H, W, 3))
    for k, (js, ts) in enumerate(zip(runs["jstates"][-1],
                                     runs["fused"]["state"])):
        if ts is None:
            assert js is None
            continue
        # the reference's 128-lane caches carried to the port's widths
        np.testing.assert_allclose(
            ts.out_cache.numpy(),
            cache_from_lanes(js.out_cache, ts.out_cache.shape[-1]),
            atol=5e-6, err_msg=f"layer {k} out cache")
        # and back: the reference's pad lanes of an out cache are zeros
        np.testing.assert_allclose(cache_to_lanes(ts.out_cache.numpy()),
                                   np.asarray(js.out_cache), atol=5e-6,
                                   err_msg=f"layer {k} out cache, padded")
        if k == 0 or ts.in_cache.shape == (1, 1, 1):
            continue
        assert ts.in_cache.shape[-1] == shapes[k][2]
        np.testing.assert_allclose(
            ts.in_cache.numpy(),
            cache_from_lanes(js.in_cache, shapes[k][2]), atol=5e-6,
            err_msg=f"layer {k} in cache")


def test_fused_stream_bit_identical_to_unfused(runs):
    a, b = runs["fused"], runs["unfused"]
    assert torch.equal(a["ys"], b["ys"])
    for k, (sa, sb) in enumerate(zip(a["stats"], b["stats"])):
        assert set(sa) == set(sb)
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (k, key)
    for sa, sb in zip(a["state"], b["state"]):
        if sa is not None:
            assert torch.equal(sa.in_cache, sb.in_cache)
            assert torch.equal(sa.out_cache, sb.out_cache)


def _graded_clip(n, seed=11):
    return tvideo.SpriteVideo(tvideo.SpriteVideoConfig(
        **{**VIDEO, "seed": seed, "noise_std": 0.002},
        **tvideo.workload_video_kwargs("pose"))).clip(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stream_bit_identical_on_graded_video(runs, dtype):
    """The pose profile's graded dynamics (every pixel drifts) with the
    tuned taus through ``zoo.load``, 8 frames with a refresh every 4."""
    cfg = dataclasses.replace(TCFG, compute_dtype=dtype, cache_dtype=dtype)
    clip = torch.from_numpy(_graded_clip(8))
    res = []
    for policy in (True, False):
        wl = zoo.load("pose", (H, W, 3), cfg, apply_policy=policy)
        res.append(scan_video(wl.net, wl.params, clip, thresholds=wl.taus,
                              refresh_every=4) + (wl,))
    (ya, sa, ta, wa), (yb, sb, tb, wb) = res
    assert wa.fuse_detect and not wb.fuse_detect
    assert torch.equal(ya, yb) and bool(torch.isfinite(ya.float()).all())
    for k, (a, b) in enumerate(zip(ta, tb)):
        for key in a:
            assert torch.equal(a[key], b[key]), (k, key)
    for a, b in zip(sa, sb):
        if a is not None:
            assert torch.equal(a.in_cache, b.in_cache)
            assert torch.equal(a.out_cache, b.out_cache)
    # sparse in steady state, dense on the refresh frames
    full = ta[1]["computed_tiles"] == ta[1]["n_tiles"]
    assert full.tolist() == [True, False, False, False] * 2


def test_forward_hint_convs_equal_tau_minus_one(runs):
    """Layers 15, 16 and 20 forwarding == the same layers re-detecting at
    tau = -1 (outputs, caches, computed tiles), and the fused pairs whose
    consumer forwards are dropped."""
    tspecs, tparams = runs["tspecs"], runs["tparams"]
    clip = torch.from_numpy(_graded_clip(6, seed=5))
    fwd = convert_flagship(tspecs, (H, W, 3), TCFG, extra_overrides=FWD,
                           fuse_detect=True)
    ref = convert_flagship(tspecs, (H, W, 3), TCFG, fuse_detect=True)
    cb = [i for i, s in enumerate(ref.specs) if getattr(s, "use_cb", False)]
    taus = [TAU] * 21
    taus_ref = [-1.0 if cb[i] in FWD else TAU for i in range(21)]
    yf, sf, tf = scan_video(fwd, tparams, clip, thresholds=taus,
                            refresh_start=True)
    yr, sr, tr = scan_video(ref, tparams, clip, thresholds=taus_ref,
                            refresh_start=True)
    assert torch.equal(yf, yr)
    for a, b in zip(sf, sr):
        if a is not None:
            assert torch.equal(a.in_cache, b.in_cache)
            assert torch.equal(a.out_cache, b.out_cache)
    for k in FWD:
        for key in ("computed_tiles", "changed_tiles", "detect_tiles",
                    "changed_pixels"):
            assert torch.equal(tf[k][key], tr[k][key]), (k, key)
        # visited = hinted area: 64 pixels per hinted tile
        assert torch.equal(tf[k]["changed_pixels"][1:],
                           tf[k]["detect_tiles"][1:] * 64)


def test_forward_hint_conv_without_hint_redetects():
    """After a dense layer no hint arrives: the forwarding conv detects,
    as the reference does, and tau matters again."""
    from cbinfer_tpu_torch.config import ConvSpec
    from cbinfer_tpu_torch.convert import convert
    from cbinfer_tpu_torch.network import init_params
    specs = [ConvSpec(features=8, use_cb=False),
             ConvSpec(features=8, forward_hint=True),
             ConvSpec(features=4, kernel=(1, 1), activation=None)]
    clip = torch.from_numpy(tvideo.SpriteVideo(tvideo.SpriteVideoConfig(
        height=32, width=48, seed=2)).clip(4))
    params = init_params(specs, (32, 48, 3), seed=1, device="cpu")
    outs = []
    for fh in (True, False):
        s2 = [specs[0], dataclasses.replace(specs[1], forward_hint=fh),
              specs[2]]
        net = convert(s2, (32, 48, 3), TCFG, thresholds=[0.05, 0.05])
        outs.append(scan_video(net, params, clip))
    assert torch.equal(outs[0][0], outs[1][0])
    for key in outs[0][2][1]:
        assert torch.equal(outs[0][2][1][key], outs[1][2][1][key])


def test_cpu_runs_launch_no_kernel(runs):
    reset_launches()
    net = runs["fused"]["net"]
    scan_video(net, runs["tparams"], torch.from_numpy(runs["frames"][:2]))
    assert set(launches()) >= {"delta_conv_detect", "accept_tiles"}
    assert not any(launches().values())
