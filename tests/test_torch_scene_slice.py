"""The whole slice on the CPU: the scene CB path (w16 at 64x128) through
the port's converter + ``scan_video`` against the JAX package's
``"pallas"`` path in interpret mode, on the same noise-free SpriteVideo
clip with the JAX package's ``init_params`` carried across. Three paths:
the flagship with the stem overridden to ``dense_cached`` (``runs``), the
exact flagship with the sparse ``patch_stem`` stem, and the plain
``convert`` with a dense stem, whose first pool gets no hint (``path_runs``).

The seed is picked so that no layer's per-pixel diff lies within 1e-4 of
tau on the reference run (asserted below): a 1e-6 rounding difference can
then never flip a detect decision, so every mismatch is a real one. Stats,
argmax maps, effective FLOPs and GT-mIoU must be identical; logits and
cache interiors agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import metrics as jmetrics
from cbinfer_tpu import network as jnetwork
from cbinfer_tpu import runner as jrunner
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.layers import _geometry as j_geometry
from cbinfer_tpu.layers import _layer_cfg as j_layer_cfg
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.network import out_shapes as j_out_shapes
from cbinfer_tpu.ops import flat4 as jflat4
from cbinfer_tpu.ops.delta_conv import storage_interior as j_interior

from _torch_carry import storage_to_flat4
from cbinfer_tpu_torch import metrics as tmetrics
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.convert import convert, convert_flagship
from cbinfer_tpu_torch.layers import _geometry
from cbinfer_tpu_torch.layers import _layer_cfg as tlayers_layer_cfg
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.ops.delta_conv import storage_interior
from cbinfer_tpu_torch.runner import scan_video
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

H, W, T, TAU, SEED, CLASSES = 64, 128, 6, 0.05, 3, 8
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=12, speed=2.0,
             noise_std=0.0, seed=SEED)
# layers that compare pixels against tau (forward-hint pools do not)
DETECT_LAYERS = {"dense_stem": (0, 2, 4, 5), "flagship": (0, 2, 4, 5),
                 "hintless": (1, 2, 3, 4, 5)}


def _build(path, conv_flagship, conv_plain, specs, cfg):
    """The path's network through either package's converter."""
    if path == "dense_stem":
        return conv_flagship(specs, (H, W, 3), cfg, thresholds=[TAU] * 6,
                             extra_overrides={0: "dense_cached"})
    if path == "flagship":
        return conv_flagship(specs, (H, W, 3), cfg, thresholds=[TAU] * 6)
    return conv_plain(specs, (H, W, 3), cfg, thresholds=[TAU] * 7,
                      dense_layers=(0, 6))


def _reference(path):
    """Frame-by-frame JAX run (apply_refresh on frame 0, then apply), the
    same as scan_video(refresh_start=True), keeping every state so the
    per-pixel diffs each detect saw can be checked against tau."""
    specs = j_get_model("scene", num_classes=CLASSES, width=16)
    cfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    net = _build(path, jconvert.convert_flagship, jconvert.convert, specs,
                 cfg)
    params = j_init_params(specs, (H, W, 3), jax.random.PRNGKey(SEED))
    frames, labels = jvideo.SpriteVideo(
        jvideo.SpriteVideoConfig(**VIDEO)).clip_with_labels(T)
    apply = jax.jit(net.apply)
    y, st, s = jax.jit(net.apply_refresh)(params, net.init_state(),
                                          jnp.asarray(frames[0]))
    ys, states, stats = [y], [st], [s]
    for t in range(1, T):
        y, st, s = apply(params, st, jnp.asarray(frames[t]))
        ys.append(y)
        states.append(st)
        stats.append(s)
    return net, specs, params, frames, labels, ys, states, stats


def _port_net(path):
    tspecs = get_model("scene", num_classes=CLASSES, width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    return tspecs, _build(path, convert_flagship, convert, tspecs, cfg)


def _port_params(tspecs, jparams):
    return params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")


def _runs(path):
    jnet, specs, jparams, frames, labels, jys, jstates, jstats = \
        _reference(path)
    tspecs, tnet = _port_net(path)
    tparams = _port_params(tspecs, jparams)
    tframes, tlabels = SpriteVideo(SpriteVideoConfig(**VIDEO)) \
        .clip_with_labels(T)
    ys, state, stats = scan_video(tnet, tparams, torch.from_numpy(tframes),
                                  collect_stats=True, refresh_start=True)
    return dict(path=path, jnet=jnet, jparams=jparams, frames=frames,
                labels=labels, jys=jys, jstates=jstates, jstats=jstats,
                tnet=tnet, tframes=tframes, tlabels=tlabels, ys=ys,
                state=state, stats=stats)


@pytest.fixture(scope="module")
def runs():
    return _runs("dense_stem")


@pytest.fixture(scope="module", params=["flagship", "hintless"])
def path_runs(request):
    return _runs(request.param)


def test_video_copy_is_byte_identical(runs):
    assert runs["tframes"].tobytes() == runs["frames"].tobytes()
    assert runs["tlabels"].tobytes() == runs["labels"].tobytes()


def _check_diffs_keep_clear_of_tau(runs):
    """No detect input pixel of the reference run sits within 1e-4 of tau
    (pixels with a zero diff cannot flip)."""
    net, states, frames = runs["jnet"], runs["jstates"], runs["frames"]
    shapes = [(H, W, 3)] + j_out_shapes(net.specs, (H, W, 3))
    margin = np.inf
    for t in range(1, T):
        for k in DETECT_LAYERS[runs["path"]]:
            h, w, c = shapes[k]
            lcfg = j_layer_cfg(net.specs[k], net.cfg)
            if lcfg.backend == "patch_stem":
                before = np.asarray(jflat4.from_flat4(
                    states[t - 1][k].in_cache, jflat4.flat4_geom(h, w, c)))
            else:
                cst = states[t][k].in_cache.shape[-1] if k else c
                g = j_geometry(net.specs[k], (h, w, cst), lcfg)
                before = np.asarray(j_interior(states[t - 1][k].in_cache, g))
            if k == 0:
                x = frames[t]
            elif states[t][k - 1] is not None:
                x = np.asarray(states[t][k - 1].out_cache)[:h, :w]
            else:  # the producer is the dense stem
                wb = runs["jparams"][k - 1]
                x = np.asarray(jnetwork.dense_conv(
                    jnp.asarray(frames[t]), wb[0], wb[1], net.specs[k - 1],
                    jnp.float32))
            d = np.abs(x.astype(np.float32)[..., :c]
                       - before[..., :c]).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    assert margin > 1e-4, margin


def _check_specs_match(runs):
    jspecs = [dataclasses.asdict(s) for s in runs["jnet"].specs]
    tspecs = [dataclasses.asdict(s) for s in runs["tnet"].specs]
    for d in jspecs:
        if d.get("backend") == "pallas":
            d["backend"] = "cuda"
    assert tspecs == jspecs


def _check_per_layer_stats_identical(runs):
    jstats, tstats = runs["jstats"], runs["stats"]
    assert len(tstats) == len(jstats[0])
    for k, ts in enumerate(tstats):
        if not jstats[0][k]:
            assert ts == {}
            continue
        for key in jstats[0][k]:
            want = [int(np.asarray(s[k][key])) for s in jstats]
            got = [int(v) for v in ts[key].tolist()]
            assert got == want, (k, key, got, want)


def _check_outputs_match(runs):
    jys = np.stack([np.asarray(y) for y in runs["jys"]])
    ys = runs["ys"].numpy()
    np.testing.assert_allclose(ys, jys, atol=1e-4)
    np.testing.assert_array_equal(ys.argmax(-1), jys.argmax(-1))


def _check_final_caches_match(runs):
    jst, tst = runs["jstates"][-1], runs["state"]
    net = runs["tnet"]
    shapes = [(H, W, 3)] + out_shapes(net.specs, (H, W, 3))
    for k, (js, ts) in enumerate(zip(jst, tst)):
        if ts is None:
            assert js is None
            continue
        c = ts.out_cache.shape[-1]
        np.testing.assert_allclose(
            ts.out_cache.numpy(), np.asarray(js.out_cache)[..., :c],
            atol=1e-4, err_msg=f"layer {k} out cache")
        if ts.in_cache.shape == (1, 1, 1):  # elided pool input cache
            assert np.asarray(js.in_cache).shape == (1, 1, 1)
            continue
        lcfg = tlayers_layer_cfg(net.specs[k], net.cfg)
        g = _geometry(net.specs[k], shapes[k], lcfg)
        if lcfg.backend == "patch_stem":  # flat4 there, padded HWC here
            fg = jflat4.flat4_geom(*shapes[k])
            np.testing.assert_allclose(
                storage_to_flat4(ts.in_cache.numpy(), fg, g),
                np.asarray(js.in_cache), atol=1e-4,
                err_msg=f"layer {k} in cache")
            continue
        cin = shapes[k][2]
        jint = np.asarray(js.in_cache)[
            g.store_lo_h:g.store_lo_h + g.in_h,
            g.store_lo_w:g.store_lo_w + g.in_w, :cin]
        np.testing.assert_allclose(storage_interior(ts.in_cache, g).numpy(),
                                   jint, atol=1e-4,
                                   err_msg=f"layer {k} in cache")


def _check_flops_and_gt_miou_equal(runs):
    net = runs["tnet"]
    jstats = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *runs["jstats"])
    want = jmetrics.effective_flops(jstats, runs["jnet"].specs, (H, W, 3),
                                    8, 8)
    got = tmetrics.effective_flops(runs["stats"], net.specs, (H, W, 3), 8, 8)
    assert got == want
    stride = 4
    lab = runs["labels"][:, ::stride, ::stride]
    jmaps = np.stack([np.asarray(y) for y in runs["jys"]]).argmax(-1)
    want_miou = jmetrics.miou_labels(jmaps, lab, CLASSES)
    inter, union = tmetrics.iu_counts(runs["ys"].argmax(-1),
                                      torch.from_numpy(lab), CLASSES)
    assert tmetrics.merge_iu(inter.numpy(), union.numpy()) == want_miou
    return got


def test_reference_diffs_keep_clear_of_tau(runs):
    _check_diffs_keep_clear_of_tau(runs)


def test_specs_match(runs):
    _check_specs_match(runs)


def test_per_layer_stats_identical(runs):
    _check_per_layer_stats_identical(runs)


def test_outputs_match(runs):
    _check_outputs_match(runs)


def test_final_caches_match(runs):
    _check_final_caches_match(runs)


def test_flops_and_gt_miou_equal(runs):
    _check_flops_and_gt_miou_equal(runs)


# ---- the exact flagship (patch_stem stem) and the hint-less convert path ----


def test_path_reference_diffs_keep_clear_of_tau(path_runs):
    _check_diffs_keep_clear_of_tau(path_runs)


def test_path_specs_match(path_runs):
    _check_specs_match(path_runs)
    backends = [(s.kind, s.backend, s.use_cb) for s in path_runs["tnet"].specs]
    if path_runs["path"] == "flagship":
        assert backends[0] == ("conv", "patch_stem", True)
    else:
        assert backends[0] == ("conv", None, False)
        assert not any(getattr(s, "forward_hint", False)
                       for s in path_runs["tnet"].specs)


def test_path_per_layer_stats_identical(path_runs):
    _check_per_layer_stats_identical(path_runs)
    stem = path_runs["stats"][0]
    if path_runs["path"] == "flagship":
        # the sparse stem computes fewer tiles than it has, on the fine grid
        assert int(stem["n_tiles"][-1]) == (H // 8) * (W // 8)
        assert int(stem["computed_tiles"][-1]) < int(stem["n_tiles"][-1])
        assert int(stem["computed_tiles"][-1]) % 4 == 0
    else:
        assert stem == {}


def test_path_outputs_match(path_runs):
    _check_outputs_match(path_runs)


def test_path_final_caches_match(path_runs):
    _check_final_caches_match(path_runs)


def test_path_flops_and_gt_miou_equal(path_runs, runs):
    got = _check_flops_and_gt_miou_equal(path_runs)
    if path_runs["path"] == "flagship":
        # the sparse stem is what lifts the FLOP reduction over slice 1's
        dense_stem = tmetrics.effective_flops(
            runs["stats"], runs["tnet"].specs, (H, W, 3), 8, 8)
        assert got["flop_reduction"] > dense_stem["flop_reduction"]


def test_refresh_every_matches_reference():
    """scan_video(refresh_every=4) on the exact flagship: frames 0 and 4
    refresh, in both packages."""
    specs = j_get_model("scene", num_classes=CLASSES, width=16)
    cfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    jnet = _build("flagship", jconvert.convert_flagship, jconvert.convert,
                  specs, cfg)
    jparams = j_init_params(specs, (H, W, 3), jax.random.PRNGKey(SEED))
    frames = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**VIDEO)).clip(T)
    jys, _, jstats = jrunner.scan_video(jnet, jparams, jnp.asarray(frames),
                                        refresh_every=4, frame_offset=4)
    tspecs, tnet = _port_net("flagship")
    ys, _, stats = scan_video(tnet, _port_params(tspecs, jparams),
                              torch.from_numpy(frames), refresh_every=4,
                              frame_offset=4)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=1e-4)
    for k, ts in enumerate(stats):
        assert set(ts) == set(jstats[k])
        for key in ts:
            assert ts[key].tolist() == np.asarray(jstats[k][key]).tolist(), \
                (k, key)
    full = (H // 8) * (W // 8)
    assert [int(v) == full for v in stats[0]["computed_tiles"]] == \
        [True, False, False, False, True, False]
    with pytest.raises(ValueError, match="refresh_start"):
        scan_video(tnet, None, torch.from_numpy(frames), refresh_every=4,
                   refresh_start=True)


@pytest.mark.parametrize("cfg", [
    dict(height=72, width=128, n_sprites=4, sprite_size=20, speed=4.0,
         noise_std=0.002, seed=0),
    dict(height=48, width=64, n_sprites=0, seed=5),
])
def test_video_copy_matches_other_configs(cfg):
    want = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**cfg))
    got = SpriteVideo(SpriteVideoConfig(**cfg))
    for _ in range(2):
        wf, wl = want.clip_with_labels(3)
        gf, gl = got.clip_with_labels(3)
        assert gf.tobytes() == wf.tobytes() and gl.tobytes() == wl.tobytes()
