"""The whole slice on the CPU: the scene CB path (w16 at 64x128) through
the port's ``convert_flagship`` + ``scan_video`` against the JAX package's
``"pallas"`` path in interpret mode, on the same noise-free SpriteVideo
clip with the JAX package's ``init_params`` carried across.

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
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.layers import _geometry as j_geometry
from cbinfer_tpu.layers import _layer_cfg as j_layer_cfg
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.network import out_shapes as j_out_shapes
from cbinfer_tpu.ops.delta_conv import storage_interior as j_interior

from cbinfer_tpu_torch import metrics as tmetrics
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.convert import convert_flagship
from cbinfer_tpu_torch.layers import _geometry
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.ops.delta_conv import storage_interior
from cbinfer_tpu_torch.runner import scan_video
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

H, W, T, TAU, SEED, CLASSES = 64, 128, 6, 0.05, 3, 8
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=12, speed=2.0,
             noise_std=0.0, seed=SEED)
DETECT_LAYERS = (0, 2, 4, 5)  # the pools forward the hint, no detect


def _reference():
    """Frame-by-frame JAX run (apply_refresh on frame 0, then apply), the
    same as scan_video(refresh_start=True), keeping every state so the
    per-pixel diffs each detect saw can be checked against tau."""
    specs = j_get_model("scene", num_classes=CLASSES, width=16)
    cfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    net = jconvert.convert_flagship(specs, (H, W, 3), cfg,
                                    thresholds=[TAU] * 6,
                                    extra_overrides={0: "dense_cached"})
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


@pytest.fixture(scope="module")
def runs():
    jnet, specs, jparams, frames, labels, jys, jstates, jstats = _reference()
    tspecs = get_model("scene", num_classes=CLASSES, width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    tnet = convert_flagship(tspecs, (H, W, 3), cfg, thresholds=[TAU] * 6,
                            extra_overrides={0: "dense_cached"})
    tparams = params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")
    tframes, tlabels = SpriteVideo(SpriteVideoConfig(**VIDEO)) \
        .clip_with_labels(T)
    ys, state, stats = scan_video(tnet, tparams, torch.from_numpy(tframes),
                                  collect_stats=True, refresh_start=True)
    return dict(jnet=jnet, frames=frames, labels=labels, jys=jys,
                jstates=jstates, jstats=jstats, tnet=tnet, tframes=tframes,
                tlabels=tlabels, ys=ys, state=state, stats=stats)


def test_video_copy_is_byte_identical(runs):
    assert runs["tframes"].tobytes() == runs["frames"].tobytes()
    assert runs["tlabels"].tobytes() == runs["labels"].tobytes()


def test_reference_diffs_keep_clear_of_tau(runs):
    """No detect input pixel of the reference run sits within 1e-4 of tau
    (pixels with a zero diff cannot flip)."""
    net, states, frames = runs["jnet"], runs["jstates"], runs["frames"]
    shapes = [(H, W, 3)] + j_out_shapes(net.specs, (H, W, 3))
    margin = np.inf
    for t in range(1, T):
        for k in DETECT_LAYERS:
            h, w, c = shapes[k]
            lcfg = j_layer_cfg(net.specs[k], net.cfg)
            cst = states[t][k].in_cache.shape[-1] if k else c
            g = j_geometry(net.specs[k], (h, w, cst), lcfg)
            before = np.asarray(j_interior(states[t - 1][k].in_cache, g))
            x = (frames[t] if k == 0 else
                 np.asarray(states[t][k - 1].out_cache)[:h, :w])
            d = np.abs(x.astype(np.float32)
                       - before[..., :x.shape[-1]]).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    assert margin > 1e-4, margin


def test_specs_match(runs):
    jspecs = [dataclasses.asdict(s) for s in runs["jnet"].specs]
    tspecs = [dataclasses.asdict(s) for s in runs["tnet"].specs]
    for d in jspecs:
        if d.get("backend") == "pallas":
            d["backend"] = "cuda"
    assert tspecs == jspecs


def test_per_layer_stats_identical(runs):
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


def test_outputs_match(runs):
    jys = np.stack([np.asarray(y) for y in runs["jys"]])
    ys = runs["ys"].numpy()
    np.testing.assert_allclose(ys, jys, atol=1e-4)
    np.testing.assert_array_equal(ys.argmax(-1), jys.argmax(-1))


def test_final_caches_match(runs):
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
        g = _geometry(net.specs[k], shapes[k], net.cfg)
        cin = shapes[k][2]
        jint = np.asarray(js.in_cache)[
            g.store_lo_h:g.store_lo_h + g.in_h,
            g.store_lo_w:g.store_lo_w + g.in_w, :cin]
        np.testing.assert_allclose(storage_interior(ts.in_cache, g).numpy(),
                                   jint, atol=1e-4,
                                   err_msg=f"layer {k} in cache")


def test_flops_and_gt_miou_equal(runs):
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
