"""The seg slice on the CPU: the port's seg models, converter flags,
``zoo.load("seg")`` and its refresh cadence, the argmax-then-upsample class
map of ``Workload.upsample_scale``, and a small seg net (width 8 at 64x128,
the dilated 3x3 included) streamed through ``scan_video`` against the JAX
package's ``"pallas"`` path in interpret mode, on the same clip with the
JAX package's ``init_params`` carried across.

As in ``test_torch_pose.py``: stats identical, outputs and caches within
5e-6 (float32, another summation order), and no detect input of the
reference run within 1.5e-5 of tau (asserted), so that a rounding
difference can never flip a detect decision.
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
from cbinfer_tpu import video as jvideo
from cbinfer_tpu import zoo as jzoo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.config import UpsampleSpec as JUpsample
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import init_params as j_init_params

from _torch_carry import cache_from_lanes, cache_to_lanes
from cbinfer_tpu_torch import metrics as tmetrics
from cbinfer_tpu_torch import network, zoo
from cbinfer_tpu_torch import video as tvideo
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import (PipelineConfig, TileConfig,
                                      UpsampleSpec)
from cbinfer_tpu_torch.convert import convert_flagship, num_cb_layers
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.runner import scan_video

H, W, T, TAU, SEED, WIDTH, CLASSES = 64, 128, 6, 0.05, 3, 8, 8
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=12, speed=2.0,
             noise_std=0.0, seed=SEED)
JCFG = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
TCFG = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
DILATED = 7  # the 3x3 of dilation 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: these tests run beside other
    test processes, where a small CPU op's worker threads mostly wait for
    one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _as_cuda(specs):
    out = [dataclasses.asdict(s) for s in specs]
    for d in out:
        if d.get("backend") == "pallas":
            d["backend"] = "cuda"
    return out


def class_map_x4(y: torch.Tensor) -> torch.Tensor:
    """What callers of a stripped workload do: argmax to a uint8 class map,
    then the nearest upsample of the map."""
    return network.upsample(y.argmax(-1).to(torch.uint8)[..., None],
                            UpsampleSpec(scale=(4, 4)))[..., 0]


# ------------------------------ model, converter -----------------------------


@pytest.mark.parametrize("name,kw", [("seg", {}), ("seg", {"width": 8}),
                                     ("seg", {"num_classes": 8}),
                                     ("seg_small", {})])
def test_model_matches_reference(name, kw):
    want = [dataclasses.asdict(s) for s in j_get_model(name, **kw)]
    assert [dataclasses.asdict(s) for s in get_model(name, **kw)] == want
    if name == "seg" and not kw:
        assert len(want) == 11 and want[DILATED]["dilation"] == (2, 2)
        assert want[-1]["kind"] == "upsample"


@pytest.mark.parametrize("shape", [(720, 1280, 3), (H, W, 3), (360, 640, 3)])
@pytest.mark.parametrize("kw", [
    {}, dict(fuse_detect=True), dict(extra_overrides={0: "dense_cached"}),
    dict(fuse_detect=True, extra_overrides={DILATED: "forward_hint"}),
])
def test_convert_flagship_marks_the_same_layers(shape, kw):
    specs = get_model("seg", num_classes=CLASSES, width=64)[:-1]
    jspecs = j_get_model("seg", num_classes=CLASSES, width=64)[:-1]
    jnet = jconvert.convert_flagship(jspecs, shape, JCFG, **kw)
    tnet = convert_flagship(specs, shape, TCFG, **kw)
    assert [dataclasses.asdict(s) for s in tnet.specs] == _as_cuda(jnet.specs)
    assert num_cb_layers(tnet.specs) == 9
    if shape[0] == 720 and not kw:
        assert tnet.specs[0].backend == "patch_stem"
        assert [s.elide_in_cache for s in tnet.specs if s.kind == "pool"] \
            == [True, True]
        assert not tnet.specs[-1].use_cb  # the classifier runs dense
        assert not any(getattr(s, "fuse_next_detect", False)
                       for s in tnet.specs)


# ------------------------------------ zoo ------------------------------------


@pytest.mark.parametrize("kw", [{}, {"apply_policy": False}, {"tau": 0.03},
                                {"strip_trailing_upsample": False}])
def test_zoo_load_seg_matches_reference(kw):
    shape = (720, 1280, 3)
    jw = jzoo.load("seg", shape, JCFG, **kw)
    tw = zoo.load("seg", shape, TCFG, **kw)
    assert [dataclasses.asdict(s) for s in tw.net.specs] \
        == _as_cuda(jw.net.specs)
    for f in ("name", "kind", "metric", "weights", "tau_source",
              "policy_source", "warnings", "upsample_scale", "fuse_detect",
              "taus", "refresh_every"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert tw.kind == "sequential" and tw.metric == "miou"
    assert tw.weights == "trained(npz)" and len(tw.taus) == 9
    assert tw.fuse_detect is False and tw.policy_source == "none"
    if kw.get("strip_trailing_upsample") is False:
        assert tw.upsample_scale is None and tw.specs[-1].kind == "upsample"
    else:
        assert tw.upsample_scale == (4, 4) and tw.specs[-1].kind == "conv"
    if not kw:
        assert tw.tau_source == "tuned"
        np.testing.assert_allclose(tw.taus, [0.045] * 6 + [0.15] * 3,
                                   rtol=1e-6)
    for tp, jp in zip(tw.params, jw.params):
        if jp is None:
            assert tp is None
            continue
        np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
        np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
    assert tuple(tw.params[DILATED][0].shape) == (3, 3, 256, 256)


@pytest.mark.parametrize("t", [32, 12])
def test_seg_refresh_cadence_matches_reference(t):
    """REFRESH_seg.json validated no cadence: the default of 2."""
    got = zoo.load_refresh_cadence("seg", t, 720, 1280)
    assert got == jzoo.load_refresh_cadence("seg", t, 720, 1280)
    assert got[0] == 2 and got[1].startswith("default")


def test_class_map_upsample_is_argmax_transparent():
    """argmax then nearest x4 of the uint8 map == argmax of the nearest-x4
    logits, the reference's full-resolution output."""
    rng = np.random.default_rng(5)
    y = rng.standard_normal((9, 16, CLASSES)).astype(np.float32)
    full = jnetwork.upsample(jnp.asarray(y), JUpsample(scale=(4, 4)))
    want = np.asarray(jnp.argmax(full, -1))
    got = class_map_x4(torch.from_numpy(y))
    assert got.dtype == torch.uint8 and got.shape == (36, 64)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------ the small seg net ----------------------------


@pytest.fixture(scope="module")
def runs():
    specs = j_get_model("seg", num_classes=CLASSES, width=WIDTH)[:-1]
    jnet = jconvert.convert_flagship(specs, (H, W, 3), JCFG,
                                     thresholds=[TAU] * 9)
    jparams = j_init_params(specs, (H, W, 3), jax.random.PRNGKey(SEED))
    frames, labels = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(
        **VIDEO, **jvideo.workload_video_kwargs("seg"))).clip_with_labels(T)
    apply = jax.jit(jnet.apply)
    y, st, s = jax.jit(jnet.apply_refresh)(jparams, jnet.init_state(),
                                           jnp.asarray(frames[0]))
    jys, jstates, jstats = [y], [st], [s]
    for t in range(1, T):
        y, st, s = apply(jparams, st, jnp.asarray(frames[t]))
        jys.append(y)
        jstates.append(st)
        jstats.append(s)
    tspecs = get_model("seg", num_classes=CLASSES, width=WIDTH)[:-1]
    tparams = params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")
    out = {}
    for name, kw in (("plain", {}), ("fused", dict(fuse_detect=True))):
        tnet = convert_flagship(tspecs, (H, W, 3), TCFG,
                                thresholds=[TAU] * 9, **kw)
        ys, state, stats = scan_video(tnet, tparams,
                                      torch.from_numpy(frames),
                                      collect_stats=True, refresh_start=True)
        out[name] = dict(net=tnet, ys=ys, state=state, stats=stats)
    return dict(jnet=jnet, frames=frames, labels=labels, jys=jys,
                jstates=jstates, jstats=jstats, tparams=tparams, **out)


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
        for k, spec in enumerate(net.specs):
            if spec.kind == "pool" or not spec.use_cb:
                continue  # forward-hint pools compare nothing
            h, w, c = shapes[k]
            if k == 0:
                before = np.asarray(jflat4.from_flat4(
                    states[t - 1][0].in_cache, jflat4.flat4_geom(h, w, c)))
                x = frames[t]
            else:
                cst = states[t][k].in_cache.shape[-1]
                g = j_geometry(spec, (h, w, cst), j_layer_cfg(spec, net.cfg))
                before = np.asarray(j_interior(states[t - 1][k].in_cache, g))
                x = np.asarray(states[t][k - 1].out_cache)[:h, :w]
            d = np.abs(x.astype(np.float32)[..., :c] - before[..., :c]).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    assert margin > 1.5e-5, margin


def test_small_seg_stats_identical_to_reference(runs):
    jstats = runs["jstats"]
    for name in ("plain", "fused"):
        tstats = runs[name]["stats"]
        assert len(tstats) == len(jstats[0]) == 10
        for k, ts in enumerate(tstats):
            if not jstats[0][k]:
                assert ts == {}
                continue
            for key in jstats[0][k]:
                want = [int(np.asarray(s[k][key])) for s in jstats]
                got = [int(v) for v in ts[key].tolist()]
                assert got == want, (name, k, key, got, want)
    st = runs["plain"]["stats"][DILATED]
    assert 0 < int(st["computed_tiles"][-1]) < int(st["n_tiles"][-1])


def test_small_seg_outputs_caches_and_maps_match_reference(runs):
    jys = np.stack([np.asarray(y) for y in runs["jys"]])
    ys = runs["plain"]["ys"]
    assert tuple(ys.shape) == (T, H // 4, W // 4, CLASSES)
    np.testing.assert_allclose(ys.numpy(), jys, atol=5e-6)
    # the full-resolution class maps: argmax then x4, against the
    # reference's argmax of its x4 logits
    maps = torch.stack([class_map_x4(y) for y in ys])
    np.testing.assert_array_equal(
        maps.numpy(), np.asarray(jnp.argmax(jnp.stack(
            [jnetwork.upsample(jnp.asarray(y), JUpsample(scale=(4, 4)))
             for y in jys]), -1)))
    it, un = tmetrics.iu_counts(maps[1:], torch.from_numpy(
        runs["labels"][1:]), CLASSES)
    assert 0.0 < tmetrics.merge_iu(it.numpy(), un.numpy()) <= 1.0
    jstats = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *runs["jstats"])
    net = runs["plain"]["net"]
    assert tmetrics.effective_flops(runs["plain"]["stats"], net.specs,
                                    (H, W, 3), 8, 8) \
        == jmetrics.effective_flops(jstats, runs["jnet"].specs, (H, W, 3),
                                    8, 8)
    shapes = [(H, W, 3)] + out_shapes(net.specs, (H, W, 3))
    for k, (js, ts) in enumerate(zip(runs["jstates"][-1],
                                     runs["plain"]["state"])):
        if ts is None:
            assert js is None
            continue
        np.testing.assert_allclose(
            ts.out_cache.numpy(),
            cache_from_lanes(js.out_cache, ts.out_cache.shape[-1]),
            atol=5e-6, err_msg=f"layer {k} out cache")
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


def test_fused_seg_stream_bit_identical_to_plain(runs):
    """seg's policy does not fuse; the fused kernel on its convs changes no
    bit."""
    a, b = runs["plain"], runs["fused"]
    assert any(getattr(s, "fuse_next_detect", False)
               for s in b["net"].specs)
    assert torch.equal(a["ys"], b["ys"])
    for k, (sa, sb) in enumerate(zip(a["stats"], b["stats"])):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (k, key)
    for sa, sb in zip(a["state"], b["state"]):
        if sa is not None:
            assert torch.equal(sa.in_cache, sb.in_cache)
            assert torch.equal(sa.out_cache, sb.out_cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trained_seg_on_graded_video(dtype):
    """The trained seg net through zoo.load at 64x128 with its tuned taus on
    the seg profile's video (graded dynamics, hard palette), 6 frames with a
    refresh every 3: full-resolution uint8 class maps through the out_map,
    dense on refresh frames, sparse in between, and the refresh frame's
    output is the dense path's."""
    cfg = dataclasses.replace(TCFG, compute_dtype=dtype, cache_dtype=dtype)
    wl = zoo.load("seg", (H, W, 3), cfg)
    clip = torch.from_numpy(tvideo.SpriteVideo(tvideo.SpriteVideoConfig(
        **{**VIDEO, "seed": 11, "noise_std": 0.002},
        **tvideo.workload_video_kwargs("seg"))).clip(6))
    maps, state, stats = scan_video(wl.net, wl.params, clip,
                                    thresholds=wl.taus, refresh_every=3,
                                    out_map=class_map_x4)
    assert maps.shape == (6, H, W) and maps.dtype == torch.uint8
    assert int(maps.max()) < CLASSES
    dense = class_map_x4(wl.net.apply_dense(wl.params, clip[3]))
    assert float((maps[3] == dense).float().mean()) > 0.99
    full = stats[1]["computed_tiles"] == stats[1]["n_tiles"]
    assert full.tolist() == [True, False, False] * 2
