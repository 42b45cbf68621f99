"""Every geometry the JAX package runs, through the port's kernel layers on
the CPU, against the reference's ``"pallas"`` backend in interpret mode.

Three kinds of input the reference computes with XLA ops where its Pallas
gates do not hold, and which the port runs through its kernels:
- ragged maps (fewer than 8 rows, or a width off the 8-pixel grid) in a
  hinted layer: the sparse detect and the tile copy take the partial last
  hint row and column (``_detect_and_mask``, ``_accept_hinted``; the
  probe net, a VGG-style ``nn.Sequential`` of five conv+pool stages
  imported through ``specs_from_torch`` and ``convert_flagship``, whose
  maps at 160x320 go 10x20 and 5x10);
- a 3-channel CB stem on the kernel path (the plain ``convert``): its
  input cache is stored at the tile convs' channel grid with zero channels
  past the frame's, which the full-map detect never touches;
- configured tiles that are not whole 8x8 cells under ``patch_stem``: the
  stem detect emits its mask at a cell of 4.

Tolerances: masks, changed-pixel counts, detect tiles, computed tiles and
the accepted caches are exact (the end-to-end runs assert that no
reference diff lies within 1e-4 of tau, so a rounding difference cannot
flip a decision); conv outputs and out caches agree within 1e-4 (float32
sums in another order), as in the other parity tests.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import layers as jlayers
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.network import out_shapes as j_out_shapes
from cbinfer_tpu.ops import flat4 as jflat4
from cbinfer_tpu.ops.delta_conv import storage_interior as j_interior
from cbinfer_tpu.ops.geometry import conv_tile_geometry as j_geometry

from _torch_carry import storage_to_flat4
from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch import metrics as tmetrics
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.convert import (convert, convert_flagship,
                                       specs_from_torch)
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.ops.delta_conv import storage_interior
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.runner import scan_video

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the probe net it runs on the card)

TAU = 0.05
PROBE_WIDTHS = (16, 32, 32, 64, 64)  # the card's 64-128-256-256-256, cut
RAGGED = [(4, 16), (16, 12), (10, 20), (5, 10)]
# the two layer kinds a hinted detect serves: a 3x3 SAME conv, a 2x2 pool
KINDS = {"conv": ((3, 3), (1, 1), "SAME"), "pool": ((2, 2), (2, 2), "VALID")}


def _hint(rng, H, W):
    hint = rng.random((-(-H // 8), -(-W // 8))) < 0.6
    hint[-1, -1] = True  # the partial corner tile is always listed
    return hint


def _layer_inputs(H, W, C, kind, seed):
    """x, the storage (conv: zero margins; pool: the "-inf" fill) and a
    hint, both packages' geometries. Outside the hinted tiles x equals the
    accepted cache (what a producer guarantees: it changed nothing there),
    inside it moves by 0 or by 0.2..1.0, well clear of tau."""
    rng = np.random.default_rng(seed)
    k, s, pad = KINDS[kind]
    g = conv_tile_geometry((H, W, C), k, s, (1, 1), pad, 8, 8)
    jg = j_geometry((H, W, C), k, s, (1, 1), pad, 8, 8)
    hint = _hint(rng, H, W)
    pix = np.repeat(np.repeat(hint, 8, 0), 8, 1)[:H, :W]
    margin = tlayers.NEG_FILL if kind == "pool" else 0.0
    st = np.full(g.store_shape, margin, np.float32)
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = prev
    move = (rng.random((H, W, 1)) < 0.5) * rng.uniform(0.2, 1.0, (H, W, C))
    x = np.where(pix[..., None], prev + move, prev).astype(np.float32)
    # the producer's out cache is padded past the logical map
    xp = np.zeros((H + 3, W + 5, C), np.float32)
    xp[:H, :W] = x
    return g, jg, xp, st, hint


@pytest.mark.parametrize("H,W", RAGGED)
@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_detect_and_mask_on_ragged_maps(H, W, kind):
    """The hinted ``"cuda"`` detect (the sparse detect kernel's plain
    version) against the reference's route for the same map (XLA ops: its
    Pallas gate needs 8 rows and 8-aligned columns): storage, mask at the
    layer's tile grid, npix and n_detect exact."""
    g, jg, xp, st, hint = _layer_inputs(H, W, 8, kind, H * 100 + W)
    jcfg = JCfg(backend="pallas", interpret=True)
    margin = tlayers.NEG_FILL if kind == "pool" else 0.0
    want = jlayers._detect_and_mask(
        jnp.asarray(xp), jnp.asarray(st), TAU, jg, jcfg,
        jlayers.DirtyHint(mask=jnp.asarray(hint)), margin_fill=margin)
    st_t = torch.from_numpy(st.copy())
    got = tlayers._detect_and_mask(
        torch.from_numpy(xp), st_t, TAU, g, PipelineConfig(device="cpu"),
        tlayers.DirtyHint(mask=torch.from_numpy(hint)))
    assert got[0] is st_t  # in place
    np.testing.assert_array_equal(storage_interior(st_t, g).numpy(),
                                  np.asarray(j_interior(want[0], jg)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) > 0
    assert int(got[3]) == int(want[3]) == int(hint.sum())


@pytest.mark.parametrize("H,W", RAGGED)
def test_accept_hinted_on_ragged_maps(H, W):
    """A forward-hint conv's tile copy (the kernel's plain version) against
    the reference's route (a full-map ``where``): the storage exact, the
    margins untouched, n_detect the hinted tiles."""
    g, jg, xp, st, hint = _layer_inputs(H, W, 16, "conv", H * 10 + W)
    want, jn = jlayers._accept_hinted(
        jnp.asarray(xp), jnp.asarray(st),
        jlayers.DirtyHint(mask=jnp.asarray(hint)), jg,
        JCfg(backend="pallas", interpret=True))
    st_t = torch.from_numpy(st.copy())
    got, n = tlayers._accept_hinted(
        torch.from_numpy(xp), st_t, tlayers.DirtyHint(
            mask=torch.from_numpy(hint)), g)
    assert got is st_t
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(want))
    assert int(n) == int(jn) == int(hint.sum())


# ----------------------------- end to end ------------------------------------


def _clip(h, w, t, seed):
    return jvideo.SpriteVideo(jvideo.SpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, speed=2.0,
        noise_std=0.0, seed=seed)).clip(t)


def _reference_frames(net, params, frames):
    """Frame-by-frame reference run (a refresh, then apply), keeping every
    state."""
    y, st, s = jax.jit(net.apply_refresh)(params, net.init_state(),
                                          jnp.asarray(frames[0]))
    apply = jax.jit(net.apply)
    ys, states, stats = [y], [st], [s]
    for f in frames[1:]:
        y, st, s = apply(params, st, jnp.asarray(f))
        ys.append(y)
        states.append(st)
        stats.append(s)
    return ys, states, stats


def _detect_margin(net, params, frames, states, in_shape):
    """The smallest distance from tau of any nonzero per-pixel diff a CB
    layer of the reference run saw (its input at frame t against its
    accepted cache after frame t - 1)."""
    shapes = [tuple(in_shape)] + j_out_shapes(net.specs, in_shape)
    margin = np.inf
    for t in range(1, len(frames)):
        for k, spec in enumerate(net.specs):
            if states[t][k] is None or (
                    getattr(spec, "elide_in_cache", False)):
                continue
            h, w, c = shapes[k]
            lcfg = jlayers._layer_cfg(spec, net.cfg)
            if lcfg.backend == "patch_stem":
                before = np.asarray(jflat4.from_flat4(
                    states[t - 1][k].in_cache, jflat4.flat4_geom(h, w, c)))
            else:
                cst = states[t][k].in_cache.shape[-1]
                g = jlayers._geometry(spec, (h, w, cst), lcfg)
                before = np.asarray(j_interior(states[t - 1][k].in_cache, g))
            x = frames[t] if k == 0 else np.asarray(
                states[t][k - 1].out_cache)[:h, :w]
            d = np.abs(x[..., :c].astype(np.float32)
                       - before[..., :c].astype(np.float32)).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    return margin


def _run_both(jnet, jparams, tnet, tparams, frames):
    jys, jstates, jstats = _reference_frames(jnet, jparams, frames)
    ys, state, stats = scan_video(tnet, tparams, torch.from_numpy(frames),
                                  collect_stats=True, refresh_start=True)
    margin = _detect_margin(jnet, jparams, frames, jstates, tnet.in_shape)
    return dict(jnet=jnet, tnet=tnet, jys=jys, jstates=jstates,
                jstats=jstats, ys=ys, state=state, stats=stats,
                margin=margin)


def _check_stats(r):
    jstats, tstats = r["jstats"], r["stats"]
    assert len(tstats) == len(jstats[0])
    for k, ts in enumerate(tstats):
        if not jstats[0][k]:
            assert ts == {}
            continue
        for key in jstats[0][k]:
            want = [int(np.asarray(s[k][key])) for s in jstats]
            got = [int(v) for v in ts[key].tolist()]
            assert got == want, (k, key, got, want)


def _check_outputs(r):
    jys = np.stack([np.asarray(y) for y in r["jys"]])
    ys = r["ys"].numpy()
    assert ys.shape == jys.shape
    np.testing.assert_allclose(ys, jys, atol=1e-4)
    np.testing.assert_array_equal(ys.argmax(-1), jys.argmax(-1))


def _check_caches(r):
    """Out caches within 1e-4; input caches' logical interiors exact where
    the accepted values are copies (every layer but those fed by a conv,
    whose outputs agree within 1e-4), their zero channels zero."""
    net = r["tnet"]
    shapes = [net.in_shape] + out_shapes(net.specs, net.in_shape)
    for k, (js, ts) in enumerate(zip(r["jstates"][-1], r["state"])):
        if ts is None:
            assert js is None
            continue
        c = ts.out_cache.shape[-1]
        np.testing.assert_allclose(
            ts.out_cache.numpy(), np.asarray(js.out_cache)[..., :c],
            atol=1e-4, err_msg=f"layer {k} out cache")
        if ts.in_cache.shape == (1, 1, 1):
            continue
        spec = net.specs[k]
        lcfg = tlayers._layer_cfg(spec, net.cfg)
        h, w, cin = shapes[k]
        g = tlayers._geometry(spec, (h, w, ts.in_cache.shape[-1]), lcfg)
        if lcfg.backend == "patch_stem":
            fg = jflat4.flat4_geom(h, w, cin)
            np.testing.assert_array_equal(
                storage_to_flat4(ts.in_cache.numpy(), fg, g),
                np.asarray(js.in_cache), err_msg=f"layer {k} in cache")
            continue
        got = storage_interior(ts.in_cache, g).numpy()
        want = np.asarray(js.in_cache)[g.store_lo_h:g.store_lo_h + h,
                                       g.store_lo_w:g.store_lo_w + w, :cin]
        np.testing.assert_allclose(got[..., :cin], want, atol=1e-4,
                                   rtol=0, err_msg=f"layer {k} in cache")
        assert not got[..., cin:].any(), f"layer {k}: zero channels moved"


PROBE_HW, PROBE_T, PROBE_SEED = (160, 320), 3, 5


@pytest.fixture(scope="module")
def probe_runs():
    """The probe net at 160x320 (maps down to 10x20 and 5x10, the last
    three stages ragged) through both packages' importers and flagship
    converters, three frames of a noise-free sprite clip."""
    module = chip_smoke.probe_module(torch, PROBE_WIDTHS)
    h, w = PROBE_HW
    jspecs, jparams = jconvert.specs_from_torch(module)
    jcfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    jnet = jconvert.convert_flagship(jspecs, (h, w, 3), jcfg)
    n_cb = jconvert.num_cb_layers(jnet.specs)
    jnet = jconvert.convert(jnet.specs, (h, w, 3), jcfg,
                            thresholds=[TAU] * n_cb)
    specs, params = specs_from_torch(module, device="cpu")
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    tnet = convert_flagship(specs, (h, w, 3), cfg, thresholds=[TAU] * n_cb)
    frames = _clip(h, w, PROBE_T, PROBE_SEED)
    return _run_both(jnet, jparams, tnet, params, frames)


def test_probe_net_takes_ragged_maps(probe_runs):
    net = probe_runs["tnet"]
    shapes = [net.in_shape] + out_shapes(net.specs, net.in_shape)
    ragged = [s[:2] for s, spec in zip(shapes, net.specs)
              if getattr(spec, "use_cb", False)
              and (s[0] < 8 or s[1] % 8)]
    assert ragged == [(10, 20), (10, 20), (5, 10)]
    assert net.specs[0].backend == "patch_stem"
    assert probe_runs["margin"] > 1e-4, probe_runs["margin"]


def test_probe_net_stats_identical(probe_runs):
    _check_stats(probe_runs)


def test_probe_net_outputs_match(probe_runs):
    assert tuple(probe_runs["ys"].shape) == (PROBE_T, 5, 10, 8)
    _check_outputs(probe_runs)


def test_probe_net_caches_match(probe_runs):
    _check_caches(probe_runs)


SMALL_HW, SMALL_T = (32, 64), 4


def _small_specs(conv, pool, flagship):
    """A 3x3 stem (3 -> 8) and a 2x2 pool; for the flagship converter also
    a 3x3 conv and a trailing 1x1 (which it runs dense)."""
    specs = [conv(features=8), pool()]
    if flagship:
        specs += [conv(features=8), conv(features=8, kernel=(1, 1))]
    return specs


def _small_pair(tile, plain, seed):
    """A small net at 32x64 through both packages: the plain ``convert``
    (every layer CB, the stem on the kernel path) or the flagship at
    ``tile``; the reference's params carried across."""
    from cbinfer_tpu.config import ConvSpec as JConv
    from cbinfer_tpu.config import PoolSpec as JPool
    from cbinfer_tpu_torch.config import ConvSpec, PoolSpec
    h, w = SMALL_HW
    jspecs = _small_specs(JConv, JPool, not plain)
    tspecs = _small_specs(ConvSpec, PoolSpec, not plain)
    jcfg = JCfg(tile=JTile(*tile, 0.375), backend="pallas", interpret=True)
    cfg = PipelineConfig(tile=TileConfig(*tile, 0.375), device="cpu")
    taus = [TAU] * (2 if plain else 3)
    if plain:
        jnet = jconvert.convert(jspecs, (h, w, 3), jcfg, thresholds=taus)
        tnet = convert(tspecs, (h, w, 3), cfg, thresholds=taus)
    else:
        jnet = jconvert.convert_flagship(jspecs, (h, w, 3), jcfg,
                                         thresholds=taus)
        tnet = convert_flagship(tspecs, (h, w, 3), cfg, thresholds=taus)
    jparams = j_init_params(jspecs, (h, w, 3), jax.random.PRNGKey(seed))
    tparams = params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")
    return _run_both(jnet, jparams, tnet, tparams,
                     _clip(h, w, SMALL_T, seed))


@pytest.fixture(scope="module")
def cin3_runs():
    return _small_pair((8, 8), True, 3)


def test_cin3_stem_runs_on_the_kernel_path(cin3_runs):
    """The stem is a ``"cuda"`` CB conv whose input cache holds 8 (float32:
    4) channels, the frame's 3 and zeros."""
    net, st = cin3_runs["tnet"], cin3_runs["state"]
    assert all(getattr(s, "use_cb", True) for s in net.specs)
    assert net.specs[0].backend is None and net.cfg.backend == "cuda"
    assert st[0].in_cache.shape[-1] == 4  # float32's channel quantum
    assert tlayers.cache_channels(net.specs[0], 3, net.cfg) == (4, 8)
    assert cin3_runs["margin"] > 1e-4, cin3_runs["margin"]


def test_cin3_stem_stats_identical(cin3_runs):
    _check_stats(cin3_runs)


def test_cin3_stem_outputs_and_caches_match(cin3_runs):
    _check_outputs(cin3_runs)
    _check_caches(cin3_runs)


@pytest.fixture(scope="module", params=[(4, 4), (4, 8), (8, 4)],
                ids=["4x4", "4x8", "8x4"])
def fine_runs(request):
    r = _small_pair(request.param, False, 3)
    r["tile"] = request.param
    return r


def test_fine_tiles_stats_identical(fine_runs):
    """The patch_stem stem of the flagship converter at a configured tile that is not whole 8x8
    cells: the stem's changed and computed tiles on the configured grid,
    its npix, and every later layer's stats exact."""
    assert fine_runs["tnet"].specs[0].backend == "patch_stem"
    assert fine_runs["margin"] > 1e-4, fine_runs["margin"]
    _check_stats(fine_runs)
    th, tw = fine_runs["tile"]
    stem = fine_runs["stats"][0]
    assert int(stem["n_tiles"][-1]) == (32 // th) * (64 // tw)
    # the pool cannot forward the hint at such tiles: it re-detects
    assert not fine_runs["tnet"].specs[1].elide_in_cache


def test_fine_tiles_outputs_and_caches_match(fine_runs):
    _check_outputs(fine_runs)
    _check_caches(fine_runs)


def test_fine_tiles_flops_equal(fine_runs):
    """effective_flops prices the configured grid as the reference does."""
    from cbinfer_tpu import metrics as jmetrics
    jstats = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *fine_runs["jstats"])
    th, tw = fine_runs["tile"]
    want = jmetrics.effective_flops(jstats, fine_runs["jnet"].specs,
                                    (32, 64, 3), th, tw)
    got = tmetrics.effective_flops(fine_runs["stats"],
                                   fine_runs["tnet"].specs, (32, 64, 3),
                                   th, tw)
    assert got == want


def test_hinted_conv_takes_a_raw_input_off_the_channel_grid():
    """A hinted ``"cuda"`` conv fed a raw input of 6 channels (a DAG's
    concat off the grid; its input cache holds 8) on a ragged 20x36 map,
    one cold frame and one hinted frame, against the reference's layer
    in interpret mode: stats exact, outputs within 1e-5."""
    from cbinfer_tpu.config import ConvSpec as JConv
    from cbinfer_tpu_torch.config import ConvSpec
    rng = np.random.default_rng(11)
    H, W, C = 20, 36, 6
    x0 = rng.standard_normal((H, W, C)).astype(np.float32)
    x1 = x0.copy()
    x1[3:9, 20:27] += 0.5
    hint = np.zeros((3, 5), bool)
    hint[0, 2:4] = hint[1, 2:4] = True
    w = (rng.standard_normal((3, 3, C, 8)) * 0.3).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    jcfg = JCfg(backend="pallas", interpret=True)
    cfg = PipelineConfig(device="cpu")
    jst = jlayers.cb_layer_init(JConv(features=8), (H, W, C), jcfg)
    tst = tlayers.cb_layer_init(ConvSpec(features=8), (H, W, C), cfg)
    assert tst.in_cache.shape[-1] == 8
    hints = [np.ones((3, 5), bool), hint]
    for x, h in zip((x0, x1), hints):
        jy, jst, jstats, _ = jlayers.cb_conv_apply(
            (jnp.asarray(w), jnp.asarray(b)), jst, jnp.asarray(x),
            JConv(features=8), jcfg, TAU,
            jlayers.DirtyHint(mask=jnp.asarray(h)))
        ty, tst, tstats, _ = tlayers.cb_conv_apply(
            (torch.from_numpy(w), torch.from_numpy(b)), tst,
            torch.from_numpy(x), ConvSpec(features=8), cfg, TAU,
            tlayers.DirtyHint(mask=torch.from_numpy(h)))
        for key in jstats:
            assert int(tstats[key]) == int(np.asarray(jstats[key])), key
        np.testing.assert_allclose(ty.crop().numpy(), np.asarray(jy.crop()),
                                   atol=1e-5)
    assert int(tstats["changed_pixels"]) > 0
    assert not tst.in_cache[..., C:].any()
