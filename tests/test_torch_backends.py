"""The layer backends beside the kernels: the capacity-bounded plain path
(``"torch"``, the JAX package's ``"jnp"``) with its dense fallback,
``band_cached`` and ``dense_cached_flat``, and the ops under them
(``detect_and_update_flat``, ``delta_conv_jnp``, ``dense_conv_shifted``,
``delta_pool_jnp`` over sentinel-padded lists), on the CPU against the
JAX package's backend of the same name on the same seeded inputs.

Tolerances: detect, compaction, the pool and every counter are exact;
float32 convolutions agree within 1e-5 on one layer (another summation
order in the matmul library) and 1e-4 through a network. Within the port,
``band_cached`` and ``dense_cached_flat`` equal ``dense_cached`` bit for
bit in float32, as the JAX package's ``tests/test_band_stem.py`` and
``tests/test_stem_flat.py`` hold for its own backends; on the card in
bf16 the band path's float32 epilogue and the dense conv's bf16 output
differ by final-rounding ulps (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import layers as jlayers
from cbinfer_tpu import metrics as jmetrics
from cbinfer_tpu import network as jnetwork
from cbinfer_tpu import runner as jrunner
from cbinfer_tpu import tuner as jtuner
from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.netview import NetView as JNetView
from cbinfer_tpu.ops import compact as jcompact
from cbinfer_tpu.ops import delta_conv as jdc
from cbinfer_tpu.ops import delta_pool as jdp
from cbinfer_tpu.ops import detect as jdetect
from cbinfer_tpu.ops.geometry import conv_tile_geometry as j_geom
from cbinfer_tpu.video import SpriteVideo as JVideo
from cbinfer_tpu.video import SpriteVideoConfig as JVideoCfg

from cbinfer_tpu_torch import checkpoint, layers, metrics, tuner
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, PoolSpec
from cbinfer_tpu_torch.config import TileConfig
from cbinfer_tpu_torch.convert import (convert, convert_flagship,
                                       flagship_layers, num_cb_layers)
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.netview import NetView
from cbinfer_tpu_torch.ops import compact
from cbinfer_tpu_torch.ops import delta_conv as tdc
from cbinfer_tpu_torch.ops import delta_pool as tdp
from cbinfer_tpu_torch.ops import detect as tdetect
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.runner import pack_stats, scan_video, scan_video_jit
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

NEW_BACKENDS = ("torch", "band_cached", "dense_cached_flat")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _params_np(jparams):
    return [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
            for p in jparams]


# ------------------------------- the ops ------------------------------------


@pytest.mark.parametrize("C,tau", [(3, 0.05), (8, 0.0), (4, -1.0)])
def test_detect_and_update_flat_matches_jax(C, tau):
    rng = np.random.default_rng(C)
    H, W = 12, 20
    x = rng.standard_normal((H, W * C)).astype(np.float32)
    cache = x + (rng.random((H, W * C)) < 0.3) * rng.standard_normal(
        (H, W * C)).astype(np.float32) * 0.1
    cache = cache.astype(np.float32)
    jn, jc = jdetect.detect_and_update_flat(jnp.asarray(x),
                                            jnp.asarray(cache), tau, C)
    tn, tc = tdetect.detect_and_update_flat(_t(x), _t(cache), tau, C)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # in place into the cache: the same values, the same tensor
    c = _t(cache.copy())
    got, _ = tdetect.detect_and_update_flat(_t(x), c, tau, C, out=c)
    assert got.data_ptr() == c.data_ptr()
    np.testing.assert_array_equal(c.numpy(), np.asarray(jn))
    # the flat form is the HWC form on the same memory
    hn, hc = tdetect.detect_and_update(_t(x).view(H, W, C),
                                       _t(cache).view(H, W, C), tau)
    np.testing.assert_array_equal(hn.reshape(H, W * C).numpy(), tn.numpy())
    np.testing.assert_array_equal(hc.numpy(), tc.numpy())


# (cin, cout, kernel, stride, tiles changed, capacity): the im2col side of
# use_im2col (cin*k^2 <= 128) and the shifted side; lists shorter than
# the changed set (the tile path's sentinel-free overflow list), longer
# (sentinels to drop) and empty
CONV_JNP_CASES = {
    "im2col_sentinels": (3, 8, (3, 3), (1, 1), [0, 5, 7], 6),
    "im2col_full_list": (3, 8, (3, 3), (1, 1), [1, 2, 3, 4], 4),
    "shifted_sentinels": (16, 8, (3, 3), (1, 1), [2, 9], 5),
    "shifted_overflow_list": (16, 8, (3, 3), (1, 1), [0, 1, 2, 3, 8], 3),
    "strided": (8, 16, (3, 3), (2, 2), [0, 3], 4),
    "one_by_one": (24, 8, (1, 1), (1, 1), [1, 6], 3),
    "empty": (3, 8, (3, 3), (1, 1), [], 3),
    "last_tile_and_sentinels": (16, 8, (3, 3), (1, 1), [11], 4),
}


@pytest.mark.parametrize("case", sorted(CONV_JNP_CASES))
def test_delta_conv_jnp_matches_jax(case):
    cin, cout, k, s, tiles, cap = CONV_JNP_CASES[case]
    rng = np.random.default_rng(len(case))
    shape = (20, 32, cin)
    jg = j_geom(shape, k, s, (1, 1), "SAME", 8, 8)
    tg = conv_tile_geometry(shape, k, s, (1, 1), "SAME", 8, 8)
    xp = rng.standard_normal(jg.store_shape).astype(np.float32)
    w = (rng.standard_normal(k + (cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    out0 = rng.standard_normal((jg.out_h_pad, jg.out_w_pad, cout)).astype(
        np.float32)
    mask = np.zeros((jg.tiles_h, jg.tiles_w), bool)
    for t in tiles:
        mask.flat[t] = True
    jcomp = jcompact.compact_mask(jnp.asarray(mask), cap)
    tcomp = compact.compact_mask(_t(mask), cap)
    np.testing.assert_array_equal(tcomp.idx.numpy(), np.asarray(jcomp.idx))
    want = jdc.delta_conv_jnp(jnp.asarray(xp), jcomp.idx, jnp.asarray(w),
                              jnp.asarray(b), jnp.asarray(out0), jg, "relu")
    out = _t(out0.copy())
    got = tdc.delta_conv_jnp(_t(xp), tcomp.idx, _t(w), _t(b), out, tg,
                             "relu")
    assert got.data_ptr() == out.data_ptr()  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # tiles outside the list keep their old values bit for bit
    listed = set(int(i) for i in np.asarray(jcomp.idx) if i < jg.n_tiles)
    tiled = got.numpy().reshape(jg.tiles_h, jg.th, jg.tiles_w, jg.th, cout)
    old = out0.reshape(jg.tiles_h, jg.th, jg.tiles_w, jg.th, cout)
    for t in range(jg.n_tiles):
        if t not in listed:
            i, j = divmod(t, jg.tiles_w)
            np.testing.assert_array_equal(tiled[i, :, j], old[i, :, j])


@pytest.mark.parametrize("cin", [3, 8, 16])
def test_dense_conv_shifted_matches_jax_and_the_tile_path(cin):
    """Both sides of use_im2col; the dense fallback equals the tile path
    computed over every tile (the overflow contract)."""
    rng = np.random.default_rng(cin)
    shape = (20, 24, cin)
    g = conv_tile_geometry(shape, (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    jg = j_geom(shape, (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    xp = rng.standard_normal(g.store_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, 16)) * 0.2).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = jdc.dense_conv_shifted(jnp.asarray(xp), jnp.asarray(w),
                                  jnp.asarray(b), jg, "relu")
    got = tdc.dense_conv_shifted(_t(xp), _t(w), _t(b), g, "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert tdc.use_im2col(g) == jdc.use_im2col(jg) == (cin * 9 <= 128)
    every = torch.arange(g.n_tiles, dtype=torch.int32)
    tiles = tdc.delta_conv_jnp(_t(xp), every, _t(w), _t(b),
                               torch.zeros_like(got), g, "relu")
    np.testing.assert_allclose(tiles.numpy(), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("cap", [2, 5, 12])
def test_delta_pool_jnp_sentinels_match_jax(cap):
    rng = np.random.default_rng(cap)
    shape = (16, 24, 8)
    g = conv_tile_geometry(shape, (2, 2), (2, 2), (1, 1), "VALID", 4, 4)
    jg = j_geom(shape, (2, 2), (2, 2), (1, 1), "VALID", 4, 4)
    st = rng.standard_normal(g.store_shape).astype(np.float32)
    out0 = rng.standard_normal((g.out_h_pad, g.out_w_pad, 8)).astype(
        np.float32)
    mask = rng.random((g.tiles_h, g.tiles_w)) < 0.4
    jcomp = jcompact.compact_mask(jnp.asarray(mask), cap)
    want = jdp.delta_pool_jnp(jnp.asarray(st), jcomp.idx, jnp.asarray(out0),
                              jg)
    got = tdp.delta_pool_jnp(_t(st), compact.compact_mask(_t(mask), cap).idx,
                             _t(out0.copy()), g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------- one layer ----------------------------------


def _layer_frames():
    video = JVideo(JVideoCfg(height=32, width=48, n_sprites=1, sprite_size=6,
                             seed=5))
    return list(video.frames(6))


@pytest.mark.parametrize("kind", ["conv", "pool"])
def test_capacity_overflow_dense_fallback_is_value_exact(kind):
    """The JAX package's tests/test_pipeline_jnp.py case on the port's
    ``"torch"`` backend against the reference's ``"jnp"``, frame by frame:
    capacity 0.3, so frame 0 (every tile) overflows and later frames take
    the tile path. Out caches, input caches, every counter and the hint
    are equal (the conv's values within 2e-6)."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((3, 3, 3, 8)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((8,)) * 0.1).astype(np.float32)
    jcfg = JCfg(tile=JTile(8, 8, 0.3), backend="jnp")
    tcfg = PipelineConfig(tile=TileConfig(8, 8, 0.3), backend="torch",
                          device="cpu")
    if kind == "conv":
        jspec, tspec = JConv(features=8, threshold=0.02), \
            ConvSpec(features=8, threshold=0.02)
    else:
        jspec, tspec = JPool(threshold=0.02), PoolSpec(threshold=0.02)
    jst = jlayers.cb_layer_init(jspec, (32, 48, 3), jcfg)
    tst = layers.cb_layer_init(tspec, (32, 48, 3), tcfg)
    if kind == "conv":
        jstep = jax.jit(lambda s, x: jlayers.cb_conv_apply(
            (jnp.asarray(w), jnp.asarray(b)), s, x, jspec, jcfg))

        def tstep(s, x):
            return layers.cb_conv_apply((_t(w), _t(b)), s, x, tspec, tcfg)
    else:
        jstep = jax.jit(lambda s, x: jlayers.cb_pool_apply(s, x, jspec,
                                                           jcfg))

        def tstep(s, x):
            return layers.cb_pool_apply(s, x, tspec, tcfg)
    seen = set()
    for frame in _layer_frames():
        jy, jst, jstats, jhint = jstep(jst, jnp.asarray(frame))
        ty, tst, tstats, thint = tstep(tst, _t(frame))
        np.testing.assert_allclose(tst.out_cache.numpy(),
                                   np.asarray(jst.out_cache), atol=2e-6)
        np.testing.assert_array_equal(tst.in_cache.numpy(),
                                      np.asarray(jst.in_cache))
        for k in jstats:
            np.testing.assert_array_equal(_np(tstats[k]),
                                          np.asarray(jstats[k]), err_msg=k)
        np.testing.assert_array_equal(thint.mask.numpy(),
                                      np.asarray(jhint.mask))
        seen.add(bool(_np(tstats["overflow"])))
    assert seen == {True, False}  # both branches exercised


# --------------------------- the band stem ----------------------------------

BH, BW, BT = 96, 128, 6


@pytest.fixture(scope="module")
def band_setup():
    jspecs = j_get_model("scene", num_classes=8, width=32)
    jparams = jnetwork.init_params(jspecs, (BH, BW, 3), jax.random.PRNGKey(1))
    specs = get_model("scene", num_classes=8, width=32)
    params = params_from_numpy(specs, _params_np(jparams), device="cpu")
    clip = SpriteVideo(SpriteVideoConfig(
        height=BH, width=BW, n_sprites=3, sprite_size=16, seed=3)).clip(BT)
    return specs, params, torch.from_numpy(clip), jspecs, jparams, clip


def _band_run(setup, stem, backend="torch", taus=0.02, refresh=False,
              capacity=0.75, refresh_every=None):
    # capacity 0.75: the seed-3 sprites span 7 of 12 row bands, so the
    # band stem needs >= 7 band slots or every frame overflows
    specs, params, clip = setup[:3]
    cfg = PipelineConfig(tile=TileConfig(8, 8, capacity), backend=backend,
                         device="cpu")
    net = convert(specs, (BH, BW, 3), cfg,
                  thresholds=[taus] * num_cb_layers(specs),
                  backend_overrides={0: stem})
    st = net.init_state()
    ys, st, stats = scan_video(net, params, clip, state=st,
                               refresh_start=refresh,
                               refresh_every=refresh_every)
    if refresh:  # a second chunk: the refresh prolog on a warm state
        ys, st, stats = scan_video(net, params, clip, state=st,
                                   refresh_start=True)
    dense = torch.stack([net.apply_dense(params, f) for f in clip])
    return ys.numpy(), stats, dense.numpy(), net


def _jax_band_run(setup, stem, capacity=0.75, taus=0.02):
    jspecs, jparams, clip = setup[3:]
    cfg = JCfg(tile=JTile(8, 8, capacity_fraction=capacity), backend="jnp")
    net = jconvert.convert(jspecs, (BH, BW, 3), cfg,
                           thresholds=[taus] * jconvert.num_cb_layers(jspecs),
                           backend_overrides={0: stem})
    ys, _, stats = jax.jit(lambda p, f: jrunner.scan_video(net, p, f))(
        jparams, jnp.asarray(clip))
    return np.asarray(ys), jax.device_get(stats), net


def _assert_stats_equal(tstats, jstats):
    for ts, js in zip(tstats, jstats):
        for k in js:
            np.testing.assert_array_equal(_np(ts[k]).reshape(-1),
                                          np.asarray(js[k]).reshape(-1),
                                          err_msg=k)


def test_band_stem_bit_identical_to_dense_cached(band_setup):
    y_ref, _, _, _ = _band_run(band_setup, "dense_cached")
    y_band, stats, _, _ = _band_run(band_setup, "band_cached")
    np.testing.assert_array_equal(y_ref, y_band)
    computed = stats[0]["computed_tiles"].numpy()
    n_tiles = int(stats[0]["n_tiles"].numpy().reshape(-1)[0])
    assert computed.min() < n_tiles, (computed, n_tiles)
    # the reference's band stem: the same counters, values within 1e-4
    jy, jstats, _ = _jax_band_run(band_setup, "band_cached")
    _assert_stats_equal(stats, jstats)
    np.testing.assert_allclose(y_band, jy, atol=1e-4)


def test_band_stem_overflow_fallback_matches(band_setup):
    y_ref, _, _, _ = _band_run(band_setup, "dense_cached", capacity=0.05)
    y_band, stats, _, _ = _band_run(band_setup, "band_cached", capacity=0.05)
    assert int(stats[0]["overflow"].sum()) > 0
    np.testing.assert_array_equal(y_ref, y_band)
    jy, jstats, _ = _jax_band_run(band_setup, "band_cached", capacity=0.05)
    _assert_stats_equal(stats, jstats)
    np.testing.assert_allclose(y_band, jy, atol=1e-4)


def test_band_stem_refresh_prolog(band_setup):
    y_ref, _, _, _ = _band_run(band_setup, "dense_cached", refresh=True)
    y_band, _, _, _ = _band_run(band_setup, "band_cached", refresh=True)
    np.testing.assert_array_equal(y_ref, y_band)


def test_band_stem_tau0_matches_dense(band_setup):
    y_band, _, dense, _ = _band_run(band_setup, "band_cached", taus=0.0)
    np.testing.assert_allclose(y_band, dense, atol=1e-4, rtol=1e-4)


def test_band_stem_under_cuda_pipeline(band_setup):
    """The band stem's hint chain drives the ``"cuda"`` consumers (here
    their plain versions): tau 0 equals dense, and the hinted pipeline
    equals the one behind a dense_cached stem bit for bit."""
    y_band, _, dense, _ = _band_run(band_setup, "band_cached", taus=0.0,
                                    backend="cuda")
    np.testing.assert_allclose(y_band, dense, atol=1e-4, rtol=1e-4)
    y_b, s_b, _, _ = _band_run(band_setup, "band_cached", backend="cuda")
    y_d, s_d, _, _ = _band_run(band_setup, "dense_cached", backend="cuda")
    np.testing.assert_array_equal(y_b, y_d)
    for k in ("changed_tiles", "changed_pixels", "detect_tiles"):
        for ts, ds in zip(s_b[1:], s_d[1:]):
            if ts:
                np.testing.assert_array_equal(_np(ts[k]), _np(ds[k]))


def test_band_stem_refresh_stats_in_fine_units(band_setup):
    """A refresh frame reports the configured grid (a band is a row of it),
    not bands, or effective_flops underprices it."""
    _, stats, _, net = _band_run(band_setup, "band_cached", refresh_every=3)
    computed = stats[0]["computed_tiles"].numpy()
    n_tiles = int(stats[0]["n_tiles"].numpy().reshape(-1)[0])
    assert n_tiles == (BH // 8) * (BW // 8)          # fine grid, not bands
    assert computed[0] == n_tiles and computed[3] == n_tiles  # refresh
    assert computed[1] < n_tiles                     # a sparse frame skips
    # FLOP pricing of the band over-compute and the overflow frames equals
    # the reference's on the reference's own stats
    jy, jstats, jnet = _jax_band_run(band_setup, "band_cached",
                                     capacity=0.05)
    _, tstats, _, tnet = _band_run(band_setup, "band_cached", capacity=0.05)
    want = jmetrics.effective_flops(jstats, jnet.specs, (BH, BW, 3), 8, 8)
    got = metrics.effective_flops(tstats, tnet.specs, (BH, BW, 3), 8, 8)
    assert got["flop_reduction"] == pytest.approx(want["flop_reduction"],
                                                  rel=1e-12)


# ------------------------------ the flat stem -------------------------------

FSPECS = [
    ConvSpec(features=16, threshold=0.03),
    PoolSpec(threshold=0.03),
    ConvSpec(features=16, threshold=0.03),
    ConvSpec(features=5, kernel=(1, 1), activation=None, threshold=0.03),
]
JFSPECS = [
    JConv(features=16, threshold=0.03),
    JPool(threshold=0.03),
    JConv(features=16, threshold=0.03),
    JConv(features=5, kernel=(1, 1), activation=None, threshold=0.03),
]


def _flat_nets(backend="torch", h=32, w=48):
    base = PipelineConfig(tile=TileConfig(8, 8), backend=backend,
                          device="cpu")
    flat = convert(FSPECS, (h, w, 3), base,
                   backend_overrides={0: "dense_cached_flat"})
    ref = convert(FSPECS, (h, w, 3), base,
                  backend_overrides={0: "dense_cached"})
    jparams = jnetwork.init_params(JFSPECS, (h, w, 3),
                                   jax.random.PRNGKey(11))
    params = params_from_numpy(FSPECS, _params_np(jparams), device="cpu")
    return flat, ref, params, jparams


def _flat_clip(seed, **kw):
    return SpriteVideo(SpriteVideoConfig(height=32, width=48, n_sprites=2,
                                         sprite_size=7, seed=seed,
                                         **kw)).clip(5 if kw else 4)


def test_flat_stem_matches_dense_cached_pipeline():
    flat, ref, params, jparams = _flat_nets()
    clip = _flat_clip(31, speed=3.0, noise_std=0.01)
    ys_f, st_f, stats_f = scan_video(flat, params, torch.from_numpy(clip))
    ys_r, st_r, stats_r = scan_video(ref, params, torch.from_numpy(clip))
    np.testing.assert_array_equal(ys_f.numpy(), ys_r.numpy())
    _assert_stats_equal(stats_f, stats_r)
    # the flat cache is the HWC cache's interior, the same memory layout
    g = layers._geometry(ref.specs[0], (32, 48, 3),
                         layers._layer_cfg(ref.specs[0], ref.cfg))
    hwc = tdc.storage_interior(st_r[0].in_cache, g).numpy()
    np.testing.assert_array_equal(st_f[0].in_cache.numpy(),
                                  hwc.reshape(32, 48 * 3))
    # the reference's flat stem on its "jnp" pipeline
    jnet = jconvert.convert(JFSPECS, (32, 48, 3),
                            JCfg(tile=JTile(8, 8), backend="jnp"),
                            backend_overrides={0: "dense_cached_flat"})
    jys, jst, jstats = jrunner.scan_video(jnet, jparams, jnp.asarray(clip))
    np.testing.assert_allclose(ys_f.numpy(), np.asarray(jys), atol=1e-4)
    _assert_stats_equal(stats_f, jax.device_get(jstats))
    np.testing.assert_array_equal(st_f[0].in_cache.numpy(),
                                  np.asarray(jst[0].in_cache))


def test_flat_stem_refresh_matches():
    flat, ref, params, _ = _flat_nets()
    clip = torch.from_numpy(_flat_clip(32))
    ys_f, _, s_f = scan_video(flat, params, clip, refresh_every=2)
    ys_r, _, s_r = scan_video(ref, params, clip, refresh_every=2)
    np.testing.assert_array_equal(ys_f.numpy(), ys_r.numpy())
    _assert_stats_equal(s_f, s_r)


def test_flagship_never_selects_the_flat_stem():
    """The shipped policy picks patch_stem (a "cuda" pipeline where the
    flat4 gate holds) or dense_cached; dense_cached_flat stays an explicit
    override, and under convert_flagship it equals the dense_cached stem."""
    cfg_c = PipelineConfig(tile=TileConfig(8, 8), device="cpu")
    cfg_t = PipelineConfig(tile=TileConfig(8, 8), backend="torch",
                           device="cpu")
    # (32, 48) misses the flat4 gate (a width of whole 32-px stem tiles)
    assert flagship_layers(FSPECS, (32, 48, 3), cfg_c)[0] == \
        {0: "dense_cached"}
    assert flagship_layers(FSPECS, (32, 64, 3), cfg_c)[0] == \
        {0: "patch_stem"}
    assert flagship_layers(FSPECS, (32, 64, 3), cfg_t)[0] == \
        {0: "dense_cached"}
    jparams = jnetwork.init_params(JFSPECS, (32, 48, 3),
                                   jax.random.PRNGKey(12))
    params = params_from_numpy(FSPECS, _params_np(jparams), device="cpu")
    clip = torch.from_numpy(_flat_clip(33))
    outs = []
    for stem in ("dense_cached_flat", "dense_cached"):
        net = convert_flagship(FSPECS, (32, 48, 3), cfg_c,
                               extra_overrides={0: stem})
        assert net.specs[0].backend == stem
        outs.append(scan_video(net, params, clip)[0].numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


# ------------------------------ whole networks ------------------------------

NH, NW, NT, NTAU = 64, 128, 5, 0.05


@pytest.fixture(scope="module")
def scene_w8():
    jspecs = j_get_model("scene", num_classes=8, width=8)
    jparams = jnetwork.init_params(jspecs, (NH, NW, 3),
                                   jax.random.PRNGKey(3))
    specs = get_model("scene", num_classes=8, width=8)
    params = params_from_numpy(specs, _params_np(jparams), device="cpu")
    clip = SpriteVideo(SpriteVideoConfig(height=NH, width=NW, n_sprites=2,
                                         sprite_size=12, speed=2.0,
                                         seed=3)).clip(NT)
    return jspecs, jparams, specs, params, clip


def _forms(form):
    """(pipeline backend, extra_overrides) of each form."""
    return {"torch": ("torch", None),
            "torch_forward_hint": ("torch", {2: "forward_hint",
                                             5: "forward_hint"}),
            "band_cached": ("cuda", {0: "band_cached"}),
            "dense_cached_flat": ("cuda", {0: "dense_cached_flat"})}[form]


@pytest.mark.parametrize("form", NEW_BACKENDS + ("torch_forward_hint",))
def test_flagship_form_matches_reference(scene_w8, form):
    """convert_flagship with each new backend (the bounded plain pipeline
    with capacity 0.375, also with two convs forwarding their producer's
    hint by a full-map ``where``; a band or flat stem on the kernel
    pipeline)
    against the reference's form of the same names ("jnp"; "pallas" in
    interpret mode behind the stem): every counter equal, outputs within
    1e-4, argmax maps equal."""
    jspecs, jparams, specs, params, clip = scene_w8
    backend, extra = _forms(form)
    n_cb = 6
    jcfg = JCfg(tile=JTile(8, 8, 0.375),
                backend="jnp" if backend == "torch" else "pallas",
                interpret=True)
    jnet = jconvert.convert_flagship(jspecs, (NH, NW, 3), jcfg,
                                     thresholds=[NTAU] * n_cb,
                                     extra_overrides=extra)
    tnet = convert_flagship(specs, (NH, NW, 3),
                            PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                           backend=backend, device="cpu"),
                            thresholds=[NTAU] * n_cb, extra_overrides=extra)
    assert [getattr(s, "backend", None) for s in tnet.specs] == \
        [getattr(s, "backend", None) for s in jnet.specs]
    jys, _, jstats = jax.jit(lambda p, f: jrunner.scan_video(
        jnet, p, f, refresh_start=True))(jparams, jnp.asarray(clip))
    ys, st, stats = scan_video(tnet, params, torch.from_numpy(clip),
                               refresh_start=True)
    _assert_stats_equal(stats, jax.device_get(jstats))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=1e-4)
    np.testing.assert_array_equal(ys.numpy().argmax(-1),
                                  np.asarray(jys).argmax(-1))
    if form.startswith("torch"):
        assert any(bool(_np(s["overflow"]).any()) for s in stats if s)


@pytest.mark.parametrize("form", NEW_BACKENDS)
def test_graph_runner_forms_take_the_new_backends(scene_w8, form):
    """scan_video_jit (two chunks, the refresh key and the steady one) and
    FrameStepper on each form equal the eager loop; on CPU tensors both
    are that loop (tests/test_torch_gpu.py holds replays on the card)."""
    from cbinfer_tpu_torch.runner import FrameStepper
    _, _, specs, params, clip = scene_w8
    backend, extra = _forms(form)
    net = convert_flagship(specs, (NH, NW, 3),
                           PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                          backend=backend, device="cpu"),
                           thresholds=[NTAU] * 6, extra_overrides=extra)
    frames = torch.from_numpy(clip)
    want_st = net.init_state()
    run = scan_video_jit(net)
    got_st = net.init_state()
    for refresh in (True, False):
        want = scan_video(net, params, frames, want_st,
                          refresh_start=refresh)
        got = run(params, frames, got_st, refresh_start=refresh)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(pack_stats(got[2]).numpy(),
                                      pack_stats(want[2]).numpy())
    stepper = FrameStepper(net, params)  # frame 0 refreshes
    want = scan_video(net, params, frames[:3], net.init_state(),
                      refresh_start=True)[0]
    for t in range(3):
        np.testing.assert_array_equal(stepper(frames[t])[0].numpy(),
                                      want[t].numpy())


def test_pack_stats_carries_overflow(band_setup):
    _, stats, _, _ = _band_run(band_setup, "band_cached", capacity=0.05)
    packed = pack_stats(stats).numpy()
    ov = list(["changed_pixels", "changed_tiles", "computed_tiles",
               "detect_tiles", "n_tiles", "overflow"]).index("overflow")
    np.testing.assert_array_equal(packed[0, ov],
                                  stats[0]["overflow"].numpy().astype(int))
    assert packed[0, ov].sum() > 0


@pytest.mark.parametrize("form", NEW_BACKENDS)
def test_checkpoint_round_trips_the_new_caches(scene_w8, form, tmp_path):
    _, _, specs, params, clip = scene_w8
    backend, extra = _forms(form)
    net = convert_flagship(specs, (NH, NW, 3),
                           PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                          backend=backend, device="cpu"),
                           thresholds=[NTAU] * 6, extra_overrides=extra)
    frames = torch.from_numpy(clip)
    _, st, _ = scan_video(net, params, frames[:3])
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, params, st)
    like = net.init_state()
    got = checkpoint.restore(path, {"params": params, "state": like},
                             in_place=True)
    if form == "dense_cached_flat":
        assert like[0].in_cache.dim() == 2  # the flat (H, W*C) view
    for a, b in zip(st, like):
        if a is not None:
            np.testing.assert_array_equal(a.in_cache.numpy(),
                                          b.in_cache.numpy())
            np.testing.assert_array_equal(a.out_cache.numpy(),
                                          b.out_cache.numpy())
    # the restored state streams on exactly as the saved one
    y1 = scan_video(net, params, frames[3:], st)[0]
    y2 = scan_video(net, params, frames[3:], got["state"])[0]
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())


@pytest.mark.parametrize("form", NEW_BACKENDS)
def test_netview_and_dead_taus_match_reference(scene_w8, form):
    """NetView skips no row of the new backends, and the tuner's dead-tau
    analysis agrees with the reference's on the same form."""
    jspecs, _, specs, _, _ = scene_w8
    backend, extra = _forms(form)
    jcfg = JCfg(tile=JTile(8, 8, 0.375),
                backend="jnp" if backend == "torch" else "pallas",
                interpret=True)
    jnet = jconvert.convert_flagship(jspecs, (NH, NW, 3), jcfg,
                                     extra_overrides=extra)
    tnet = convert_flagship(specs, (NH, NW, 3),
                            PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                           backend=backend, device="cpu"),
                            extra_overrides=extra)
    jview = JNetView.from_specs(jnet.specs, (NH, NW, 3), jcfg)
    tview = NetView.of(tnet)
    assert [r.is_cb for r in tview.rows] == [r.is_cb for r in jview.rows]
    assert [tuner._tau_is_dead(tview, i) for i in range(len(tview.rows))] \
        == [jtuner._tau_is_dead(jview, i) for i in range(len(jview.rows))]


def test_stem_backends_refuse_a_pool():
    cfg = PipelineConfig(device="cpu")
    for backend in ("band_cached", "dense_cached_flat"):
        with pytest.raises(ValueError, match="conv layers"):
            layers.cb_layer_init(PoolSpec(backend=backend), (16, 16, 8), cfg)


@pytest.mark.parametrize("form", NEW_BACKENDS)
def test_graph_flagship_takes_the_new_backends_by_node_name(form):
    """convert_graph_flagship on the pose_graph DAG (w8, 64x128) with each
    new backend (the stem node by name, or the bounded plain pipeline)
    against the reference's same form on its "jnp" pipeline (a band or
    flat stem node there too): every counter of every node equal, outputs
    within 1e-4."""
    from cbinfer_tpu import graph as jgraph
    from cbinfer_tpu.models.pose import pose_graph as j_pose_graph
    from cbinfer_tpu_torch import graph
    from cbinfer_tpu_torch.models.pose import pose_graph
    jn, jo = j_pose_graph(width=8)
    tn, to = pose_graph(width=8)
    stem = jn[0].name
    extra = None if form == "torch" else {stem: form}
    # tau 0.05 everywhere: at tau 0 a float32 rounding difference between
    # the two packages' matmuls flips a detect decision
    jnet = jgraph.convert_graph_flagship(
        jn, (NH, NW, 3), JCfg(tile=JTile(8, 8, 0.375), backend="jnp"),
        output=jo, extra_overrides=extra, thresholds=[NTAU] * 28)
    tnet = graph.convert_graph_flagship(
        tn, (NH, NW, 3), PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                        backend="torch", device="cpu"),
        output=to, extra_overrides=extra, thresholds=[NTAU] * 28)
    assert [getattr(n.spec, "backend", None) for n in tnet.nodes] == \
        [getattr(n.spec, "backend", None) for n in jnet.nodes]
    jparams = jgraph.init_graph_params(jn, (NH, NW, 3),
                                       jax.random.PRNGKey(2))
    tparams = checkpoint.graph_params_from_numpy(
        tn, {k: (np.asarray(w), None if b is None else np.asarray(b))
             for k, (w, b) in jparams.items()}, device="cpu")
    clip = SpriteVideo(SpriteVideoConfig(
        height=NH, width=NW, n_sprites=3, sprite_size=12, speed=2.0,
        distinct_classes=True, seed=4)).clip(4)
    jys, _, jstats = jax.jit(lambda p, f: jrunner.scan_video(
        jnet, p, f, refresh_start=True))(jparams, jnp.asarray(clip))
    ys, _, stats = scan_video(tnet, tparams, torch.from_numpy(clip),
                              refresh_start=True)
    jstats = jax.device_get(jstats)
    assert sorted(stats) == sorted(jstats)  # a pytree sorts its keys
    for name in jstats:
        for k in jstats[name]:
            np.testing.assert_array_equal(
                _np(stats[name][k]).reshape(-1),
                np.asarray(jstats[name][k]).reshape(-1), err_msg=(name, k))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=1e-4)
