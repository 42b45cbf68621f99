"""The kernels of the hint-less ``convert`` path on the CPU, through their
plain versions, against the JAX package's Pallas kernels in interpret mode:
the full-map detect (B7) and the re-detecting pool's delta pool (B8), plus
the sparse detect (B1) on a pool geometry (stride 2, VALID, finite "-inf"
margins), where slice 1 ran it on 3x3 convs only. All three match exactly:
storage, mask, npix, out cache. The re-detecting pool layer built on them
is then run frame by frame against the reference layer. Inputs are made
with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import layers as jlayers
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPoolSpec
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.ops import delta_pool as jdp
from cbinfer_tpu.ops.geometry import conv_tile_geometry
from cbinfer_tpu.ops.pallas.delta_pool import delta_pool_pallas
from cbinfer_tpu.ops.pallas.detect import detect_full_pallas
from cbinfer_tpu.ops.pallas.detect import detect_sparse as j_detect_sparse

from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch.config import PipelineConfig, PoolSpec, TileConfig
from cbinfer_tpu_torch.ops import delta_pool as tdp
from cbinfer_tpu_torch.ops.geometry import \
    conv_tile_geometry as t_conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
from cbinfer_tpu_torch.ops.kernels.delta_pool import delta_pool
from cbinfer_tpu_torch.ops.kernels.detect_full import detect_full
from cbinfer_tpu_torch.ops.kernels.detect_sparse import detect_sparse

NEG_FILL = -3.0e38

GEOMETRIES = {
    "conv3x3": dict(kernel=(3, 3), stride=(1, 1), padding="SAME", margin=0.0),
    "pool2x2": dict(kernel=(2, 2), stride=(2, 2), padding="VALID",
                    margin=NEG_FILL),
    "pool3x3s2": dict(kernel=(3, 3), stride=(2, 2), padding="VALID",
                      margin=NEG_FILL),
    # SAME pooling: the network builds it since its dense pool pads as XLA
    "pool3x3s2same": dict(kernel=(3, 3), stride=(2, 2), padding="SAME",
                          margin=NEG_FILL),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _geoms(H, W, C, name):
    p = GEOMETRIES[name]
    args = ((H, W, C), p["kernel"], p["stride"], (1, 1), p["padding"], 8, 8)
    return conv_tile_geometry(*args), t_conv_tile_geometry(*args)


def _storage(g, interior, margin):
    st = np.full(g.store_shape, margin, np.float32)
    st[g.store_lo_h:g.store_lo_h + g.in_h,
       g.store_lo_w:g.store_lo_w + g.in_w] = interior
    return st


def _ids(mask):
    flat = np.asarray(mask).reshape(-1)
    ids = np.flatnonzero(flat).astype(np.int32)
    idx = np.full(flat.size, flat.size, np.int32)
    idx[:ids.size] = ids
    return idx, np.int32(ids.size)


# ------------------------------ B7 full detect -------------------------------


@pytest.mark.parametrize("tau", [0.5, -1.0])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_detect_full_plain_matches_pallas(name, tau):
    _detect_full_against_pallas(name, tau, 8)


@pytest.mark.parametrize("tau", [0.5, -1.0])
@pytest.mark.parametrize("name", ["conv3x3", "pool2x2"])
def test_detect_full_plain_matches_pallas_c128(name, tau):
    """The hintless path's width (its first pool's 128 channels)."""
    _detect_full_against_pallas(name, tau, 128)


def _detect_full_against_pallas(name, tau, C):
    H, W = 32, 48
    rng = np.random.default_rng(11)
    g, tg = _geoms(H, W, C, name)
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    x = prev.copy()
    x[5:11, 9:14] += 1.0           # a changed block
    x[0, 0] -= 0.8                 # corners and the last row
    x[H - 1, W - 1] += 0.8
    x[15, 16, 3] += 0.49           # just below tau: stays rejected
    x[16, 7, 2] += 0.51            # one channel is enough
    st = _storage(g, prev, GEOMETRIES[name]["margin"])
    jst, jmask, jnpix = detect_full_pallas(jnp.asarray(x), jnp.asarray(st),
                                           tau, g, interpret=True)
    reset_launches()
    tst, tmask, tnpix = detect_full(_t(x), _t(st), tau, tg)
    assert launches()["detect_full"] == 0  # CPU: plain version only
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tnpix.numpy(), np.asarray(jnpix))
    want = H * W if tau < 0 else int((np.abs(x - prev).max(-1) > tau).sum())
    assert int(tnpix[0]) == want > 0


@pytest.mark.parametrize("tau", [0.3, -1.0])
@pytest.mark.parametrize("name", ["conv3x3", "pool2x2"])
def test_detect_full_narrow_x_matches_pallas_on_zero_padded_x(name, tau):
    """A 3-channel x over an 8-channel storage (a "cuda" conv's stem cache
    at the tile convs' channel grid, zero past the frame's channels): the
    plain version equals the reference's kernel on x zero-padded to 8
    channels, which compares and accepts all 8: storage, mask and npix."""
    H, W, cx, C = 24, 40, 3, 8
    rng = np.random.default_rng(13)
    g, tg = _geoms(H, W, C, name)
    prev = np.zeros((H, W, C), np.float32)
    prev[..., :cx] = rng.standard_normal((H, W, cx))
    x = prev[..., :cx].copy()
    x[rng.random((H, W)) < 0.2] += 0.5
    x[2, 3, 1] += 0.31             # one channel is enough
    x[H - 1, W - 1] -= 0.9
    st = _storage(g, prev, GEOMETRIES[name]["margin"])
    xpad = np.zeros((H, W, C), np.float32)
    xpad[..., :cx] = x
    jst, jmask, jnpix = detect_full_pallas(jnp.asarray(xpad),
                                           jnp.asarray(st), tau, g,
                                           interpret=True)
    tst, tmask, tnpix = detect_full(_t(x), _t(st), tau, tg)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tnpix.numpy(), np.asarray(jnpix))
    assert 0 < int(tnpix[0]) <= H * W
    assert not tst.numpy()[g.store_lo_h:g.store_lo_h + H,
                           g.store_lo_w:g.store_lo_w + W, cx:].any()


def test_detect_full_reads_logical_region_of_padded_input():
    """x may be a producer's padded out cache: pad rows/cols are ignored."""
    H, W, C = 24, 40, 8
    rng = np.random.default_rng(12)
    g, tg = _geoms(H, W, C, "pool2x2")
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    xpad = rng.standard_normal((H + 8, W + 8, C)).astype(np.float32)
    xpad[:H, :W] = prev
    xpad[3, 4] += 1.0
    st = _storage(g, prev, NEG_FILL)
    jst, jmask, jnpix = detect_full_pallas(jnp.asarray(xpad), jnp.asarray(st),
                                           0.5, g, interpret=True)
    tst, tmask, tnpix = detect_full(_t(xpad), _t(st), 0.5, tg)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tnpix[0]) == int(jnpix[0]) == 1


# ------------------------------- B8 delta pool -------------------------------

POOL_TILES = {"partial": [1, -1], "all": "all", "count_zero": []}


@pytest.mark.parametrize("tiles", sorted(POOL_TILES))
@pytest.mark.parametrize("name", ["pool2x2", "pool3x3s2", "pool3x3s2same"])
def test_delta_pool_plain_matches_pallas(name, tiles):
    H, W, C = 36, 48, 8  # out rows 18 (2x2): the tile grid overhangs
    rng = np.random.default_rng(2)
    g, tg = _geoms(H, W, C, name)
    st = _storage(g, rng.standard_normal((H, W, C)).astype(np.float32),
                  NEG_FILL)
    out0 = rng.standard_normal((g.out_h_pad, g.out_w_pad, C)).astype(
        np.float32)
    mask = np.zeros((g.tiles_h, g.tiles_w), bool)
    if POOL_TILES[tiles] == "all":
        mask[:] = True
    else:
        mask.flat[POOL_TILES[tiles]] = True
    idx, count = _ids(mask)
    jout = delta_pool_pallas(jnp.asarray(st), jnp.asarray(idx),
                             jnp.asarray(out0), g, count=jnp.asarray(count),
                             interpret=True)
    reset_launches()
    tout = delta_pool(_t(st), _t(idx), _t(out0), tg, count=_t(count))
    assert launches()["delta_pool"] == 0  # CPU: plain version only
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    tiled = tout.numpy().reshape(g.tiles_h, g.th, g.tiles_w, g.tw, C)
    old = out0.reshape(g.tiles_h, g.th, g.tiles_w, g.tw, C)
    np.testing.assert_array_equal(tiled.transpose(0, 2, 1, 3, 4)[~mask],
                                  old.transpose(0, 2, 1, 3, 4)[~mask])
    if not mask.any():
        np.testing.assert_array_equal(tout.numpy(), out0)


def test_pool_tiles_and_delta_pool_jnp_match_jax():
    H, W, C = 32, 48, 4
    rng = np.random.default_rng(7)
    g, tg = _geoms(H, W, C, "pool2x2")
    st = _storage(g, rng.standard_normal((H, W, C)).astype(np.float32),
                  NEG_FILL)
    out0 = rng.standard_normal((g.out_h_pad, g.out_w_pad, C)).astype(
        np.float32)
    ids = np.array([0, 4, g.n_tiles - 1])
    windows = rng.standard_normal((3, g.win_h, g.win_w, C)).astype(np.float32)
    np.testing.assert_array_equal(
        tdp.pool_tiles(_t(windows), tg).numpy(),
        np.asarray(jdp.pool_tiles(jnp.asarray(windows), g)))
    want = jdp.delta_pool_jnp(jnp.asarray(st),
                              jnp.asarray(ids.astype(np.int32)),
                              jnp.asarray(out0), g)
    got = tdp.delta_pool_jnp(_t(st), _t(ids), _t(out0), tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------- B1 on a pool's geometry ---------------------------


@pytest.mark.parametrize("name,H", [("pool2x2", 32), ("pool2x2", 36),
                                    ("pool3x3s2", 32)])
def test_detect_sparse_on_pool_geometry_matches_pallas(name, H):
    W, C = 48, 8
    rng = np.random.default_rng(19)
    g, tg = _geoms(H, W, C, name)
    hh, hw = -(-H // 8), W // 8
    hint = np.zeros((hh, hw), bool)
    for hi, hj in [(0, 0), (1, 3), (2, 2), (hh - 1, hw - 1)]:
        hint[hi, hj] = True
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    # changes only in rows each hinted tile owns (the producer's invariant)
    own = np.repeat(np.repeat(hint, 8, 0), 8, 1)[:H, :W]
    bump = (rng.uniform(size=(H, W)) < 0.3) & own
    x = prev + bump[..., None] * rng.uniform(0.6, 1.5, (H, W, C)).astype(
        np.float32)
    idx, count = _ids(hint)
    st = _storage(g, prev, NEG_FILL)
    jst, jmask, jnpix = j_detect_sparse(
        jnp.asarray(x), jnp.asarray(st), 0.5, jnp.asarray(idx),
        jnp.asarray(count), g, interpret=True)
    tst, tmask, tnpix = detect_sparse(_t(x), _t(st), 0.5, _t(idx), _t(count),
                                      tg)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tnpix.numpy(), np.asarray(jnpix))
    assert int(tnpix[0]) == int(bump.sum()) > 0
    assert tmask.shape == (g.tiles_h, g.tiles_w)


# ----------------------- the re-detecting pool layer -------------------------


@pytest.mark.parametrize("H,W", [(32, 48),    # 8-aligned: the Pallas kernel
                                 (36, 44)])   # the reference detects with XLA
def test_hintless_pool_layer_matches_reference(H, W):
    """A pool with no producer hint, frame by frame against the reference
    layer: the same stats, out hint and caches, and the storage margins
    keep their finite "-inf" fill (the port accepts into the interior in
    place, where the reference rebuilds the margins every frame)."""
    C = 8
    rng = np.random.default_rng(23)
    jspec = JPoolSpec(window=(2, 2), stride=(2, 2), threshold=0.1)
    tspec = PoolSpec(window=(2, 2), stride=(2, 2), threshold=0.1)
    jcfg = JCfg(tile=JTile(8, 8), backend="pallas", interpret=True)
    tcfg = PipelineConfig(tile=TileConfig(8, 8), device="cpu")
    jst = jlayers.cb_layer_init(jspec, (H, W, C), jcfg)
    tst = tlayers.cb_layer_init(tspec, (H, W, C), tcfg)
    g = tlayers._geometry(tspec, (H, W, C), tcfg)
    base = rng.standard_normal((H, W, C)).astype(np.float32)
    for t in range(4):
        f = base.copy()
        f[3 * t:3 * t + 5, 6 * t:6 * t + 7] += 0.6
        f[H - 1, W - 1, 0] += 0.05 * t  # creeps past tau on the last frame
        jy, jst, jstats, jhint = jlayers.cb_pool_apply(
            jst, jnp.asarray(f), jspec, jcfg)
        ty, tst, tstats, thint = tlayers.cb_pool_apply(
            tst, _t(f), tspec, tcfg)
        for k in jstats:
            assert int(tstats[k]) == int(np.asarray(jstats[k])), (t, k)
        np.testing.assert_array_equal(thint.mask.numpy(),
                                      np.asarray(jhint.mask))
        np.testing.assert_array_equal(
            tst.out_cache.numpy(), np.asarray(jst.out_cache)[..., :C])
        np.testing.assert_array_equal(
            tst.in_cache.numpy(), np.asarray(jst.in_cache)[..., :C])
        np.testing.assert_array_equal(ty.crop().numpy(),
                                      np.asarray(jy.crop()))
    margin = tst.in_cache.clone()
    tlayers.storage_interior(margin, g).fill_(NEG_FILL)
    assert bool((margin == np.float32(NEG_FILL)).all())
    assert 0 < int(tstats["computed_tiles"]) < int(tstats["n_tiles"])
