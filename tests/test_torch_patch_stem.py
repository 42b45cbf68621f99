"""The sparse small-cin stem of the port on the CPU, through its plain
versions, against the JAX package's Pallas kernels in interpret mode.

The stem detect (B4) must match exactly: accepted cache (carried across
between the reference's flat4 layout and the port's padded HWC storage),
8x8 cell mask and changed-pixel count. The stem conv (B5) sums float32 in
(dy, dx, c) order where the Pallas kernel's matmul sums in the matrix
unit's order: float32 within atol 1e-5; bf16 at most 1 bf16 ulp apart
(observed: no output differs at these sizes, and the test allows 1% to);
untouched tiles bit-identical. Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import layers as jlayers
from cbinfer_tpu.config import ConvSpec as JConvSpec
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.ops import flat4 as jflat4
from cbinfer_tpu.ops.pallas.flat4_detect import detect_accept_flat4_pallas
from cbinfer_tpu.ops.pallas.patch_stem import patch_stem_conv

from _torch_carry import storage_from_flat4, storage_to_flat4
from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, TileConfig
from cbinfer_tpu_torch.ops import flat4
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
from cbinfer_tpu_torch.ops.kernels.stem_conv import stem_conv
from cbinfer_tpu_torch.ops.kernels.stem_detect import stem_detect

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _stem_g(H, W, C):
    return conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME",
                              flat4.TILE_H, flat4.TILE_W)


def _storage_t(f4, fg, g, dtype):
    """Reference flat4 cache -> the port's storage tensor."""
    return torch.from_numpy(storage_from_flat4(_f32(f4), fg, g)).to(
        TORCH_DT[dtype])


def _ids(mask):
    flat = np.asarray(mask).reshape(-1)
    ids = np.flatnonzero(flat).astype(np.int32)
    idx = np.full(flat.size, flat.size, np.int32)
    idx[:ids.size] = ids
    return idx, np.int32(ids.size)


def _ordered(t):
    """bf16 values as integers whose difference counts bf16 ulps."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -(b & 0x7FFF), b)


# ------------------------------ B4 stem detect -------------------------------


@pytest.mark.parametrize("tau", [0.05, -1.0])
@pytest.mark.parametrize("shape", [(16, 32), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_detect_plain_matches_pallas(dtype, shape, tau):
    H, W = shape
    C = 3
    rng = np.random.default_rng(21)
    fg = jfg = jflat4.flat4_geom(H, W, C)
    g = _stem_g(H, W, C)
    base = rng.standard_normal((H, W, C)).astype(np.float32)
    base[3, 5] = 1.0  # exact in bf16
    x = base.copy()
    for _ in range(6):  # scattered changes, borders and corners included
        i, j = rng.integers(0, H), rng.integers(0, W)
        x[i, j] += rng.standard_normal(C).astype(np.float32) * 0.5
    x[0, 0] += 0.7
    x[H - 1, W - 1] -= 0.7
    x[7, 8] += 0.3   # last row of a cell, first column of the next
    # the unrounded compare: the float32 diff is above tau, the diff of the
    # bf16-rounded input (1.046875) is not
    x[3, 5] = 1.0501
    xr = torch.tensor(1.0501).to(torch.bfloat16).float().item()
    assert abs(1.0501 - 1.0) > 0.05 >= abs(xr - 1.0)

    cache4 = jflat4.to_flat4(jnp.asarray(base), jfg, JAX_DT[dtype])
    jnew, jmask, jnpix = detect_accept_flat4_pallas(
        jflat4.to_flat4(jnp.asarray(x), jfg, jnp.float32), cache4, tau, jfg,
        interpret=True)

    st = _storage_t(cache4, fg, g, dtype)
    reset_launches()
    st, mask, npix = stem_detect(torch.from_numpy(x), st, tau, g)
    assert launches()["stem_detect"] == 0  # CPU: plain version only
    np.testing.assert_array_equal(
        storage_to_flat4(st.float().numpy(), fg, g), _f32(jnew))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(npix.numpy(), np.asarray(jnpix))
    assert mask.dtype == torch.float32 and npix.dtype == torch.int32
    if tau < 0:
        assert int(npix[0]) == H * W and bool((mask == 1).all())
    else:
        got = tlayers.storage_interior(st, g)[3, 5].float()
        assert torch.equal(got, torch.full((3,), 1.0501).to(
            TORCH_DT[dtype]).float())
        assert mask[0, 0] == 1


def test_flat4_carry_across_round_trip():
    rng = np.random.default_rng(2)
    H, W, C = 16, 64, 2
    fg, g = jflat4.flat4_geom(H, W, C), _stem_g(H, W, C)
    x = rng.standard_normal((H, W, C)).astype(np.float32)
    f4 = _f32(jflat4.to_flat4(jnp.asarray(x), fg, jnp.float32))
    st = storage_from_flat4(f4, fg, g)
    assert st.shape == g.store_shape
    np.testing.assert_array_equal(
        st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W], x)
    assert np.abs(st).sum() == np.abs(x).sum()  # margins are zero
    np.testing.assert_array_equal(storage_to_flat4(st, fg, g), f4)


# ------------------------------- B5 stem conv --------------------------------

CONV_CASES = {
    "all_relu": dict(tiles="all", activation="relu"),
    "all_linear": dict(tiles="all", activation=None),
    "partial": dict(tiles=[0, 5, -1], activation="relu"),
    "count_zero": dict(tiles=[], activation="relu"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_stem_conv_plain_matches_pallas(case, dtype):
    p = CONV_CASES[case]
    H, W, C, cout = 32, 128, 3, 8
    rng = np.random.default_rng(4)
    fg = jfg = jflat4.flat4_geom(H, W, C)
    g = _stem_g(H, W, C)
    x = rng.standard_normal((H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    mask = np.zeros((g.tiles_h, g.tiles_w), bool)
    if p["tiles"] == "all":
        mask[:] = True
    else:
        mask.flat[p["tiles"]] = True
    idx, count = _ids(mask)
    jdt, tdt = JAX_DT[dtype], TORCH_DT[dtype]
    f4 = jflat4.to_flat4(jnp.asarray(x), jfg, jdt)
    old = rng.standard_normal((H, W, cout)).astype(np.float32)
    old_j = np.zeros((H, W, 128), np.float32)  # the reference pads lanes
    old_j[..., :cout] = old
    jout = patch_stem_conv(f4, jnp.asarray(idx), jnp.asarray(count),
                           jnp.asarray(w), jnp.asarray(b),
                           jnp.asarray(old_j).astype(jdt), jfg,
                           p["activation"], jdt, interpret=True)
    jout = torch.from_numpy(_f32(jout)[..., :cout]).to(tdt)

    out0 = torch.from_numpy(old).to(tdt)
    reset_launches()
    tout = stem_conv(_storage_t(f4, fg, g, dtype), torch.from_numpy(idx),
                     torch.tensor(count), torch.from_numpy(w).to(tdt),
                     torch.from_numpy(b), out0.clone(), g, p["activation"],
                     tdt)
    assert launches()["stem_conv"] == 0  # CPU: plain version only
    if dtype == "float32":
        np.testing.assert_allclose(tout.numpy(), jout.numpy(), atol=1e-5)
    else:
        ulps = (_ordered(tout) - _ordered(jout)).abs()
        assert int(ulps.max()) <= 1
        assert float((ulps > 0).float().mean()) <= 0.01
    # untouched tiles keep their bits
    keep = torch.from_numpy(~mask).repeat_interleave(8, 0).repeat_interleave(
        32, 1)
    assert torch.equal(tout[keep], out0[keep])
    if not mask.any():
        assert torch.equal(tout, out0)


def test_stem_conv_overflow_computes_every_tile():
    """count > capacity: the list is cut short and every tile is computed,
    as the reference's dense overflow branch does."""
    H, W, C, cout = 16, 64, 3, 4
    rng = np.random.default_rng(6)
    g = _stem_g(H, W, C)
    st = torch.zeros(g.store_shape)
    tlayers.storage_interior(st, g).copy_(torch.from_numpy(
        rng.standard_normal((H, W, C)).astype(np.float32)))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, cout)) * 0.2).astype(
        np.float32))
    full = stem_conv(st, torch.arange(4, dtype=torch.int32), torch.tensor(4),
                     w, None, torch.zeros(H, W, cout), g, "relu")
    cut = stem_conv(st, torch.tensor([0, 1], dtype=torch.int32),
                    torch.tensor(3), w, None, torch.full((H, W, cout), 7.0),
                    g, "relu", capacity=2)
    assert torch.equal(cut, full)


# --------------------------------- the layer ---------------------------------


def _layer_frames(rng, H, W):
    base = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    frames = []
    for t in range(6):
        f = base.copy()
        f[4:10, 8 * t:8 * t + 6] += 0.5          # a moving blob
        if t == 3:
            # most of the map, one frame: more stem tiles than the capacity
            # holds, yet not every cell (the right edge stays as it was)
            f[:, :W - 40] *= 0.5
        frames.append(f)
    return frames


@pytest.mark.parametrize("tile", [(8, 8), (16, 16), (16, 8)])
def test_patch_stem_layer_matches_reference(tile):
    """6 frames through cb_conv_apply on the patch_stem backend: the cold
    first frame overflows the capacity (every tile computed), as do the two
    frames where most of the map changes and changes back; the others go
    sparse. On a coarser configured grid the reference detects per pixel
    with XLA ops; the port derives that grid's mask from the cell mask."""
    H, W, cout = 32, 128, 8
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((3, 3, 3, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    frames = _layer_frames(rng, H, W)
    kw = dict(features=cout, kernel=(3, 3), padding="SAME",
              activation="relu", backend="patch_stem", threshold=0.05)
    jspec, tspec = JConvSpec(**kw), ConvSpec(**kw)
    jcfg = JCfg(tile=JTile(*tile, 0.375), backend="pallas", interpret=True)
    tcfg = PipelineConfig(tile=TileConfig(*tile, 0.375), device="cpu")
    jst = jlayers.cb_layer_init(jspec, (H, W, 3), jcfg)
    tst = tlayers.cb_layer_init(tspec, (H, W, 3), tcfg)
    tparams = (torch.from_numpy(w), torch.from_numpy(b))
    fg = jflat4.flat4_geom(H, W, 3)
    g = tlayers._geometry(tspec, (H, W, 3),
                          tlayers._layer_cfg(tspec, tcfg))
    assert (g.th, g.tw) == (8, 32)
    overflowed = []
    for t, f in enumerate(frames):
        jy, jst, jstats, jhint = jlayers.cb_conv_apply(
            (jnp.asarray(w), jnp.asarray(b)), jst, jnp.asarray(f), jspec,
            jcfg)
        ty, tst, tstats, thint = tlayers.cb_conv_apply(
            tparams, tst, torch.from_numpy(f), tspec, tcfg)
        assert set(tstats) == set(jstats)
        for k in jstats:
            assert int(tstats[k]) == int(np.asarray(jstats[k])), (t, k)
        overflowed.append(bool(tstats["overflow"]))
        np.testing.assert_array_equal(thint.mask.numpy(),
                                      np.asarray(jhint.mask))
        if t == 3:  # overflow dirties everything, changed or not
            assert int(tstats["changed_tiles"]) < int(tstats["n_tiles"])
            assert bool(thint.mask.all())
        np.testing.assert_array_equal(
            storage_to_flat4(tst.in_cache.numpy(), fg, g),
            np.asarray(jst.in_cache))
        np.testing.assert_allclose(ty.crop().numpy(),
                                   np.asarray(jy.crop()), atol=1e-5)
        assert (ty.h, ty.w, ty.c) == (jy.h, jy.w, jy.c)
    assert overflowed == [True, False, False, True, True, False]
    assert int(tstats["computed_tiles"]) < int(tstats["n_tiles"])

    jy, jst, jstats, jhint = jlayers.cb_conv_refresh(
        (jnp.asarray(w), jnp.asarray(b)), jst, jnp.asarray(frames[0]), jspec,
        jcfg)
    ty, tst, tstats, thint = tlayers.cb_conv_refresh(
        tparams, tst, torch.from_numpy(frames[0]), tspec, tcfg)
    for k in jstats:
        assert int(tstats[k]) == int(np.asarray(jstats[k])), k
    np.testing.assert_array_equal(thint.mask.numpy(), np.asarray(jhint.mask))
    np.testing.assert_array_equal(
        storage_to_flat4(tst.in_cache.numpy(), fg, g),
        np.asarray(jst.in_cache))
    np.testing.assert_allclose(ty.crop().numpy(), np.asarray(jy.crop()),
                               atol=1e-5)


def test_patch_stem_layer_rejects_unsupported_shapes():
    spec = ConvSpec(features=8, backend="patch_stem")
    cfg = PipelineConfig(device="cpu")
    st = tlayers.cb_layer_init(spec, (16, 40, 3), cfg)
    with pytest.raises(ValueError, match="patch_stem"):
        tlayers.cb_conv_apply((torch.zeros(3, 3, 3, 8), None), st,
                              torch.zeros(16, 40, 3), spec, cfg)


@pytest.mark.parametrize("h", [8, 12, 16])
@pytest.mark.parametrize("w", [32, 48, 64])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_flat4_supports_matches_reference(h, w, c):
    cases = [((3, 3), (1, 1), (1, 1), "SAME", "relu"),
             ((3, 3), (1, 1), (1, 1), "SAME", None),
             ((3, 3), (2, 2), (1, 1), "SAME", "relu"),
             ((3, 3), (1, 1), (2, 2), "SAME", "relu"),
             ((3, 3), (1, 1), (1, 1), "VALID", "relu"),
             ((5, 5), (1, 1), (1, 1), "SAME", "relu")]
    for k, s, d, pad, act in cases:
        assert flat4.supports((h, w, c), k, s, d, pad, act) \
            == jflat4.supports((h, w, c), k, s, d, pad, act)
    assert (flat4.TILE_H, flat4.TILE_W) == (jflat4.TILE_H, jflat4.TILE_W)
