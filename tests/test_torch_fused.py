"""The two kernels of the pose slice on the CPU: the port's plain versions
of the hinted tile copy (``accept_tiles``) and of the fused delta conv +
consumer detect (``delta_conv_detect``) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs; the fuse gates against
the reference's on a table of geometries; and a channel width off the MMA's
16-channel grid through the delta conv and the fused kernel.

Tolerances: the tile copy is exact. The fused kernel's mask, changed-pixel
count and the SET of accepted pixels are exact; its conv output sums in
another order than the Pallas kernel's dot, so float32 values agree within
1e-5 relative (+1e-5 absolute) and bf16 caches within one bf16 ulp (2^-7
relative), and an accepted cache value is exactly the port's own out value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import layers as jlayers
from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.ops.compact import compact_mask as j_compact
from cbinfer_tpu.ops.geometry import conv_tile_geometry as j_geometry
from cbinfer_tpu.ops.pallas.accept import accept_tiles as j_accept_tiles
from cbinfer_tpu.ops.pallas.delta_conv_detect import \
    delta_conv_detect_pallas as j_fused
from cbinfer_tpu.ops.pallas.delta_conv_detect import fuse_gate as j_fuse_gate

from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, PoolSpec
from cbinfer_tpu_torch.ops.compact import compact_mask
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
from cbinfer_tpu_torch.ops.kernels.accept import (accept_tiles,
                                                   accept_tiles_plain)
from cbinfer_tpu_torch.ops.kernels.delta_conv import delta_conv
from cbinfer_tpu_torch.ops.kernels.delta_conv_detect import (
    delta_conv_detect, delta_conv_detect_plain, fuse_gate)
from cbinfer_tpu_torch.ops.kernels.detect_sparse import detect_sparse

TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDTYPE[dtype])


def _np(t):
    return t.float().numpy()


# ------------------------------- B9: tile copy -------------------------------


@pytest.mark.parametrize("H", [12, 16, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [(3, 3), (1, 1)])
def test_accept_tiles_matches_reference(H, dtype, kernel):
    """Clamped bottoms (H = 12: tiles at rows 0 and 4; H = 20: the last at
    row 12), a producer array padded past the logical map, a 3x3 consumer
    (storage offset by its margins) and a 1x1 consumer (no margins)."""
    rng = np.random.default_rng(H)
    W, C = 32, 16
    g = conv_tile_geometry((H, W, C), kernel, (1, 1), (1, 1), "SAME", 8, 8)
    jg = j_geometry((H, W, C), kernel, (1, 1), (1, 1), "SAME", 8, 8)
    x = rng.standard_normal((H + 4, W + 8, C)).astype(np.float32)
    st = rng.standard_normal(g.store_shape).astype(np.float32)
    hint = np.zeros((-(-H // 8), W // 8), bool)
    hint[0, 1] = hint[-1, 0] = hint[-1, 3] = True
    if hint.shape[0] > 2:
        hint[1, 2] = True
    jc = j_compact(jnp.asarray(hint), hint.size)
    want = j_accept_tiles(jnp.asarray(x, dtype), jnp.asarray(st, dtype),
                          jc.idx, jc.count, jg, interpret=True)
    tc = compact_mask(torch.from_numpy(hint), hint.size)
    st_t = _t(st, dtype)
    got = accept_tiles(_t(x, dtype), st_t, tc.idx, tc.count, g)
    assert got is st_t  # in place
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want.astype(jnp.float32)))
    # the copy really happened, and only inside the hinted tiles
    before = _np(_t(st, dtype))
    changed = (_np(got) != before).any(-1)
    assert changed.any()
    pix = np.zeros((H, W), bool)
    for hi, hj in zip(*np.nonzero(hint)):
        oy = min(hi * 8, H - 8)
        pix[oy:oy + 8, hj * 8:hj * 8 + 8] = True
    inner = changed[g.store_lo_h:g.store_lo_h + H,
                    g.store_lo_w:g.store_lo_w + W]
    assert not (inner & ~pix).any() and changed.sum() == inner.sum()


def test_accept_tiles_count_zero_and_checks():
    g = conv_tile_geometry((16, 16, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    st = torch.randn(g.store_shape)
    x = torch.randn(16, 16, 8)
    idx = torch.full((4,), 4, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32)
    reset_launches()
    assert torch.equal(accept_tiles(x, st.clone(), idx, zero, g), st)
    assert torch.equal(accept_tiles_plain(x, st.clone(), idx, zero, g), st)
    assert launches()["accept_tiles"] == 0  # CPU tensors launch nothing
    # a width off the 8-pixel grid: the partial last column is taken, and
    # nothing past the map is written
    gr = conv_tile_geometry((16, 20, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    xr, sr = torch.randn(16, 24, 8), torch.randn(gr.store_shape)
    assert torch.equal(accept_tiles(xr, sr.clone(), idx, zero, gr), sr)
    every = torch.arange(6, dtype=torch.int32)
    got = accept_tiles(xr, sr.clone(), every, torch.tensor(6), gr)
    want = sr.clone()
    want[gr.store_lo_h:gr.store_lo_h + 16, gr.store_lo_w:gr.store_lo_w + 20] \
        = xr[:, :20]
    assert torch.equal(got, want)


# --------------------------- B6: fused conv + detect -------------------------


def _fused_setup(k2, s2, dtype, cin=8, cout=16, H=32, W=48, seed=0,
                 k1=(3, 3)):
    rng = np.random.default_rng(seed)
    geo = lambda f: (f((H, W, cin), k1, (1, 1), (1, 1), "SAME", 8, 8))
    g, jg = geo(conv_tile_geometry), geo(j_geometry)
    geo2 = lambda f: f((g.out_h, g.out_w, cout), (k2, k2), s2, (1, 1),
                       "SAME", 8, 8)
    g2, jg2 = geo2(conv_tile_geometry), geo2(j_geometry)
    assert fuse_gate(g, g2) and j_fuse_gate(jg, jg2)
    xp = rng.standard_normal(g.store_shape).astype(np.float32)
    w = (rng.standard_normal(k1 + (cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((cout,)) * 0.1).astype(np.float32)
    out0 = rng.standard_normal((g.out_h_pad, g.out_w_pad, cout)).astype(
        np.float32)
    nc0 = (rng.standard_normal(g2.store_shape) * 0.05).astype(np.float32)
    ylo, xlo = g2.store_lo_h, g2.store_lo_w
    nc0[ylo:ylo + g.out_h, xlo:xlo + g.out_w] += out0[:g.out_h, :g.out_w]
    mask = np.zeros((g.tiles_h, g.tiles_w), bool)
    mask.flat[[0, 3, g.n_tiles - 1, g.n_tiles // 2, 7]] = True
    # round through the cache dtype once, so both packages start equal
    rd = lambda a: _np(_t(a, dtype))
    return dict(g=g, g2=g2, jg=jg, jg2=jg2, xp=rd(xp), w=w, b=b,
                out0=rd(out0), nc0=rd(nc0), mask=mask, dtype=dtype)


def _run_both(s, tau2, mask=None, fn=delta_conv_detect):
    mask = s["mask"] if mask is None else mask
    dtype = s["dtype"]
    jc = j_compact(jnp.asarray(mask), mask.size)
    jout, jnc, jmask, jnpix = j_fused(
        jnp.asarray(s["xp"], dtype), jc.idx, jnp.asarray(s["w"]),
        jnp.asarray(s["b"]), jnp.asarray(s["out0"], dtype), s["jg"], "relu",
        jnp.float32, jnp.asarray(s["nc0"], dtype), tau2, s["jg2"],
        count=jc.count, interpret=True)
    tc = compact_mask(torch.from_numpy(mask), mask.size)
    out, nc = _t(s["out0"], dtype), _t(s["nc0"], dtype)
    res = fn(_t(s["xp"], dtype), tc.idx, _t(s["w"]), _t(s["b"]), out,
             s["g"], "relu", torch.float32, nc, tau2, s["g2"],
             count=tc.count)
    assert res[0] is out and res[1] is nc  # both caches in place
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return (f32(jout), f32(jnc), np.asarray(jmask), np.asarray(jnpix)), \
        (_np(out), _np(nc), res[2].numpy(), res[3].numpy())


def _assert_fused_parity(s, ref, got):
    (jout, jnc, jmask, jnpix), (out, nc, mask, npix) = ref, got
    g, g2 = s["g"], s["g2"]
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(npix, jnpix)
    assert mask.dtype == np.float32 and mask.shape == (g2.tiles_h, g2.tiles_w)
    rtol = 1e-5 if s["dtype"] == "float32" else 2.0 ** -7
    np.testing.assert_allclose(out, jout, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(nc, jnc, rtol=rtol, atol=1e-5)
    # the same pixels were accepted, to the port's own out values
    acc = (nc != s["nc0"]).any(-1)
    np.testing.assert_array_equal(acc, (jnc != s["nc0"]).any(-1))
    ylo, xlo = g2.store_lo_h, g2.store_lo_w
    inner = acc[ylo:ylo + g.out_h, xlo:xlo + g.out_w]
    assert inner.sum() == acc.sum()  # margins and slack rows untouched
    np.testing.assert_array_equal(
        nc[ylo:ylo + g.out_h, xlo:xlo + g.out_w][inner],
        out[:g.out_h, :g.out_w][inner])
    # tiles not listed keep their bits
    keep = ~np.repeat(np.repeat(s["mask"], 8, 0), 8, 1)
    np.testing.assert_array_equal(out[keep], s["out0"][keep])


@pytest.mark.parametrize("k2,s2", [(3, (1, 1)), (1, (1, 1)), (3, (2, 2)),
                                   (7, (1, 1))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau2", [0.05, -1.0, 1e9])
def test_fused_matches_reference_kernel(k2, s2, dtype, tau2):
    s = _fused_setup(k2, s2, dtype)
    ref, got = _run_both(s, tau2)
    _assert_fused_parity(s, ref, got)
    n_listed = int(s["mask"].sum())
    if tau2 < 0:
        assert int(got[3][0]) == n_listed * 64
    if tau2 > 1:
        assert int(got[3][0]) == 0 and not got[2].any()
        np.testing.assert_array_equal(got[1], s["nc0"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_is_delta_conv_then_detect_sparse(dtype):
    """The wrapper on CPU tensors IS the unfused pair, bit for bit."""
    s = _fused_setup(3, (1, 1), dtype)
    _, got = _run_both(s, 0.05)
    _, plain = _run_both(s, 0.05, fn=delta_conv_detect_plain)
    tc = compact_mask(torch.from_numpy(s["mask"]), s["mask"].size)
    out, nc = _t(s["out0"], dtype), _t(s["nc0"], dtype)
    delta_conv(_t(s["xp"], dtype), tc.idx, _t(s["w"]), _t(s["b"]), out,
               s["g"], "relu", torch.float32, count=tc.count)
    _, mask, npix = detect_sparse(out, nc, 0.05, tc.idx, tc.count, s["g2"])
    for a, b, c in zip(got, plain, (_np(out), _np(nc), mask.numpy(),
                                    npix.numpy())):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_fused_count_zero_is_noop():
    s = _fused_setup(3, (1, 1), "float32")
    ref, got = _run_both(s, 0.05, mask=np.zeros_like(s["mask"]))
    for r in (ref, got):
        np.testing.assert_array_equal(r[0], s["out0"])
        np.testing.assert_array_equal(r[1], s["nc0"])
        assert not r[2].any() and int(r[3][0]) == 0


@pytest.mark.parametrize("H", [30, 90])
@pytest.mark.parametrize("k2,s2", [(3, (1, 1)), (3, (2, 2)), (1, (1, 1))])
def test_fused_ragged_height_matches_reference(H, k2, s2):
    """A map whose height is no multiple of 8: the last tile row overhangs
    and its rows >= out_h are neither detected nor accepted. Every tile is
    listed, the overhanging row included."""
    s = _fused_setup(k2, s2, "float32", H=H)
    g = s["g"]
    assert g.out_h % 8 != 0
    every = np.ones((g.tiles_h, g.tiles_w), bool)
    s["mask"] = every
    ref, got = _run_both(s, 0.05)
    _assert_fused_parity(s, ref, got)
    assert 0 < int(got[3][0]) <= g.out_h * g.out_w
    ref, got = _run_both(s, -1.0)
    _assert_fused_parity(s, ref, got)
    assert int(got[3][0]) == g.out_h * g.out_w  # pad rows never counted


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k1", [(3, 3), (1, 1)])
def test_odd_channel_widths_through_conv_and_fused(dtype, k1):
    """cin = 24 (a multiple of 8 off the 16-channel MMA step, as the pose
    net's 56) and cout = 24 through the fused kernel and, with the same
    inputs, through the plain delta conv."""
    s = _fused_setup(3, (1, 1), dtype, cin=24, cout=24, k1=k1, seed=5)
    ref, got = _run_both(s, 0.05)
    _assert_fused_parity(s, ref, got)
    tc = compact_mask(torch.from_numpy(s["mask"]), s["mask"].size)
    out = delta_conv(_t(s["xp"], dtype), tc.idx, _t(s["w"]), _t(s["b"]),
                     _t(s["out0"], dtype), s["g"], "relu", torch.float32,
                     count=tc.count)
    np.testing.assert_array_equal(_np(out), got[0])


def test_fused_wrapper_refuses_a_failed_gate_and_wrong_widths():
    s = _fused_setup(3, (1, 1), "float32")
    gw = conv_tile_geometry((32, 44, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    args = lambda g, g2, nc: (
        _t(s["xp"]), torch.zeros(4, dtype=torch.int32), _t(s["w"]),
        _t(s["b"]), _t(s["out0"]), g, "relu", torch.float32, nc, 0.05, g2)
    zero = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="fuse gate"):
        delta_conv_detect(*args(gw, s["g2"], _t(s["nc0"])), count=zero)
    with pytest.raises(ValueError, match="channels"):
        delta_conv_detect(*args(s["g"], s["g2"], _t(s["nc0"])[..., :8]),
                          count=zero)


# --------------------------------- the gates ---------------------------------

GEOMETRIES = [
    # (in_shape, producer kernel, consumer kernel, consumer stride, tile)
    ((32, 48, 8), (3, 3), (3, 3), (1, 1), 8),
    ((30, 48, 8), (3, 3), (3, 3), (1, 1), 8),     # ragged height
    ((90, 160, 8), (3, 3), (1, 1), (1, 1), 8),    # the 720p pose level
    ((180, 320, 8), (1, 1), (3, 3), (2, 2), 8),
    ((32, 44, 8), (3, 3), (3, 3), (1, 1), 8),     # ragged width: refused
    ((32, 48, 8), (3, 3), (3, 3), (1, 1), 16),    # 16x16 tiles: refused
    ((4, 48, 8), (3, 3), (3, 3), (1, 1), 8),      # a 4-row map: 4x8 tiles
    ((32, 48, 8), (3, 3), (7, 7), (1, 1), 8),
]


@pytest.mark.parametrize("shape,k1,k2,s2,tile", GEOMETRIES)
def test_fuse_gate_matches_reference(shape, k1, k2, s2, tile):
    mk = lambda f: f(shape, k1, (1, 1), (1, 1), "SAME", tile, tile)
    g, jg = mk(conv_tile_geometry), mk(j_geometry)
    mk2 = lambda f, gg: f((gg.out_h, gg.out_w, 16), k2, s2, (1, 1), "SAME",
                          tile, tile)
    g2, jg2 = mk2(conv_tile_geometry, g), mk2(j_geometry, jg)
    assert fuse_gate(g, g2) == j_fuse_gate(jg, jg2, lane_ok=True)
    assert fuse_gate(g, None) is False
    other = conv_tile_geometry((16, 24, 16), k2, s2, (1, 1), "SAME", 8, 8)
    assert not fuse_gate(g, other)  # a consumer on another map


@pytest.mark.parametrize("shape,k1,k2,s2,tile", GEOMETRIES)
def test_fuse_next_gate_matches_reference(shape, k1, k2, s2, tile):
    from cbinfer_tpu.config import TileConfig as JTile
    from cbinfer_tpu_torch.config import TileConfig
    jcfg = JCfg(tile=JTile(tile, tile), backend="pallas", interpret=True)
    tcfg = PipelineConfig(tile=TileConfig(tile, tile), device="cpu")
    for mk, mod, cfg, pool, kern in (
            (JConv, jlayers, jcfg, JPool, "pallas"),
            (ConvSpec, tlayers, tcfg, PoolSpec, "cuda")):
        a, b = mk(features=16, kernel=k1), mk(features=16, kernel=k2,
                                              stride=s2)
        import dataclasses
        rows = [
            mod.fuse_next_gate(a, b, shape, cfg),
            mod.fuse_next_gate(a, dataclasses.replace(b, forward_hint=True),
                               shape, cfg),
            mod.fuse_next_gate(a, dataclasses.replace(b, use_cb=False),
                               shape, cfg),
            mod.fuse_next_gate(a, pool(), shape, cfg),
            mod.fuse_next_gate(dataclasses.replace(a, backend="dense_cached"),
                               b, shape, cfg),
            mod.fuse_next_gate(a, dataclasses.replace(b,
                                                      backend="dense_cached"),
                               shape, cfg),
            mod.fuse_next_gate(dataclasses.replace(a, backend=kern), b, shape,
                               cfg),
        ]
        if mk is JConv:
            want = rows
    assert rows == want and rows[1:6] == [False] * 5
