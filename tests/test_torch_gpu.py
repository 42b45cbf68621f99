"""The port's CUDA kernels against their plain versions on the card. CUDA
kernels have no interpret mode, so these tests need a GPU (and nvcc); they
skip without one. Run them on a machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import delta_conv as KC
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
from cbinfer_tpu_torch.ops.kernels import launches, pool_fused as KP
from cbinfer_tpu_torch.ops.kernels import reset_launches

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the tile-conv cases it checks on the card)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _ids(mask, dev):
    flat = np.asarray(mask).reshape(-1)
    ids = np.flatnonzero(flat).astype(np.int32)
    idx = np.full(flat.size, flat.size, np.int32)
    idx[:ids.size] = ids
    return (torch.from_numpy(idx).to(dev),
            torch.tensor(ids.size, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(0)
    H, W, C, cout = 20, 32, 16, 32  # H % 8 != 0: a clamped bottom edge
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    prev = torch.from_numpy(rng.standard_normal((H, W, C)).astype(
        np.float32)).to(cuda, dtype)
    x = prev + (torch.rand(H, W, 1, device=cuda) < 0.3).to(dtype)
    st = torch.zeros(g.store_shape, dtype=dtype, device=cuda)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = prev
    idx, count = _ids(np.ones((3, 4), bool), cuda)
    reset_launches()
    sk, mk, nk = KD.detect_sparse(x, st.clone(), 0.5, idx, count, g)
    sp, mp, np_ = KD.detect_sparse_plain(x, st.clone(), 0.5, idx, count, g)
    assert torch.equal(sk, sp) and torch.equal(mk, mp)
    assert torch.equal(nk, np_)

    w = torch.from_numpy((rng.standard_normal((3, 3, C, cout)) * 0.2).astype(
        np.float32)).to(cuda, dtype)
    b = torch.randn(cout, device=cuda)
    out0 = torch.randn(g.out_h_pad, g.out_w_pad, cout, device=cuda).to(dtype)
    tmask = np.zeros((g.tiles_h, g.tiles_w), bool)
    tmask.flat[[0, 5, g.n_tiles - 1]] = True
    tidx, tcount = _ids(tmask, cuda)
    ok = KC.delta_conv(sk, tidx, w, b, out0.clone(), g, "relu", dtype,
                       count=tcount)
    op = KC.delta_conv_plain(sk, tidx, w, b, out0.clone(), g, "relu", dtype,
                             count=tcount)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ok.float(), op.float(), rtol=tol, atol=tol)

    gp = conv_tile_geometry((32, 64, C), (2, 2), (2, 2), (1, 1), "VALID",
                            8, 8)
    xp = torch.randn(32, 64, C, device=cuda).to(dtype)
    outp = torch.randn(gp.out_h_pad, gp.out_w_pad, C, device=cuda).to(dtype)
    bm = np.zeros((4, 4), bool)
    bm[0, 1] = bm[3, 3] = True
    pidx, pcount = _ids(bm, cuda)
    yk, pk = KP.detect_pool_fused(xp, outp.clone(), pidx, pcount, gp)
    yp, pp = KP.detect_pool_fused_plain(xp, outp.clone(), pidx, pcount, gp)
    assert torch.equal(yk, yp) and torch.equal(pk, pp)
    got = launches()
    assert {k: got[k] for k in ("detect_sparse", "delta_conv",
                                "detect_pool_fused")} == {
        "detect_sparse": 1, "delta_conv": 1, "detect_pool_fused": 1}


def _ulps(a, b):
    """Largest distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        v = t.view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernels_match_plain_on_card(cuda, dtype):
    """B4 exact (cache, cell mask, npix; tau = -1 marks everything); B5
    float32 within 1e-5, bf16 within 1 bf16 ulp, untouched tiles kept,
    count = 0 a no-op, count > capacity computes every tile."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
    from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD
    rng = np.random.default_rng(1)
    H, W, C, cout = 32, 128, 3, 16
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 32)
    base = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
    x = base.copy()
    x[0, 0] += 0.5
    x[7, 8] += 0.5
    x[H - 1, W - 1] -= 0.5
    x[10:14, 40:70] += 0.3
    x[3, 5] = base[3, 5] + 0.0501
    st0 = make_storage(g, 0.0, 0.0, dtype, cuda)
    st0[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = \
        torch.from_numpy(base).to(cuda, dtype)
    xt = torch.from_numpy(x).to(cuda)
    reset_launches()
    for tau in (0.05, -1.0):
        sk, mk, nk = KSD.stem_detect(xt, st0.clone(), tau, g)
        sp, mp, np_ = KSD.stem_detect_plain(xt, st0.clone(), tau, g)
        assert torch.equal(sk, sp) and torch.equal(mk, mp)
        assert torch.equal(nk, np_)
    assert int(nk) == H * W and bool((mk == 1).all())

    w = torch.from_numpy((rng.standard_normal((3, 3, C, cout)) * 0.2).astype(
        np.float32)).to(cuda, dtype)
    b = torch.randn(cout, device=cuda)
    out0 = torch.randn(H, W, cout, device=cuda).to(dtype)
    tmask = np.zeros((g.tiles_h, g.tiles_w), bool)
    tmask.flat[[0, 6, g.n_tiles - 1]] = True
    tidx, tcount = _ids(tmask, cuda)
    for act in ("relu", None):
        ok = KSC.stem_conv(sk, tidx, tcount, w, b, out0.clone(), g, act,
                           dtype)
        op = KSC.stem_conv_plain(sk, tidx, tcount, w, b, out0.clone(), g,
                                 act, dtype)
        if dtype == torch.float32:
            torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        else:
            assert _ulps(ok, op) <= 1
        keep = torch.from_numpy(~tmask).to(cuda).repeat_interleave(
            8, 0).repeat_interleave(32, 1)
        assert torch.equal(ok[keep], out0[keep])
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    assert torch.equal(KSC.stem_conv(sk, tidx, zero, w, b, out0.clone(), g,
                                     "relu", dtype), out0)
    over = torch.tensor(5, dtype=torch.int32, device=cuda)
    ok = KSC.stem_conv(sk, tidx[:2].contiguous(), over, w, b, out0.clone(),
                       g, "relu", dtype, capacity=2)
    op = KSC.stem_conv_plain(sk, tidx[:2], over, w, b, out0.clone(), g,
                             "relu", dtype, capacity=2)
    full = KSC.stem_conv_plain(
        sk, torch.arange(g.n_tiles, dtype=torch.int32, device=cuda),
        torch.tensor(g.n_tiles, dtype=torch.int32, device=cuda), w, b,
        out0.clone(), g, "relu", dtype)
    assert torch.equal(op, full)
    if dtype == torch.float32:
        torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
    else:
        assert _ulps(ok, op) <= 1
    got = launches()
    assert (got["stem_detect"], got["stem_conv"]) == (2, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", ["conv", "pool"])
def test_hintless_kernels_match_plain_on_card(cuda, dtype, geom):
    """B7 and B8 exact against their plain versions, and B1 on a pool's
    geometry (stride 2, VALID, finite "-inf" margins)."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP
    from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
    rng = np.random.default_rng(2)
    H, W, C = 40, 72, 16
    if geom == "conv":
        g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME",
                               8, 8)
        margin = 0.0
    else:
        g = conv_tile_geometry((H, W, C), (2, 2), (2, 2), (1, 1), "VALID",
                               8, 8)
        margin = -3.0e38
    prev = torch.from_numpy(rng.standard_normal((H, W, C)).astype(
        np.float32)).to(cuda, dtype)
    st0 = make_storage(g, 0.0, margin, dtype, cuda)
    st0[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = prev
    # x is a padded producer cache: pad rows and columns must be ignored
    x = torch.randn(H + 8, W + 8, C, device=cuda).to(dtype)
    x[:H, :W] = prev + (torch.rand(H, W, 1, device=cuda) < 0.2).to(dtype)
    reset_launches()
    for tau in (0.5, -1.0):
        sk, mk, nk = KDF.detect_full(x, st0.clone(), tau, g)
        sp, mp, np_ = KDF.detect_full_plain(x, st0.clone(), tau, g)
        assert torch.equal(sk, sp) and torch.equal(mk, mp)
        assert torch.equal(nk, np_)
    assert int(nk) == H * W
    idx, count = _ids(np.ones((H // 8, W // 8), bool), cuda)
    s1, m1, n1 = KD.detect_sparse(x, st0.clone(), 0.5, idx, count, g)
    s2, m2, n2 = KD.detect_sparse_plain(x, st0.clone(), 0.5, idx, count, g)
    assert torch.equal(s1, s2) and torch.equal(m1, m2) and torch.equal(n1, n2)
    got = launches()
    assert (got["detect_full"], got["detect_sparse"]) == (2, 1)
    if geom == "pool":
        out0 = torch.randn(g.out_h_pad, g.out_w_pad, C, device=cuda).to(dtype)
        tmask = np.zeros((g.tiles_h, g.tiles_w), bool)
        tmask.flat[[0, 3, g.n_tiles - 1]] = True
        for m in (tmask, np.ones_like(tmask), np.zeros_like(tmask)):
            tidx, tcount = _ids(m, cuda)
            yk = KDP.delta_pool(sk, tidx, out0.clone(), g, count=tcount)
            yp = KDP.delta_pool_plain(sk, tidx, out0.clone(), g,
                                      count=tcount)
            assert torch.equal(yk, yp)
        assert torch.equal(yk, out0)  # count = 0 is a no-op
        assert launches()["delta_pool"] == 3


@pytest.mark.parametrize("geom", ["conv", "pool"])
def test_detect_full_clips_a_map_off_the_8_pixel_grid(cuda, geom):
    """B7 on a map whose rows and columns are no multiple of 8 (the JAX
    package leaves such a layer to XLA; the CUDA kernel clips at the
    edge): exact against the plain version."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
    H, W, C = 36, 44, 16
    if geom == "conv":
        g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME",
                               8, 8)
        margin = 0.0
    else:
        g = conv_tile_geometry((H, W, C), (2, 2), (2, 2), (1, 1), "VALID",
                               8, 8)
        margin = -3.0e38
    st0 = make_storage(g, 0.0, margin, torch.bfloat16, cuda)
    x = (torch.rand(H, W, 1, device=cuda) < 0.1).to(torch.bfloat16) \
        .expand(H, W, C).contiguous()
    x[H - 1, W - 1] = 1.0
    reset_launches()
    sk, mk, nk = KDF.detect_full(x, st0.clone(), 0.5, g)
    sp, mp, np_ = KDF.detect_full_plain(x, st0.clone(), 0.5, g)
    assert torch.equal(sk, sp) and torch.equal(mk, mp)
    assert torch.equal(nk, np_) and mk[-1, -1] == 1
    assert launches()["detect_full"] == 1


def test_wrappers_refuse_mixed_devices(cuda):
    g = conv_tile_geometry((16, 16, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    st = torch.zeros(g.store_shape, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        KD.detect_sparse(torch.zeros(16, 16, 8, device=cuda), st, 0.1, idx,
                         torch.zeros((), dtype=torch.int32), g)


@pytest.mark.parametrize("path", ["dense_stem", "flagship", "hintless"])
def test_frame_loop_never_syncs_with_host(cuda, path):
    """The CB frame loop (refresh and plain frames) enqueues work only: no
    .item(), no host-to-device copy of a Python value, no nonzero."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert, convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    specs = get_model("scene", width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8), compute_dtype="bfloat16",
                         cache_dtype="bfloat16")
    if path == "hintless":
        net = convert(specs, (64, 128, 3), cfg, thresholds=[0.05] * 7,
                      dense_layers=(0, 6))
    else:
        net = convert_flagship(
            specs, (64, 128, 3), cfg, thresholds=[0.05] * 6,
            extra_overrides={0: "dense_cached"} if path == "dense_stem"
            else None)
    params = init_params(specs, (64, 128, 3), dtype=torch.bfloat16)
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=64, width=128, seed=1)).clip(4)).to(cuda)
    state = net.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys, state, _ = scan_video(net, params, clip, state,
                                  collect_stats=False, refresh_start=True,
                                  out_map=lambda y: y.argmax(-1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ys.shape == (4, 16, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [12, 16, 20])
def test_accept_tiles_matches_plain_on_card(cuda, dtype, H):
    """B9 exact, clamped bottoms included; count = 0 a no-op; x and the
    storage must share their dtype."""
    from cbinfer_tpu_torch.ops.kernels import accept as KA
    W, C = 32, 24
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    x = torch.randn(H + 4, W + 8, C, device=cuda).to(dtype)
    st0 = torch.randn(g.store_shape, device=cuda).to(dtype)
    hint = np.zeros((-(-H // 8), W // 8), bool)
    hint[0, 1] = hint[-1, 0] = hint[-1, 3] = True
    reset_launches()
    for m in (hint, np.ones_like(hint), np.zeros_like(hint)):
        idx, count = _ids(m, cuda)
        sk = KA.accept_tiles(x, st0.clone(), idx, count, g)
        sp = KA.accept_tiles_plain(x, st0.clone(), idx, count, g)
        assert torch.equal(sk, sp)
    assert torch.equal(sk, st0)
    assert launches()["accept_tiles"] == 3
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="unsupported"):
        KA.accept_tiles(x.to(other), st0.clone(), idx, count, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,k1,k2,cin,cout", [
    (32, 3, 3, 16, 32), (30, 3, 1, 24, 24), (90, 1, 3, 32, 56),
    (20, 3, 3, 56, 264)])
def test_fused_conv_detect_matches_unfused_pair_on_card(cuda, dtype, H, k1,
                                                        k2, cin, cout):
    """B6 against B2 followed by B1 on the card: out cache, consumer cache,
    mask and npix bit for bit, for tau2 in {0.05, -1, 1e9}, a listed
    subset, every tile (the ragged bottom row included) and count = 0;
    against the plain version within the delta conv's tolerance."""
    from cbinfer_tpu_torch.ops.kernels import delta_conv_detect as KF
    rng = np.random.default_rng(H)
    W = 48
    g = conv_tile_geometry((H, W, cin), (k1, k1), (1, 1), (1, 1), "SAME",
                           8, 8)
    g2 = conv_tile_geometry((g.out_h, g.out_w, cout), (k2, k2), (1, 1),
                            (1, 1), "SAME", 8, 8)
    assert KF.fuse_gate(g, g2)
    xp = torch.from_numpy(rng.standard_normal(g.store_shape).astype(
        np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.standard_normal((k1, k1, cin, cout))
                          * 0.2).astype(np.float32)).to(cuda, dtype)
    b = torch.randn(cout, device=cuda)
    out0 = torch.randn(g.out_h_pad, g.out_w_pad, cout, device=cuda).to(dtype)
    nc0 = (torch.randn(g2.store_shape, device=cuda) * 0.05)
    nc0[g2.store_lo_h:g2.store_lo_h + g.out_h,
        g2.store_lo_w:g2.store_lo_w + g.out_w] += out0[:g.out_h].float()
    nc0 = nc0.to(dtype)
    some = np.zeros((g.tiles_h, g.tiles_w), bool)
    some.flat[[0, 3, g.n_tiles - 1, g.n_tiles // 2]] = True
    reset_launches()
    n = 0
    for m in (some, np.ones_like(some), np.zeros_like(some)):
        idx, count = _ids(m, cuda)
        for tau2 in (0.05, -1.0, 1e9):
            of, nf = out0.clone(), nc0.clone()
            _, _, mf, pf = KF.delta_conv_detect(xp, idx, w, b, of, g, "relu",
                                                dtype, nf, tau2, g2,
                                                count=count)
            ou, nu = out0.clone(), nc0.clone()
            KC.delta_conv(xp, idx, w, b, ou, g, "relu", dtype, count=count)
            _, mu, pu = KD.detect_sparse(ou, nu, tau2, idx, count, g2)
            n += 1
            assert torch.equal(of, ou) and torch.equal(nf, nu)
            assert torch.equal(mf, mu) and torch.equal(pf, pu)
            op, npl = out0.clone(), nc0.clone()
            KF.delta_conv_detect_plain(xp, idx, w, b, op, g, "relu", dtype,
                                       npl, tau2, g2, count=count)
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(of.float(), op.float(), rtol=tol,
                                       atol=tol)
            if tau2 < 0:
                assert int(pf) == int(m[:, :].sum()) * 64 - (
                    int(m[-1].sum()) * 8 * (g.out_h_pad - g.out_h))
            if not m.any():
                assert torch.equal(of, out0) and torch.equal(nf, nc0)
                assert not mf.any() and int(pf) == 0
    got = launches()
    assert (got["delta_conv_detect"], got["delta_conv"],
            got["detect_sparse"]) == (n, n, n)


@pytest.mark.parametrize("path", ["pose", "pose_fwd"])
def test_pose_frame_loop_never_syncs_with_host(cuda, path):
    """A small pose net (fused pairs; forward-hint convs on pose_fwd)
    through refresh and plain frames without a host sync, and equal to
    the same run on the CPU's plain versions in float32."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    specs = get_model("pose", width=8)
    extra = ({15: "forward_hint", 16: "forward_hint", 20: "forward_hint"}
             if path == "pose_fwd" else None)
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=64, width=128, seed=1, distinct_classes=True,
        **workload_video_kwargs("pose"))).clip(4))
    outs = {}
    for dev in ("cpu", "cuda"):
        cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device=dev)
        net = convert_flagship(specs, (64, 128, 3), cfg,
                               thresholds=[0.05] * 21, extra_overrides=extra,
                               fuse_detect=True)
        params = init_params(specs, (64, 128, 3), seed=2, device=dev)
        state = net.init_state()
        frames = clip.to(dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            reset_launches()
            ys, state, _ = scan_video(net, params, frames, state,
                                      collect_stats=False,
                                      refresh_start=True)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        outs[dev] = ys.cpu()
    got = launches()
    assert got["delta_conv_detect"] == 3 * (10 if extra else 13)
    assert got["accept_tiles"] == (9 if extra else 0)
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", sorted(chip_smoke.TILE_CONV_CASES))
def test_tile_conv_cases_on_card(cuda, case):
    """The bf16 tile conv (B2) within 2e-2 of its plain version at counts
    0, 1, a few and every tile, tiles not listed untouched; B6 equal bit
    for bit to B2 then B1 at tau2 0.05, -1 and 1e9: clusters of 1 to 8
    blocks, a ragged last slice, cin and cout off the 16-channel grid,
    dilation, stride, th*tw < 64, the 90- and 180-row maps."""
    chip_smoke.check_tile_conv(torch, np, case)


# (map height, forced grid): a grid of 3 makes every block walk many list
# entries; None keeps the card's own grid, on a map wide enough that the
# list outgrows it
WALK_SHAPES = [(90, 3), (180, 3), (180, None)]
WALK_WIDTHS = [6, 56, 128, 256, 512]  # 4-byte units, 7, 16, 32, 64 units


def _force_grid(monkeypatch, module, grid):
    if grid is not None:
        monkeypatch.setattr(module, "walk_grid",
                            lambda cap, sms, per_sm: min(cap, grid))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", WALK_WIDTHS)
@pytest.mark.parametrize("H,grid", WALK_SHAPES)
def test_detect_sparse_walks_the_list_on_card(cuda, monkeypatch, dtype, C,
                                              H, grid):
    """B1 bit for bit against its plain version (cache, mask, npix) at
    counts 0, 1 and every hint tile, on ragged maps (a clamped bottom hint
    row), at widths that take 4-byte units (C = 6), 16-byte units in one
    batch and in two (C = 512), with blocks walking several entries."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import sm_count
    rng = np.random.default_rng(C + H)
    W = 64 if grid else 256
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    n_hint = -(-H // 8) * (W // 8)
    if grid is None:  # the card's grid: fewer blocks than entries
        assert KD.walk_grid(n_hint, sm_count(cuda.index or 0),
                            KD.BLOCKS_PER_SM) < n_hint
    _force_grid(monkeypatch, KD, grid)
    prev = torch.from_numpy(rng.standard_normal((H, W, C)).astype(
        np.float32)).to(cuda, dtype)
    st0 = make_storage(g, 0.0, 0.0, dtype, cuda)
    st0[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = prev
    # x is a padded producer cache: pad rows and columns must be ignored
    x = torch.randn(H + 6, W + 8, C, device=cuda).to(dtype)
    bump = torch.rand(H, W, 1, device=cuda) < 0.3
    x[:H, :W] = prev + bump.to(dtype) * torch.where(
        torch.rand(H, W, C, device=cuda) < 0.5, 0.4, 0.6).to(dtype)
    order = torch.from_numpy(rng.permutation(n_hint).astype(np.int32)).to(
        cuda)
    reset_launches()
    for c in (0, 1, n_hint):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        sk, mk, nk = KD.detect_sparse(x, st0.clone(), 0.5, order, count, g)
        sp, mp, np_ = KD.detect_sparse_plain(x, st0.clone(), 0.5, order,
                                             count, g)
        assert torch.equal(sk, sp) and torch.equal(mk, mp)
        assert torch.equal(nk, np_)
        assert (int(nk) > 0) == (c > 0)
    assert torch.equal(KD.detect_sparse(x, st0.clone(), 0.5, order,
                                        torch.zeros_like(count), g)[0], st0)
    assert launches()["detect_sparse"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", WALK_WIDTHS)
@pytest.mark.parametrize("H,grid", [(40, 3), (176, 3), (176, None)])
def test_pool_fused_walks_the_list_on_card(cuda, monkeypatch, dtype, C, H,
                                           grid):
    """B3 bit for bit against its plain version (out cache, mask) at
    counts 0, 1 and every block, on maps whose pooled height is off the
    8-row tile grid (40 -> 20 rows), at widths that take 4-byte units,
    16-byte units and more items a thread than one batch holds, with
    blocks walking several entries."""
    from cbinfer_tpu_torch.ops.kernels import sm_count
    rng = np.random.default_rng(C + H)
    W = 64 if grid else 256
    g = conv_tile_geometry((H, W, C), (2, 2), (2, 2), (1, 1), "VALID", 8, 8)
    n_blocks = (H // 8) * (W // 16)
    if grid is None:
        assert KP.walk_grid(n_blocks, sm_count(cuda.index or 0),
                            KP.BLOCKS_PER_SM) < n_blocks
    _force_grid(monkeypatch, KP, grid)
    x = torch.from_numpy(rng.standard_normal((H + 8, W + 16, C)).astype(
        np.float32)).to(cuda, dtype)
    out0 = torch.randn(g.out_h_pad, g.out_w_pad, C, device=cuda).to(dtype)
    order = torch.from_numpy(rng.permutation(n_blocks).astype(np.int32)).to(
        cuda)
    reset_launches()
    for c in (0, 1, n_blocks):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        yk, mk = KP.detect_pool_fused(x, out0.clone(), order, count, g)
        yp, mp = KP.detect_pool_fused_plain(x, out0.clone(), order, count, g)
        assert torch.equal(yk, yp) and torch.equal(mk, mp)
        assert torch.equal(yk, out0) == (c == 0)
    assert launches()["detect_pool_fused"] == 3


POOL_WALK_GEOMS = {"2x2s2": ((2, 2), (2, 2), "VALID"),
                   "3x3s2same": ((3, 3), (2, 2), "SAME")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [6, 128, 256])  # 4-byte and 16-byte units
@pytest.mark.parametrize("pool", sorted(POOL_WALK_GEOMS))
@pytest.mark.parametrize("H,W,grid", [(40, 72, 3), (256, 512, None)])
def test_delta_pool_walks_the_list_on_card(cuda, monkeypatch, dtype, C, pool,
                                           H, W, grid):
    """B8 bit for bit against its plain version at counts 0, 1 and every
    out tile, on the 2x2 stride-2 window of the paths (a template constant)
    and on a 3x3 stride-2 SAME pool (the runtime window), at widths that
    take 4-byte units (C = 6) and 16-byte units in one batch and in two,
    with a grid forced below the list (3 blocks) and the card's own grid
    below a 512-tile list. Tiles not listed are never written."""
    from cbinfer_tpu_torch.layers import NEG_FILL
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP
    from cbinfer_tpu_torch.ops.kernels import sm_count
    rng = np.random.default_rng(C + H)
    k, s, pad = POOL_WALK_GEOMS[pool]
    g = conv_tile_geometry((H, W, C), k, s, (1, 1), pad, 8, 8)
    if grid is None:
        assert KDP.walk_grid(g.n_tiles, sm_count(cuda.index or 0),
                             KDP.BLOCKS_PER_SM) < g.n_tiles
    _force_grid(monkeypatch, KDP, grid)
    st = make_storage(g, 0.0, NEG_FILL, dtype, cuda)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = \
        torch.from_numpy(rng.standard_normal((H, W, C)).astype(
            np.float32)).to(cuda, dtype)
    out0 = torch.randn(g.out_h_pad, g.out_w_pad, C, device=cuda).to(dtype)
    order = torch.from_numpy(rng.permutation(g.n_tiles).astype(np.int32)).to(
        cuda)
    reset_launches()
    for c in (0, 1, g.n_tiles):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        yk = KDP.delta_pool(st, order, out0.clone(), g, count=count)
        yp = KDP.delta_pool_plain(st, order, out0.clone(), g, count=count)
        assert torch.equal(yk, yp)
        listed = torch.zeros(g.n_tiles, dtype=torch.bool, device=cuda)
        listed[order[:c].long()] = True
        keep = ~listed.view(g.tiles_h, 1, g.tiles_w, 1, 1).expand(
            g.tiles_h, 8, g.tiles_w, 8, C).reshape(yk.shape)
        assert torch.equal(yk[keep], out0[keep])
        assert torch.equal(yk, out0) == (c == 0)
    assert launches()["delta_pool"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [64, 128])
@pytest.mark.parametrize("H,W,grid", [(64, 256, 3), (720, 1280, None)])
def test_stem_conv_walks_the_list_on_card(cuda, monkeypatch, dtype, cout, H,
                                          W, grid):
    """B5 against its plain version at counts 0, 1 and the capacity
    (0.375 of the tiles), and on overflow at the capacity + 1, which
    computes every tile: float32 within 1e-5, bf16 within 1 ulp; tiles
    not listed bit-identical; count 0 a no-op. The grid is forced below
    the walk (3 blocks), or is the card's own, below the 720p walk."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import sm_count
    from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
    rng = np.random.default_rng(cout + H)
    g = conv_tile_geometry((H, W, 3), (3, 3), (1, 1), (1, 1), "SAME", 8, 32)
    cap = int(0.375 * g.n_tiles)
    walk = KSC.walk_blocks(g, cout)
    if grid is None:
        assert KSC.walk_grid(walk, sm_count(cuda.index or 0),
                             KSC.BLOCKS_PER_SM) < walk
    _force_grid(monkeypatch, KSC, grid)
    st = make_storage(g, 0.0, 0.0, dtype, cuda)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = \
        torch.from_numpy(rng.uniform(0, 1, (H, W, 3)).astype(
            np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, cout)) * 0.2).astype(
        np.float32)).to(cuda, dtype)
    b = torch.randn(cout, device=cuda)
    out0 = torch.randn(H, W, cout, device=cuda).to(dtype)
    idx = torch.from_numpy(np.sort(rng.permutation(g.n_tiles)[:cap]).astype(
        np.int32)).to(cuda)
    reset_launches()
    for c in (0, 1, cap, cap + 1):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        ok = KSC.stem_conv(st, idx, count, w, b, out0.clone(), g, "relu",
                           dtype, capacity=cap)
        op = KSC.stem_conv_plain(st, idx, count, w, b, out0.clone(), g,
                                 "relu", dtype, capacity=cap)
        if dtype == torch.float32:
            torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        else:
            assert _ulps(ok, op) <= 1
        listed = torch.zeros(g.n_tiles, dtype=torch.bool, device=cuda)
        listed[idx[:c].long() if c <= cap else slice(None)] = True
        keep = ~listed.view(g.tiles_h, 1, g.tiles_w, 1, 1).expand(
            g.tiles_h, 8, g.tiles_w, 32, cout).reshape(ok.shape)
        assert torch.equal(ok[keep], out0[keep])
        assert torch.equal(ok, out0) == (c == 0)
    assert launches()["stem_conv"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [6, 30, 96, 160, 256, 512])
@pytest.mark.parametrize("cin", [1, 2, 3])
def test_stem_conv_widths_on_card(cuda, monkeypatch, dtype, cout, cin):
    """B5 at every branch of its channel split against its plain version:
    one channel a lane (cout 6, 30), lanes rounded up to a power of two
    (30, 96), 2 and 4 chunks (160, 256, 512), and cin 1 to 3; at a list of
    half the tiles and on overflow, with the grid forced below the walk:
    float32 within 1e-5, bf16 within 1 ulp, tiles not listed
    bit-identical."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
    H, W = 32, 128
    rng = np.random.default_rng(cout * 4 + cin)
    g = conv_tile_geometry((H, W, cin), (3, 3), (1, 1), (1, 1), "SAME", 8, 32)
    cap = g.n_tiles // 2
    _force_grid(monkeypatch, KSC, 3)
    st = make_storage(g, 0.0, 0.0, dtype, cuda)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = \
        torch.from_numpy(rng.uniform(0, 1, (H, W, cin)).astype(
            np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.2)
                         .astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(
        cuda)
    out0 = torch.from_numpy(rng.standard_normal((H, W, cout)).astype(
        np.float32)).to(cuda, dtype)
    idx = torch.from_numpy(np.sort(rng.permutation(g.n_tiles)[:cap]).astype(
        np.int32)).to(cuda)
    for c in (cap, cap + 1):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        ok = KSC.stem_conv(st, idx, count, w, b, out0.clone(), g, "relu",
                           dtype, capacity=cap)
        op = KSC.stem_conv_plain(st, idx, count, w, b, out0.clone(), g,
                                 "relu", dtype, capacity=cap)
        if dtype == torch.float32:
            torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
        else:
            assert _ulps(ok, op) <= 1
        listed = torch.zeros(g.n_tiles, dtype=torch.bool, device=cuda)
        listed[idx[:c].long() if c <= cap else slice(None)] = True
        keep = ~listed.view(g.tiles_h, 1, g.tiles_w, 1, 1).expand(
            g.tiles_h, 8, g.tiles_w, 32, cout).reshape(ok.shape)
        assert torch.equal(ok[keep], out0[keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 24, 128, 256])
@pytest.mark.parametrize("unit", [16, 4])
@pytest.mark.parametrize("H,grid", [(90, 3), (96, 3), (90, None)])
def test_accept_tiles_walks_the_list_on_card(cuda, monkeypatch, dtype, C,
                                             unit, H, grid):
    """B9 bit for bit against its plain version at counts 0, 1, 30 and
    every hint tile, on 90-row maps (a clamped bottom hint row overlapping
    the row above) and 96-row ones, 160 and 640 pixels wide, at C 8 to 256 in 16-byte units and, on
    a producer cache whose pointer is 4 bytes off 16, in 4-byte units; with
    a grid forced below the list (3 blocks) and the card's own grid below
    every tile's pairs. Pixels not listed are never written."""
    from cbinfer_tpu_torch.ops.kernels import accept as KA
    from cbinfer_tpu_torch.ops.kernels import sm_count
    rng = np.random.default_rng(C + H)
    W = 160 if grid else 640  # 960 hint tiles: more than the card's grid
    g = conv_tile_geometry((H, W, C), (1, 1), (1, 1), (1, 1), "SAME", 8, 8)
    n_hint = -(-H // 8) * (W // 8)
    es = torch.tensor([], dtype=dtype).element_size()
    parts = KA.part_split(8 * C * es // unit)[0]
    if grid is None:
        assert KA.walk_grid(n_hint * parts, sm_count(cuda.index or 0),
                            KA.BLOCKS_PER_SM) < n_hint * parts
    _force_grid(monkeypatch, KA, grid)
    # x is the producer's padded out cache: pad rows and columns unread
    shape = (H + 6, W + 8, C)
    n = int(np.prod(shape))
    off = 0 if unit == 16 else 4 // es
    x = torch.empty(n + off, dtype=dtype, device=cuda)[off:].view(shape)
    x.copy_(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    assert (x.data_ptr() % 16 == 0) == (unit == 16)
    st0 = torch.from_numpy(rng.standard_normal(g.store_shape).astype(
        np.float32)).to(cuda, dtype)
    # the bottom row's tiles first: in the lists of counts 1 and 30
    first = [n_hint - 1, n_hint - 20]
    perm = rng.permutation(n_hint)
    order = torch.from_numpy(np.concatenate(
        [first, perm[~np.isin(perm, first)]]).astype(np.int32)).to(cuda)
    reset_launches()
    for c in (0, 1, 30, n_hint):
        count = torch.tensor(c, dtype=torch.int32, device=cuda)
        sk = KA.accept_tiles(x, st0.clone(), order, count, g)
        sp = KA.accept_tiles_plain(x, st0.clone(), order, count, g)
        assert torch.equal(sk, sp)
        assert torch.equal(sk, st0) == (c == 0)
    assert torch.equal(
        sk[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W],
        x[:H, :W])
    assert launches()["accept_tiles"] == 4


def _stem_storage(g, base, dtype, shift, dev):
    """The stem's padded storage holding ``base``, its pointer ``shift``
    elements past a 16-byte boundary."""
    from cbinfer_tpu_torch.ops.delta_conv import storage_interior
    n = int(np.prod(g.store_shape))
    st = torch.zeros(n + shift, dtype=dtype, device=dev)[shift:].view(
        g.store_shape)
    storage_interior(st, g).copy_(torch.from_numpy(base))
    return st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("H,W,shift", [(16, 72, 0), (24, 264, 0),
                                       (24, 264, 1), (720, 1280, 0),
                                       (720, 1280, 1)])
def test_stem_detect_shapes_on_card(cuda, dtype, C, H, W, shift):
    """B4 bit for bit against its plain version (cache, cell mask, npix) at
    tau 0.05, -1 (every pixel) and 1e9 (none), on 8-aligned maps whose
    width is no multiple of the block's 256 pixels, at C 1 to 4, float32
    and bf16 caches, 16-byte loads and, on a storage whose interior is off
    16 bytes, element loads; changed pixels on every cell border and
    corner, across block borders, at the map's edges, and a borderline
    pixel whose rounded input would compare otherwise."""
    from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD
    rng = np.random.default_rng(C * 1000 + H + W + shift)
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8,
                           32 if W % 32 == 0 else 8)
    base = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
    base = torch.from_numpy(base).to(dtype).float().numpy()  # cache-exact
    x = base.copy()
    for r in sorted({0, 7, 8, 15, H - 8, H - 1}):
        for c in sorted({0, 7, 8, 255, 256, W - 8, W - 1} & set(range(W))):
            x[r, c, (r + c) % C] += 0.5
    x[rng.uniform(size=(H, W)) < 0.01] -= 0.3
    x[3, 5] = base[3, 5] + 0.0501  # changed at 0.05, x unrounded
    st0 = _stem_storage(g, base, dtype, shift, cuda)
    xt = torch.from_numpy(x).to(cuda)
    es = st0.element_size()
    s_row = g.store_shape[1] * C * es
    origin = (g.store_lo_h * g.store_shape[1] + g.store_lo_w) * C * es
    assert KSD.vec16(xt.data_ptr(), st0.data_ptr(), s_row, origin) == (
        shift == 0)
    reset_launches()
    for tau in (0.05, -1.0, 1e9):
        sk, mk, nk = KSD.stem_detect(xt, st0.clone(), tau, g)
        sp, mp, np_ = KSD.stem_detect_plain(xt, st0.clone(), tau, g)
        assert torch.equal(sk, sp) and torch.equal(mk, mp)
        assert torch.equal(nk, np_)
        if tau < 0:
            assert int(nk) == H * W and bool((mk == 1).all())
        elif tau > 1:
            assert int(nk) == 0 and not mk.any() and torch.equal(sk, st0)
        else:
            assert 0 < int(nk) < H * W
    assert launches()["stem_detect"] == 3


# ------------------------- the runner's CUDA graphs --------------------------


def _graph_net(cuda, kind, path=None, device="cuda"):
    """A small net of the scene flagship (w16), the fused pose path, seg or
    the fused pose_graph (w8) at 64x128 on the card (or ``device``),
    float32, with a steady state and a clip."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.graph import (convert_graph_flagship,
                                         init_graph_params)
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.models.pose import pose_graph
    from cbinfer_tpu_torch.netview import NetView
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    h, w = 64, 128
    pose = kind.startswith("pose")
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device=device)
    if kind == "pose_graph":
        nodes, out = pose_graph(width=8)
        net = convert_graph_flagship(nodes, (h, w, 3), cfg, output=out,
                                     fuse_detect=True)
        params = init_graph_params(nodes, (h, w, 3), seed=3, device=device)
    else:
        specs = {"pose": lambda: get_model("pose", width=8),
                 "seg": lambda: get_model("seg", num_classes=8,
                                          width=8)[:-1],
                 "scene": lambda: get_model("scene", num_classes=8,
                                            width=16)}[kind]()
        net = chip_smoke.build_net(
            path or {"pose": "pose", "seg": "seg"}.get(kind, "flagship"),
            specs, (h, w, 3), cfg)
        params = init_params(specs, (h, w, 3), seed=3, device=device)
    taus = [0.05] * len(NetView.of(net).cb_rows())
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, seed=3,
        distinct_classes=pose)).clip(24)).to(cuda)
    state = scan_video(net, params, clip[:4].to(device), collect_stats=False,
                       thresholds=taus, refresh_start=True)[1]
    return net, params, taus, clip, state


def _chunks(clip, k=4):
    return [clip[i:i + k] for i in range(4, clip.shape[0], k)]


@pytest.mark.parametrize("kind", ["scene", "pose", "seg", "pose_graph"])
def test_graph_replay_equals_eager_loop(cuda, kind):
    """scan_video_jit's replays give the eager loop's outputs, stats and
    caches bit for bit, on refresh and steady chunks, and each graph's
    captured launches are the path's per-frame kernels times its steady
    frames."""
    from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
    net, params, taus, clip, state = _graph_net(cuda, kind)
    s_e, s_g = chip_smoke._clone_state(state), chip_smoke._clone_state(state)
    run = scan_video_jit(net)
    for ch, refresh in zip(_chunks(clip), (True, False, False, True, False)):
        eager = scan_video(net, params, ch, s_e, thresholds=taus,
                           refresh_start=refresh)
        graphed = run(params, ch, s_g, thresholds=taus,
                      refresh_start=refresh)
        chip_smoke._same_run(torch, eager, graphed, f"{kind} {refresh}")
    info = run.graphs.info()
    assert sorted(g["replays"] for g in info) == [1, 2]
    per_frame = chip_smoke.per_frame_launches(net)
    for g in info:
        steady = 4 - g["refresh_start"]
        assert g["launches"] == {k: v * steady for k, v in per_frame.items()
                                 if v}


@pytest.mark.parametrize("kind", ["seg", "pose_graph"])
def test_small_net_on_card_equals_cpu(cuda, kind):
    """seg and the fused pose_graph (its f32 stage-1 heads padded 38 -> 40
    and 18 -> 20) on the card against the same run of the CPU's plain
    versions: every counter exact, outputs within 1e-3, and the card ran
    every kernel of the path's steady frames."""
    from cbinfer_tpu_torch.runner import scan_video
    net, params, taus, clip, state = _graph_net(cuda, kind)
    cnet, cparams, _, _, cstate = _graph_net(cuda, kind, device="cpu")
    reset_launches()
    yg, _, sg = scan_video(net, params, clip[4:12], state, thresholds=taus)
    counts = launches()
    yc, _, sc = scan_video(cnet, cparams, clip[4:12].cpu(), cstate,
                           thresholds=taus)
    torch.testing.assert_close(yg.cpu(), yc, rtol=0, atol=1e-3)
    for (k, a), (_, b) in zip(chip_smoke._layers(sg),
                              chip_smoke._layers(sc)):
        for key in a:
            assert a[key].cpu().tolist() == b[key].tolist(), (k, key)
    per_frame = chip_smoke.per_frame_launches(net)
    assert {k: v for k, v in counts.items() if v} == {
        k: 8 * v for k, v in per_frame.items() if v}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [38, 18])
def test_padded_cout_tile_convs_on_card(cuda, dtype, cout):
    """pose_graph's stage-1 heads: B2 and B6 refuse a cout off their
    channel grid, and the layer's padding (zero weight columns and bias,
    a padded out cache, and for B6 a consumer cache of the padded width)
    gives the plain version's results at the logical width, the pad
    channels zero."""
    from cbinfer_tpu_torch import layers as L
    from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig
    from cbinfer_tpu_torch.ops.kernels import delta_conv_detect as KF
    dt = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = PipelineConfig(compute_dtype=dt, cache_dtype=dt)
    cpad = L.stored_features(ConvSpec(features=cout), cfg)
    assert cpad > cout and cpad % KC.channel_quantum(dtype) == 0
    rng = np.random.default_rng(cout)
    H, W, cin = 90, 64, 128
    g = conv_tile_geometry((H, W, cin), (1, 1), (1, 1), (1, 1), "SAME", 8, 8)

    def geo2(c):
        return conv_tile_geometry((H, W, c), (3, 3), (1, 1), (1, 1), "SAME",
                                  8, 8)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)
    xp = t(rng.standard_normal(g.store_shape))
    w = t(rng.standard_normal((1, 1, cin, cout)) * 0.1)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(
        cuda)
    wp, bp = L._padded_params(w, b, cpad)
    assert L._padded_params(w, b, cpad)[0] is wp  # made once
    out0 = t(rng.standard_normal((g.out_h_pad, g.out_w_pad, cout)))
    out0p = torch.zeros((g.out_h_pad, g.out_w_pad, cpad), dtype=dtype,
                        device=cuda)
    out0p[..., :cout] = out0
    g2, g2p = geo2(cout), geo2(cpad)
    nc0 = t(rng.standard_normal(g2.store_shape) * 0.05)
    nc0p = torch.zeros(g2p.store_shape, dtype=dtype, device=cuda)
    nc0p[..., :cout] = nc0
    idx, count = _ids(rng.uniform(size=(g.tiles_h, g.tiles_w)) < 0.4, cuda)
    with pytest.raises(ValueError, match="unsupported"):
        KC.delta_conv(xp, idx, w, b, out0.clone(), g, None, dtype,
                      count=count)
    with pytest.raises(ValueError, match="unsupported"):
        KF.delta_conv_detect(xp, idx, w, b, out0.clone(), g, "relu", dtype,
                             nc0.clone(), 0.05, g2, count=count)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    ok = KC.delta_conv(xp, idx, wp, bp, out0p.clone(), g, None, dtype,
                       count=count)
    op = KC.delta_conv_plain(xp, idx, w, b, out0.clone(), g, None, dtype,
                             count=count)
    torch.testing.assert_close(ok[..., :cout].float(), op.float(), rtol=tol,
                               atol=tol)
    assert not ok[..., cout:].any()
    for tau2 in (0.05, -1.0):
        of, nf = out0p.clone(), nc0p.clone()
        _, _, mf, pf = KF.delta_conv_detect(xp, idx, wp, bp, of, g, "relu",
                                            dtype, nf, tau2, g2p, count=count)
        opl, npl = out0.clone(), nc0.clone()
        _, _, mp, pp = KF.delta_conv_detect_plain(
            xp, idx, w, b, opl, g, "relu", dtype, npl, tau2, g2, count=count)
        torch.testing.assert_close(of[..., :cout].float(), opl.float(),
                                   rtol=tol, atol=tol)
        assert not of[..., cout:].any() and not nf[..., cout:].any()
        if dtype == torch.float32:
            # the plain detect on the kernel's own out tile: exact
            nd = nc0.clone()
            _, md, pd = KD.detect_sparse_plain(of[..., :cout].contiguous(),
                                               nd, tau2, idx, count, g2)
            assert torch.equal(nf[..., :cout], nd)
            assert torch.equal(mf, md) and torch.equal(pf, pd)
        if tau2 < 0:  # every listed tile's pixels: no rounding decides
            assert torch.equal(mf, mp) and torch.equal(pf, pp)


def test_graph_new_state_recaptures(cuda):
    """Another state object (other addresses) gets its own graph, and
    replays on it give what replays on the first gave."""
    from cbinfer_tpu_torch.runner import scan_video_jit
    net, params, taus, clip, state = _graph_net(cuda, "scene")
    run = scan_video_jit(net)
    a, b = chip_smoke._clone_state(state), chip_smoke._clone_state(state)
    outs = {}
    for name, st in (("a", a), ("b", b)):
        outs[name] = [run(params, ch, st, thresholds=taus)
                      for ch in _chunks(clip)[:3]]
    assert len(run.graphs.info()) == 2
    assert all(g["replays"] == 2 for g in run.graphs.info())
    for x, y in zip(outs["a"], outs["b"]):
        chip_smoke._same_run(torch, x, y, "state a vs state b")


def test_graph_stepper_reset_equals_fresh_stepper(cuda):
    """After reset() a stepper's replays give a fresh stepper's results:
    reset writes into the captured graphs' tensors."""
    from cbinfer_tpu_torch.runner import FrameStepper
    net, params, taus, clip, _ = _graph_net(cuda, "pose")
    used = FrameStepper(net, params, thresholds=taus, refresh_every=6,
                        collect_stats="packed")
    for f in clip[:9]:
        used(f)
    used.step_chunk(clip[9:13])
    used.reset()
    fresh = FrameStepper(net, params, thresholds=taus, refresh_every=6,
                         collect_stats="packed")
    for f in clip[:9]:
        (ya, sa), (yb, sb) = used(f), fresh(f)
        assert torch.equal(ya, yb) and torch.equal(sa, sb)
    (ya, sa), (yb, sb) = used.step_chunk(clip[9:13]), \
        fresh.step_chunk(clip[9:13])
    assert torch.equal(ya, yb)
    for x, y in zip(sa, sb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for x, y in zip(used.state, fresh.state):
        if x is not None:
            assert torch.equal(x.in_cache, y.in_cache)
            assert torch.equal(x.out_cache, y.out_cache)


def test_graph_thresholds_select_another_graph(cuda):
    """The kernels read tau from device memory, so other thresholds do not
    select another graph: one graph serves both vectors, each replay equal
    to the eager loop at its own thresholds."""
    from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
    net, params, taus, clip, state = _graph_net(cuda, "scene")
    run = scan_video_jit(net)
    s_e, s_g = chip_smoke._clone_state(state), chip_smoke._clone_state(state)
    for i, ch in enumerate(_chunks(clip)):
        t = taus if i % 2 == 0 else [0.2] * len(taus)
        eager = scan_video(net, params, ch, s_e, thresholds=t)
        graphed = run(params, ch, s_g, thresholds=t)
        chip_smoke._same_run(torch, eager, graphed, f"chunk {i}")
    info = run.graphs.info()
    assert len(info) == 1 and info[0]["replays"] == len(_chunks(clip)) - 1
    assert run.graphs.captures == 1


@pytest.mark.parametrize("kind,path", [("scene", None),
                                       ("scene", "hintless"),
                                       ("pose", None), ("pose_graph", None)])
def test_graph_replay_after_tau_change_equals_eager(cuda, kind, path):
    """One graph, three tau vectors (host floats and a device tensor), a
    change before every replay: outputs, stats and caches equal the eager
    loop's at the same taus (the paths of B4, B1, B7 and B6)."""
    from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
    net, params, taus, clip, state = _graph_net(cuda, kind, path)
    out = chip_smoke.runtime_taus(torch, kind, net, params, taus, state,
                                  _chunks(clip))
    assert out["captures"] == 1
    run = scan_video_jit(net)
    s_e = chip_smoke._clone_state(state)
    s_g = chip_smoke._clone_state(state)
    for i, ch in enumerate(_chunks(clip)):
        v = torch.tensor([t * (1 + i) for t in taus], device=cuda)
        eager = scan_video(net, params, ch, s_e, thresholds=v.tolist())
        graphed = run(params, ch, s_g, thresholds=v)
        chip_smoke._same_run(torch, eager, graphed, f"chunk {i}")
    assert run.graphs.captures == 1


def test_detect_kernels_take_device_taus_on_card(cuda):
    """B1 and B7 with tau as a 0-d view of a device vector equal them
    with the host float, on the card and against the plain versions."""
    rng = np.random.default_rng(4)
    H, W, C = 24, 32, 16
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
    prev = torch.from_numpy(rng.standard_normal((H, W, C)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    x = prev + (torch.rand(H, W, 1, device=cuda) * 0.4).to(torch.bfloat16)
    st = torch.zeros(g.store_shape, dtype=torch.bfloat16, device=cuda)
    st[g.store_lo_h:g.store_lo_h + H, g.store_lo_w:g.store_lo_w + W] = prev
    idx, count = _ids(np.ones((3, 4), bool), cuda)
    vec = torch.tensor([0.05, 0.2, -1.0], device=cuda)
    for i, tau in enumerate((0.05, 0.2, -1.0)):
        a = KD.detect_sparse(x, st.clone(), vec[i], idx, count, g)
        b = KD.detect_sparse(x, st.clone(), tau, idx, count, g)
        c = KD.detect_sparse_plain(x, st.clone(), tau, idx, count, g)
        assert all(torch.equal(p, q) and torch.equal(p, r)
                   for p, q, r in zip(a, b, c))
        a = KDF.detect_full(x, st.clone(), vec[i], g)
        b = KDF.detect_full_plain(x, st.clone(), tau, g)
        assert all(torch.equal(p, q) for p, q in zip(a, b))
    with pytest.raises(ValueError):  # tau on another device
        KDF.detect_full(x, st.clone(), torch.tensor(0.1), g)


@pytest.mark.parametrize("cx, cs", [(64, 64), (3, 8)], ids=["wide", "narrow"])
def test_detect_full_reads_tau_inside_a_graph_on_card(cuda, cx, cs):
    """B7 captured in a CUDA graph with tau a 0-d view of a device vector:
    each replay after a new tau is written into the vector equals the
    plain version at that tau, bit for bit (storage, mask, npix)."""
    from cbinfer_tpu_torch.ops.delta_conv import storage_interior
    from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
    H, W = 40, 72
    g = conv_tile_geometry((H, W, cs), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    gen = torch.Generator(device=cuda).manual_seed(5)
    prev = torch.randn(H, W, cx, device=cuda, generator=gen)
    x = (prev + torch.rand(H, W, 1, device=cuda, generator=gen) * 0.4).to(
        torch.bfloat16)
    st0 = torch.zeros(g.store_shape, dtype=torch.bfloat16, device=cuda)
    storage_interior(st0, g)[..., :cx] = prev.to(torch.bfloat16)
    st = st0.clone()
    taus = torch.tensor([0.05], device=cuda)
    KDF.detect_full(x, st, taus[0], g)  # built and launched once eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = KDF.detect_full(x, st, taus[0], g)
    counts = []
    for tau in (0.05, 0.2, -1.0, 0.3):
        st.copy_(st0)
        taus.fill_(tau)
        graph.replay()
        torch.cuda.synchronize()
        want = KDF.detect_full_plain(x, st0.clone(), tau, g)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), tau
        counts.append(int(out[2]))
    assert 0 < counts[3] < counts[1] < counts[0] < counts[2] == H * W


def test_tuner_sweep_replays_one_graph_on_card(cuda):
    """The tuner's runner: one graph for every tau vector of a clip shape,
    each replay equal to a fresh eager scan at its taus, under the sync
    check."""
    from cbinfer_tpu_torch import tuner
    from cbinfer_tpu_torch.runner import scan_video
    net, params, taus, clip, _ = _graph_net(cuda, "pose")
    run = tuner._make_runner(net, params, 4)
    frames = clip[:12]
    for k in (1.0, 0.5, 2.0, 1.0):
        v = np.asarray([t * k for t in taus], np.float32)
        ys, stats = run(frames, v)
        want = scan_video(net, params, frames, net.init_state(),
                          thresholds=v.tolist(), refresh_every=4)
        assert torch.equal(ys, want[0])
        for x, y in zip(stats, want[2]):
            assert all(torch.equal(torch.as_tensor(x[key]),
                                   torch.as_tensor(y[key])) for key in x)
    assert run.graphs.captures == 1
    assert [g["replays"] for g in run.graphs.info()] == [3]


@pytest.mark.parametrize("i", range(11))
def test_tma_window_cases_on_card(cuda, i):
    """Each probe case on the card: the card's verdict is the encoder
    rules' prediction; an accepted window equals the plain version bit for
    bit, a refused one raises and leaves the buffer untouched."""
    from cbinfer_tpu_torch.ops.kernels import tma_window as K
    mod = chip_smoke._load_script("torch_probe_dma_constraints")
    cases = [(n, (mod.R, mod.G, mod.L), w, True) for n, w in mod.WRITE_CASES] \
        + [(n, sh, w, False) for n, sh, w in mod.READ_CASES]
    name, shape, window, write = cases[i]
    rules = K.encode_refusal(shape, window)
    zero = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    src = mod.read_source(shape).to(cuda)
    if rules:
        buf = zero.clone()
        with pytest.raises(K.WindowRefused) as e:
            if write:
                K.window_write(buf, window)
            else:
                K.window_read(src, window)
        assert e.value.rules == rules and e.value.cu_result != 0
        assert torch.equal(buf, zero)
        return
    if write:
        got = K.window_write(zero.clone(), window)
        want = K.window_write_plain(zero.clone(), window)
    else:
        got = K.window_read(src, window)
        want = K.window_read_plain(src, window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


PROBE = chip_smoke._load_script("torch_probe_dma_constraints")


@pytest.mark.parametrize("case", PROBE.SWEEP,
                         ids=[c.name.split()[0] for c in PROBE.SWEEP])
def test_tma_window_sweep_on_card(cuda, case):
    """Each sweep window through P1 and P2 on the card (every rank, box
    rows of 1 to 32 16-byte vectors, a single row, the last element of
    every dimension, a 224 KiB box, one window per encoder rule): the
    card's verdict is the expected one and the rules' prediction; an
    accepted window equals the plain version and numpy's slices bit for
    bit, a refused one raises with the rules and leaves its buffer
    untouched."""
    got = PROBE.check_sweep_case(case, cuda)
    torch.cuda.synchronize()
    assert got["write"]["verdict_by"] == got["read"]["verdict_by"] == "card"
    assert PROBE.sweep_faults(case, got) == []


def test_graph_capture_with_host_sync_raises(cuda):
    """A frame function that reads a device value on the host cannot be
    captured: the call raises, nothing runs it eagerly instead."""
    from cbinfer_tpu_torch.runner import _Graphs
    graphs = _Graphs(1)
    frames = torch.ones(2, 8, 8, 3, device=cuda)

    def fn(fs):
        return fs * float(fs.sum())  # a host sync
    with pytest.raises(RuntimeError):
        graphs.run(("k",), fn, frames)
    assert graphs.info() == []
    with pytest.raises(RuntimeError):
        graphs.run(("k",), fn, frames)


@pytest.mark.parametrize("kind,path", [("pose", "pose_fwd"),
                                       ("pose_graph", None)])
def test_graph_kernel_nodes_match_per_frame_launches(cuda, monkeypatch,
                                                     tmp_path, kind, path):
    """The steady graph's dump (CUDAGraph debug mode) holds each of the
    path's kernels as often as the path's steady frames launch it: the
    replay runs them, not just the capture's counters."""
    import re
    from cbinfer_tpu_torch.ops.kernels import KERNELS
    from cbinfer_tpu_torch.runner import scan_video_jit

    class DebugGraph(torch.cuda.CUDAGraph):
        def __init__(self, keep_graph=False):
            super().__init__(True)  # keep the cudaGraph_t for the dump
            self.enable_debug_mode()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", DebugGraph)
    net, params, taus, clip, state = _graph_net(cuda, kind, path)
    run = scan_video_jit(net)
    for ch in _chunks(clip)[:2]:
        run(params, ch, state, thresholds=taus)
    (entry,) = run.graphs._graphs.values()
    dump = tmp_path / "graph.dot"
    entry.graph.debug_dump(str(dump))
    # a kernel function is <source stem>[_variant]_kernel (in an anonymous
    # namespace, so mangled names carry a length prefix); one node a line
    stems = {os.path.splitext(os.path.basename(k.source))[0]: k.name
             for k in KERNELS}
    pattern = re.compile("(?<![a-z_])(?:\\d+)?(" + "|".join(
        sorted(stems, key=len, reverse=True)) + ")(?:_[a-z0-9]+)*_kernel")
    nodes = {}
    for line in dump.read_text().splitlines():
        m = pattern.search(line)
        if m is not None:
            name = stems[m.group(1)]
            nodes[name] = nodes.get(name, 0) + 1
    per_frame = chip_smoke.per_frame_launches(net)
    assert nodes == {k: 4 * v for k, v in per_frame.items() if v}


# ---- the workflow of import, tune and command line on the card ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_workflow_device_metrics_equal_the_host_on_card(cuda, dtype):
    from cbinfer_tpu_torch import metrics as M
    g = torch.Generator(device=cuda).manual_seed(0)
    a = (torch.randn((4, 45, 80, 8), device=cuda, generator=g) * 2).round() \
        .to(dtype)  # few levels: argmax ties are common
    b = (torch.randn((4, 45, 80, 8), device=cuda, generator=g) * 2).round() \
        .to(dtype)
    lab = torch.randint(0, 8, (4, 45, 80), device=cuda, generator=g,
                        dtype=torch.uint8)
    assert abs(float(M.miou_device(a, b, 8)) - M.miou(a, b, 8)) <= 1e-6
    assert abs(float(M.miou_labels_device(a, lab, 8))
               - M.miou_labels(a, lab, 8)) <= 1e-6
    assert abs(float(M.pck_device(a, b)) - M.pck(a, b)) <= 1e-6
    kps = torch.rand((4, 8, 2), device=cuda, generator=g) * 160
    valid = torch.rand((4, 8), device=cuda, generator=g) > 0.3
    packed = torch.cat([kps, valid[..., None].float()], -1)
    got = M.pck_gt_device(a, packed, 4, num_keypoints=8)
    want = M.pck_gt(a, kps.cpu().numpy(), valid.cpu().numpy(), 4,
                    num_keypoints=8)
    assert got.device.type == "cuda" and abs(float(got) - want) <= 1e-6


def test_workflow_tune_on_card_selects_the_cpu_taus(cuda):
    """A small float32 tune through the kernels selects what the plain
    versions select on the CPU, each scan under the sync check."""
    import functools
    from cbinfer_tpu_torch import metrics as M
    from cbinfer_tpu_torch import tuner
    from cbinfer_tpu_torch.checkpoint import params_from_numpy
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    specs = get_model("scene_tiny", num_classes=5, width=16)
    rng = np.random.default_rng(1)
    params_np, c = [], 3
    for s in specs:
        if hasattr(s, "features"):
            kh, kw = s.kernel
            params_np.append((rng.standard_normal((kh, kw, c, s.features))
                              .astype(np.float32) * np.sqrt(2 / (kh * kw * c)),
                              np.zeros(s.features, np.float32)))
            c = s.features
        else:
            params_np.append(None)
    clips = np.stack([SpriteVideo(SpriteVideoConfig(
        height=64, width=128, n_sprites=2, sprite_size=12, speed=2.0,
        noise_std=0.01, seed=s)).clip(8) for s in (7, 11)])
    kw = dict(tau_grid=(0.05, 0.15, 0.4), budgets=(0.02, 0.1), budget=0.1,
              skip_frames=2, refresh_every=4, base_tau=0.01)
    res = {}
    for device in ("cpu", "cuda"):
        cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device=device)
        net = convert_flagship(specs, (64, 128, 3), cfg)
        params = params_from_numpy(specs, params_np, device=device)
        res[device] = tuner.tune(
            net, params, clips, functools.partial(M.miou, num_classes=5),
            device_metric_fn=functools.partial(M.miou_device,
                                               num_classes=5), **kw)
    assert res["cuda"].thresholds == res["cpu"].thresholds
    assert [p["thresholds"] for p in res["cuda"].pareto] == \
        [p["thresholds"] for p in res["cpu"].pareto]
    assert res["cuda"].flop_frac == res["cpu"].flop_frac


def test_workflow_cli_on_card(cuda, capsys):
    import json
    from cbinfer_tpu_torch import cli
    cli.main(["--model", "scene", "--width-mult", "16", "--height", "64",
              "--width", "128", "--frames", "8", "--live", "1", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert out["backend"] == "cuda" and out["flop_reduction"] > 1.0
    assert out["live_chunk"] == 1 and out["live_ms_per_frame"] > 0


# ------------------------------ many streams ---------------------------------


def _stream_net(dev):
    """The flagship scene net (w16, bf16) at 64x128 and its params."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    specs = get_model("scene", num_classes=8, width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375),
                         compute_dtype="bfloat16", cache_dtype="bfloat16")
    return (convert_flagship(specs, (64, 128, 3), cfg),
            init_params(specs, (64, 128, 3), 0, dev, torch.bfloat16))


def _stream_chunks(dev, streams=3, chunks=3, t=8):
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    clips = torch.from_numpy(np.stack([SpriteVideo(SpriteVideoConfig(
        height=64, width=128, n_sprites=2, sprite_size=12, noise_std=0.002,
        seed=40 + s)).clip(chunks * t) for s in range(streams)])).to(dev)
    return [clips[:, i * t:(i + 1) * t] for i in range(chunks)]


def test_multistream_runner_streams_equal_alone_on_card(cuda):
    """S = 3 streams through MultiStreamRunner on the card: each stream's
    outputs, stats (T, S) and caches bit-identical to that stream run
    alone through its own scan_video_jit, chunk by chunk (eager first
    calls, captures, replays), and step by step; a second run_clip of a
    captured kind recaptures nothing (the graphs stay, replays rise)."""
    from cbinfer_tpu_torch.parallel import MultiStreamRunner, make_stream_mesh
    from cbinfer_tpu_torch.runner import scan_video_jit
    net, params = _stream_net(cuda)
    chunks = _stream_chunks(cuda)
    runner = MultiStreamRunner(net, params, 3, mesh=make_stream_mesh(1))
    alone = [scan_video_jit(net) for _ in range(3)]
    states = [net.init_state() for _ in range(3)]
    for i, ch in enumerate(chunks):
        ys, st = runner.run_clip(ch, refresh_start=i == 0)
        for s in range(3):
            ya, _, sa = alone[s](params, ch[s], states[s],
                                 refresh_start=i == 0)
            chip_smoke._same_run(
                torch, (ys[s], runner.states[s],
                        chip_smoke._stream_stats(st, s, axis=1)),
                (ya, states[s], sa), f"stream {s}, chunk {i}")
    for k in range(2):
        f = chunks[0][:, k]
        ys, st = runner.step(f)
        for s in range(3):
            ya, _, sa = alone[s](params, f[s][None], states[s])
            chip_smoke._same_run(
                torch, (ys[s], runner.states[s],
                        chip_smoke._stream_stats(st, s)),
                (ya[0], states[s], chip_smoke._stream_stats(sa, 0)),
                f"stream {s}, step {k}")
    graphs = runner.graphs()
    assert [len(g) for g in graphs] == [3, 3, 3]
    replays = sum(g["replays"] for gs in graphs for g in gs)
    runner.run_clip(chunks[2])
    again = runner.graphs()
    assert [len(g) for g in again] == [3, 3, 3]
    assert sum(g["replays"] for gs in again for g in gs) == replays + 3


def test_side_stream_replays_equal_in_order_on_card(cuda):
    """Each stream's graphs (a pool per stream) replayed on a side CUDA
    stream of its own, joined by events: outputs, stats and caches equal
    the in-order replays from the same states, bit for bit."""
    from cbinfer_tpu_torch.parallel import replay_on_side_streams
    from cbinfer_tpu_torch.runner import scan_video_jit
    net, params = _stream_net(cuda)
    chunks = _stream_chunks(cuda)
    scans = [scan_video_jit(net) for _ in range(3)]
    states = [net.init_state() for _ in range(3)]
    for i in range(2):  # a refresh and a steady graph per stream
        for s in range(3):
            scans[s](params, chunks[i][s], states[s], refresh_start=i == 0)
    snap = [chip_smoke._clone_state(st) for st in states]
    ref = [scans[s](params, chunks[2][s], states[s]) for s in range(3)]
    ref_states = [chip_smoke._clone_state(st) for st in states]
    for st, sn in zip(states, snap):
        chip_smoke._restore(st, sn)
    side = [torch.cuda.Stream() for _ in range(3)]
    got = replay_on_side_streams(scans, params,
                                 [chunks[2][s] for s in range(3)], states,
                                 side)
    torch.cuda.synchronize()
    for s in range(3):
        chip_smoke._same_run(torch, (got[s][0], states[s], got[s][1]),
                             (ref[s][0], ref_states[s], ref[s][2]),
                             f"stream {s}: side vs in order")
        assert all(g["replays"] == 2 for g in scans[s].graphs.info()
                   if not g["refresh_start"])


def test_stream_mesh_refuses_more_gpus_than_the_machine_has(cuda):
    from cbinfer_tpu_torch.parallel import make_stream_mesh
    n = torch.cuda.device_count()
    assert make_stream_mesh() == [torch.device("cuda", i) for i in range(n)]
    with pytest.raises(ValueError, match="GPUs"):
        make_stream_mesh(n + 1)


def test_dryrun_multistream_on_card(cuda):
    from cbinfer_tpu_torch.parallel import dryrun_multistream
    n = torch.cuda.device_count()
    shapes = dryrun_multistream(n)
    assert shapes["kernel_path"][:2] == (n, 2)
    assert shapes["pose_graph"][:2] == (n, 2)


def test_train_segmentation_step_on_card_equals_cpu(cuda):
    """One train_segmentation step (scene chain w8 at 48x64) on the card
    against the same step on the CPU, from the same initial weights (the
    port's init_params seeds numpy). Tolerance of TF32 convolutions, so it
    holds whichever precision cuDNN runs (the port switches TF32 off):
    the step's loss within 2e-3 relative. Adam's first update is about
    lr * sign(g) whatever |g|, so the updated weights agree wherever the
    gradient's sign does: at least 99.9% of the entries within 1e-5 +
    1e-4 * |p|, every entry within 2 * lr."""
    from cbinfer_tpu_torch import train
    from cbinfer_tpu_torch.models import get_model
    specs = get_model("scene", num_classes=8, width=8)
    runs = {}
    for dev in ("cpu", "cuda"):
        losses = []
        params, acc = train.train_segmentation(
            specs, (48, 64, 3), 8, steps=1, batch=2, n_videos=2,
            device=dev, losses=losses)
        runs[dev] = (params, acc, float(losses[0]))
    (pc, ac, lc), (pg, ag, lg) = runs["cpu"], runs["cuda"]
    assert abs(lg - lc) <= 2e-3 * abs(lc)
    assert abs(ag - ac) <= 4 / (2 * 12 * 16)
    got = np.concatenate([t.cpu().numpy().ravel() for p in pg if p
                          for t in p])
    want = np.concatenate([t.numpy().ravel() for p in pc if p for t in p])
    assert pg[0][0].device.type == "cuda"
    assert pg[0][0].dtype == torch.float32
    close = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
    assert close.mean() >= 0.999, close.mean()
    assert np.abs(got - want).max() <= 2 * 3e-3


def _backend_form(cuda_dev, form, dtype, device="cuda"):
    """scene w8 at 64x128 on one of the new backends' forms (the bounded
    plain pipeline; a band or flat stem before the kernel pipeline), its
    params from one seed, and a clip."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    backend, extra = {"torch": ("torch", None),
                      "band_cached": ("cuda", {0: "band_cached"}),
                      "dense_cached_flat": ("cuda",
                                            {0: "dense_cached_flat"}),
                      "dense_cached": ("cuda", {0: "dense_cached"})}[form]
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    specs = get_model("scene", num_classes=8, width=8)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), backend=backend,
                         compute_dtype=name, cache_dtype=name, device=device)
    net = convert_flagship(specs, (64, 128, 3), cfg, thresholds=[0.05] * 6,
                           extra_overrides=extra)
    params = init_params(specs, (64, 128, 3), 3, device, dtype)
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=64, width=128, n_sprites=3, sprite_size=16, speed=3.0,
        seed=3)).clip(20)).to(device)
    return net, params, clip


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["torch", "band_cached",
                                  "dense_cached_flat"])
def test_new_backends_graph_replay_equals_eager_on_card(cuda, form, dtype):
    """The bounded plain backend and the band and flat stems capture into
    CUDA graphs (the frame loop reads nothing on the host; the capture
    raises on a sync) and replay the eager loop bit for bit, refresh and
    steady chunks; the bounded forms overflow on the cold frame."""
    from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
    net, params, clip = _backend_form(cuda, form, dtype)
    state = net.init_state()
    s_e, s_g = chip_smoke._clone_state(state), chip_smoke._clone_state(state)
    run = scan_video_jit(net)
    chunks = [clip[i:i + 4] for i in range(0, 20, 4)]
    for ch, refresh in zip(chunks, (True, False, False, True, False)):
        eager = scan_video(net, params, ch, s_e, refresh_start=refresh)
        graphed = run(params, ch, s_g, refresh_start=refresh)
        chip_smoke._same_run(torch, eager, graphed, f"{form} {refresh}")
    assert sorted(g["replays"] for g in run.graphs.info()) == [1, 2]
    if form != "dense_cached_flat":
        cold = scan_video(net, params, clip[:1], net.init_state())[2]
        assert any(bool(s["overflow"].any()) for s in cold if s)


@pytest.mark.parametrize("form", ["torch", "band_cached",
                                  "dense_cached_flat"])
def test_new_backends_on_card_equal_cpu(cuda, form):
    """float32 on the card against the CPU's run of the same form: every
    counter exact, outputs within 1e-3."""
    from cbinfer_tpu_torch.runner import scan_video
    net, params, clip = _backend_form(cuda, form, torch.float32)
    cnet, cparams, cclip = _backend_form(cuda, form, torch.float32, "cpu")
    yg, _, sg = scan_video(net, params, clip, refresh_start=True)
    yc, _, sc = scan_video(cnet, cparams, cclip, refresh_start=True)
    torch.testing.assert_close(yg.cpu(), yc, rtol=0, atol=1e-3)
    for (k, a), (_, b) in zip(chip_smoke._layers(sg),
                              chip_smoke._layers(sc)):
        for key in a:
            assert a[key].cpu().tolist() == b[key].tolist(), (k, key)


def test_band_stem_equals_dense_cached_within_bf16_ulps_on_card(cuda):
    """In bf16 the band path's float32 epilogue (one rounding of the
    float32 sum) and the dense_cached stem's bf16 matmul output differ by
    final-rounding ulps: the stem's out caches within 1 bf16 ulp, every
    counter of the stem equal."""
    from cbinfer_tpu_torch.runner import scan_video
    outs = {}
    for form in ("band_cached", "dense_cached"):
        net, params, clip = _backend_form(cuda, form, torch.bfloat16)
        st = net.init_state()
        _, st, stats = scan_video(net, params, clip[:6], st)
        outs[form] = (st[0].out_cache, stats[0])
    (a, sa), (b, sb) = outs["band_cached"], outs["dense_cached"]
    assert chip_smoke._ulps(torch, a, b) <= 1
    for key in ("changed_tiles", "changed_pixels", "detect_tiles"):
        assert sa[key].tolist() == sb[key].tolist(), key


def test_plain_converter_cin3_stem_equals_plain_on_card(cuda):
    """The plain converter's stem as a CB conv on the kernel path (the
    variants twin's ``stem=cb_banded``): the full-map detect (B7) reads the
    frame's 3 channels against an input cache of 4 (float32's channel
    grid), the delta conv (B2) takes that cache with zero weight rows; the
    card's run equals the CPU's plain versions: stats and argmax maps
    identical, outputs within 1e-3, the cache's zero channels zero."""
    from cbinfer_tpu_torch.checkpoint import params_from_numpy
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    specs = get_model("scene", num_classes=8, width=8)
    rng = np.random.default_rng(0)
    pn, c = [], 3
    for s in specs:
        if hasattr(s, "features"):
            kh, kw = s.kernel
            pn.append(((rng.standard_normal((kh, kw, c, s.features))
                        * (2.0 / (kh * kw * c)) ** 0.5).astype(np.float32),
                       np.zeros(s.features, np.float32)))
            c = s.features
        else:
            pn.append(None)
    clip = SpriteVideo(SpriteVideoConfig(height=64, width=128, n_sprites=2,
                                         sprite_size=12, noise_std=0.0,
                                         seed=3)).clip(4)
    runs = {}
    for dev in ("cpu", "cuda"):
        net = convert(specs, (64, 128, 3), PipelineConfig(
            tile=TileConfig(8, 8, 0.375), backend="cuda", device=dev))
        reset_launches()
        runs[dev] = scan_video(net, params_from_numpy(specs, pn, device=dev),
                               torch.from_numpy(clip).to(dev),
                               thresholds=[0.05] * 7, collect_stats=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert launches()["detect_full"] and launches()["delta_conv"]
    (yc, sc, tc), (yg, sg, tg) = runs["cpu"], runs["cuda"]
    assert sg[0].in_cache.shape[-1] == 4
    assert not sg[0].in_cache[..., 3:].any()
    assert torch.equal(yg.argmax(-1).cpu(), yc.argmax(-1))
    assert torch.allclose(yg.cpu(), yc, atol=1e-3)
    for a, b in zip(tc, tg):
        for key in a:
            assert torch.equal(torch.as_tensor(a[key]).cpu(),
                               torch.as_tensor(b[key]).cpu()), key


@pytest.mark.parametrize("case", sorted(chip_smoke.GEOMETRY_CASES))
def test_geometry_cases_on_card(cuda, case):
    """Ragged maps through B1 and B9, B7's wide forms (16- and 4-byte
    units, batches, ragged and narrow maps) and its narrow ones (3, 4 or 5
    channels of x on a cache of 8 or 4), a cin-3 input cache through B2
    and cells of 4 and 2 through B4, each against its plain version
    (chip_smoke.check_geometry_case)."""
    chip_smoke.check_geometry_case(torch, np, case)


# ---- the stage map: a replay's activities by the scopes that captured them


def test_stage_map_attributes_a_profiled_replay(cuda):
    """One replay of the w16 scene flagship's steady graph under the
    profiler: the runner's host spans in order (the thresholds and the
    frames copied in, the key, the replay, the copy out, all inside
    ``runner.call``); the activities of its graph launch (by correlation
    id) are as many as the map's nodes; the join attributes every
    activity of the call (the map's nodes, the runner's copies); the
    port's kernels, per scope, sum to the capture's launches; B2 runs
    under ``delta_kernel``, the radix sorts under ``compact``, B1 and B4
    under ``detect``."""
    import re
    from torch.profiler import ProfilerActivity, profile

    from cbbench import stages, trace
    from cbinfer_tpu_torch.ops.kernels import KERNELS
    from cbinfer_tpu_torch.runner import scan_video_jit, stage_maps
    net, params, taus, clip, state = _graph_net(cuda, "scene")
    run = scan_video_jit(net)
    chunks = _chunks(clip)
    for ch in chunks[:2]:  # the eager call and its capture, then a replay
        run(params, ch, state, thresholds=taus)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(params, chunks[2], state, thresholds=taus)
        torch.cuda.synchronize()
    (info,) = run.graphs.info()
    assert stage_maps()[-1]["nodes"] == info["nodes"]
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id() for e in events
              if e.name() == "cudaGraphLaunch"}
    on_card = [e for e in events if str(e.device_type()).endswith("CUDA")
               and not e.is_user_annotation()]
    assert len(launch) == 1
    assert sum(e.correlation_id() in launch for e in on_card) \
        == len(info["nodes"])
    acts, host = trace.device_activities(prof)
    spans = [h[0] for h in sorted(host, key=lambda h: h[1])
             if h[0].startswith("runner.")]
    assert spans == ["runner.call", "runner.copy_in", "runner.key",
                     "runner.copy_in", "runner.replay", "runner.copy_out"]
    j = stages.join(acts, host, [info])
    assert len(j.replays) == 1 and j.replays[0][2] == 0
    assert j.unattributed_s() == 0 and j.runner_s() > 0, [
        (a.name, w) for a, w in zip(j.acts, j.where) if w is None]
    # a kernel function is <source stem>[_variant]_kernel; a function
    # that is no template prints no return type, and its arguments may
    # name namespaced types, so the name is searched, not split
    stems = {os.path.splitext(os.path.basename(k.source))[0]: k.name
             for k in KERNELS}
    pattern = re.compile("(?<![A-Za-z0-9_])(" + "|".join(
        sorted(stems, key=len, reverse=True)) + ")(?:_[a-z0-9]+)*_kernel")

    def port_kernel(name):
        m = pattern.search(name)
        return stems[m.group(1)] if m else None

    by_scope, by_kernel = {}, {}
    for a, w in zip(j.acts, j.where):
        k = port_kernel(a.name)
        if "radixsort" in a.name.lower().replace("_", ""):
            assert stages.stage_of(w) == "compact", (a.name, w)
        if k is None:
            continue
        assert w != stages.RUNNER
        by_scope[(w, k)] = by_scope.get((w, k), 0) + 1
        by_kernel[k] = by_kernel.get(k, 0) + 1
    assert by_kernel == info["launches"], by_scope
    want = {"delta_conv": "delta_kernel", "detect_sparse": "detect",
            "stem_detect": "detect"}
    got = {(k, stages.stage_of(w)) for w, k in by_scope if k in want}
    assert got == set(want.items()), got
    assert any(stages.stage_of(w) == "compact" and "radixsort" in
               a.name.lower().replace("_", "")
               for a, w in zip(j.acts, j.where))
    print("stage map:", len(info["nodes"]), "nodes;",
          stages.top_pairs(j, 4))
