"""The port's CUDA kernels against their plain versions on the card. CUDA
kernels have no interpret mode, so these tests need a GPU (and nvcc); they
skip without one. Run them on a machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import delta_conv as KC
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
from cbinfer_tpu_torch.ops.kernels import launches, pool_fused as KP
from cbinfer_tpu_torch.ops.kernels import reset_launches

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
    assert launches() == {"detect_sparse": 1, "delta_conv": 1,
                          "detect_pool_fused": 1}


def test_wrappers_refuse_mixed_devices(cuda):
    g = conv_tile_geometry((16, 16, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    st = torch.zeros(g.store_shape, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        KD.detect_sparse(torch.zeros(16, 16, 8, device=cuda), st, 0.1, idx,
                         torch.zeros((), dtype=torch.int32), g)


def test_frame_loop_never_syncs_with_host(cuda):
    """The CB frame loop (refresh and plain frames) enqueues work only: no
    .item(), no host-to-device copy of a Python value, no nonzero."""
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.network import init_params
    from cbinfer_tpu_torch.runner import scan_video
    from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig
    specs = get_model("scene", width=16)
    cfg = PipelineConfig(tile=TileConfig(8, 8), compute_dtype="bfloat16",
                         cache_dtype="bfloat16")
    net = convert_flagship(specs, (64, 128, 3), cfg, thresholds=[0.05] * 6,
                           extra_overrides={0: "dense_cached"})
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
