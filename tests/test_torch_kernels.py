"""The port's three kernels, on the CPU through their plain versions, held
against the JAX package's Pallas kernels in interpret mode, in float32.

Detect and pool must match exactly (storage interior, mask, npix, out
cache); the conv within atol 1e-5 (float32 sums in another order), with
untouched tiles bit-identical. Inputs are made with numpy from a seed and
handed to both packages. The glue around the kernels (compaction, full-map
detect, the dense shifted conv) is held against its JAX function too.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cbinfer_tpu.ops import compact as jcompact
from cbinfer_tpu.ops import delta_conv as jdc
from cbinfer_tpu.ops import detect as jdetect
from cbinfer_tpu.ops.geometry import conv_tile_geometry
from cbinfer_tpu.ops.pallas.delta_conv import delta_conv_pallas
from cbinfer_tpu.ops.pallas.delta_pool import detect_pool_fused as j_pool
from cbinfer_tpu.ops.pallas.detect import detect_sparse as j_detect

from cbinfer_tpu_torch.ops import compact as tcompact
from cbinfer_tpu_torch.ops import delta_conv as tdc
from cbinfer_tpu_torch.ops import detect as tdetect
from cbinfer_tpu_torch.ops.geometry import \
    conv_tile_geometry as t_conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches, walk_grid
from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
from cbinfer_tpu_torch.ops.kernels import pool_fused as KP
from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
from cbinfer_tpu_torch.ops.kernels.delta_conv import delta_conv
from cbinfer_tpu_torch.ops.kernels.detect_sparse import detect_sparse
from cbinfer_tpu_torch.ops.kernels.pool_fused import detect_pool_fused


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(mask):
    """Row-major compacted ids + count, sentinel-padded, as numpy."""
    flat = np.asarray(mask).reshape(-1)
    ids = np.flatnonzero(flat).astype(np.int32)
    idx = np.full(flat.size, flat.size, np.int32)
    idx[:ids.size] = ids
    return idx, np.int32(ids.size)


def _storage(g, interior, margin=0.0):
    st = np.full(g.store_shape, margin, np.float32)
    st[g.store_lo_h:g.store_lo_h + g.in_h,
       g.store_lo_w:g.store_lo_w + g.in_w] = interior
    return st


# ------------------------------- B1 detect ----------------------------------

DETECT_CASES = {
    # H % 8 != 0: the last hint row clamps to oy = H - 8 and overlaps the
    # row above; the row above is NOT hinted in this case
    "clamped_edge": dict(H=20, W=24, C=8, hint=[(2, 0), (2, 2), (0, 1)]),
    "clamped_all": dict(H=20, W=16, C=8, hint="all"),
    "count_zero": dict(H=20, W=16, C=8, hint=[]),
    "full_width": dict(H=16, W=32, C=128, hint=[(0, 0), (1, 3), (1, 2)]),
    # 112 bytes a bf16 pixel (16-byte units, no power of two of them), and
    # a clamped edge
    "c56_clamped": dict(H=20, W=24, C=56, hint=[(0, 0), (2, 1), (1, 2)]),
    # more units a pixel than one batch of the kernel holds
    "c512": dict(H=16, W=16, C=512, hint=[(0, 1), (1, 0)]),
    # the sparse detect in front of a re-detecting pool (the hintless path)
    "pool_stride2": dict(H=20, W=32, C=16, hint=[(0, 0), (2, 3), (1, 2)],
                         pool=True),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_sparse_plain_matches_pallas(case):
    p = DETECT_CASES[case]
    H, W, C = p["H"], p["W"], p["C"]
    rng = np.random.default_rng(17)
    window = ((2, 2), (2, 2), "VALID") if p.get("pool") else \
        ((3, 3), (1, 1), "SAME")
    g = conv_tile_geometry((H, W, C), window[0], window[1], (1, 1),
                           window[2], 8, 8)
    hh, hw = -(-H // 8), W // 8
    hint = np.zeros((hh, hw), bool)
    if p["hint"] == "all":
        hint[:] = True
    for hi, hj in ([] if p["hint"] == "all" else p["hint"]):
        hint[hi, hj] = True
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    # changes only inside the rows each hinted tile owns (the producer's
    # invariant: unhinted pixels did not change)
    own = np.repeat(np.repeat(hint, 8, 0), 8, 1)[:H, :W]
    bump = (rng.uniform(size=(H, W)) < 0.4) & own
    x = prev + bump[..., None] * rng.uniform(0.6, 1.5, (H, W, C)).astype(
        np.float32) * rng.choice([-1, 1], (H, W, 1))
    # some diffs just below tau must stay rejected
    x[0, 0, 0] = prev[0, 0, 0] + 0.49
    idx, count = _ids(hint)
    st = _storage(g, prev)

    jst, jmask, jnpix = j_detect(jnp.asarray(x), jnp.asarray(st), 0.5,
                                 jnp.asarray(idx), jnp.asarray(count), g,
                                 interpret=True)
    reset_launches()
    tst, tmask, tnpix = detect_sparse(_t(x), _t(st), 0.5, _t(idx), _t(count),
                                      t_conv_tile_geometry(
                                          (H, W, C), window[0], window[1],
                                          (1, 1), window[2], 8, 8))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tnpix.numpy(), np.asarray(jnpix))
    exact = int(((np.abs(x - prev).max(-1) > 0.5) & own).sum())
    assert int(tnpix[0]) == exact
    assert (exact > 0) == bool(hint.any())
    assert launches()["detect_sparse"] == 0  # CPU: plain version only


# ----------------------------- B2 delta conv --------------------------------

CONV_CASES = {
    "small": dict(H=32, W=48, cin=8, cout=16, tiles=[0, 3, -1, "mid"]),
    "clamped_rows": dict(H=20, W=16, cin=8, cout=8, tiles=[0, -1, -2]),
    "full_width": dict(H=16, W=16, cin=128, cout=256, tiles=[0, 3]),
    "count_zero": dict(H=16, W=16, cin=8, cout=8, tiles=[]),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_delta_conv_plain_matches_pallas(case):
    p = CONV_CASES[case]
    H, W, cin, cout = p["H"], p["W"], p["cin"], p["cout"]
    rng = np.random.default_rng(0)
    g = conv_tile_geometry((H, W, cin), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    xp = rng.standard_normal(g.store_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    out0 = rng.standard_normal((g.out_h_pad, g.out_w_pad, cout)).astype(
        np.float32)
    mask = np.zeros((g.tiles_h, g.tiles_w), bool)
    for t in p["tiles"]:
        mask.flat[g.n_tiles // 2 if t == "mid" else t] = True
    idx, count = _ids(mask)

    j_out = delta_conv_pallas(jnp.asarray(xp), jnp.asarray(idx),
                              jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(out0), g, "relu",
                              count=jnp.asarray(count), interpret=True)
    t_out = delta_conv(_t(xp), _t(idx), _t(w), _t(b), _t(out0),
                       t_conv_tile_geometry((H, W, cin), (3, 3), (1, 1),
                                            (1, 1), "SAME", 8, 8),
                       "relu", torch.float32, count=_t(count))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5)
    tiled = t_out.numpy().reshape(g.tiles_h, g.th, g.tiles_w, g.tw, cout)
    old = out0.reshape(g.tiles_h, g.th, g.tiles_w, g.tw, cout)
    keep = ~mask
    np.testing.assert_array_equal(tiled.transpose(0, 2, 1, 3, 4)[keep],
                                  old.transpose(0, 2, 1, 3, 4)[keep])


def test_dense_conv_shifted_matches_jax():
    rng = np.random.default_rng(5)
    g = conv_tile_geometry((20, 24, 8), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    xp = rng.standard_normal(g.store_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.2).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = jdc.dense_conv_shifted(jnp.asarray(xp), jnp.asarray(w),
                                  jnp.asarray(b), g, "relu")
    got = tdc.dense_conv_shifted(_t(xp), _t(w), _t(b), g, "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------ B3 fused pool -------------------------------


@pytest.mark.parametrize("C,blocks", [
    (128, [(0, 0), (2, 2), (3, 3)]),
    (16, [(0, 1), (1, 0), (3, 3), (2, 1)]),
    (16, []),  # count = 0: a no-op with an empty mask
    (56, [(0, 0), (1, 2), (3, 1)]),  # 7 16-byte units a bf16 pixel
    (512, [(2, 3), (0, 1)]),  # more items a thread than one batch holds
])
def test_detect_pool_fused_plain_matches_pallas(C, blocks):
    rng = np.random.default_rng(3)
    H, W = 32, 64
    g = conv_tile_geometry((H, W, C), (2, 2), (2, 2), (1, 1), "VALID", 8, 8)
    x = rng.standard_normal((H, W, C)).astype(np.float32)
    old = rng.standard_normal((g.out_h_pad, g.out_w_pad, C)).astype(
        np.float32)
    block_mask = np.zeros((H // 8, W // 16), bool)
    for bi, bj in blocks:
        block_mask[bi, bj] = True
    idx, count = _ids(block_mask)
    j_out, j_mask = j_pool(jnp.asarray(x), jnp.asarray(old), jnp.asarray(idx),
                           jnp.asarray(count), g, hint_h=8, hint_w=16,
                           interpret=True)
    t_out, t_mask = detect_pool_fused(_t(x), _t(old), _t(idx), _t(count), g,
                                      hint_h=8, hint_w=16)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    if not blocks:
        np.testing.assert_array_equal(t_out.numpy(), old)


# ------------------------ the grid of the list walkers ----------------------


@pytest.mark.parametrize("module", [KD, KP, KDP, KSC],
                         ids=["B1", "B3", "B8", "B5"])
@pytest.mark.parametrize("rel", ["zero", "below", "at", "above", "all_720p"])
def test_walk_grid_is_the_list_capped_at_blocks_per_sm(module, rel):
    """B1, B3, B8 and B5 launch min(capacity, k * SMs) blocks, which walk
    the device-side count: one block per entry up to k per SM, never more
    blocks than entries, none for an empty list. B5's capacity is its
    items over 8 warps a block: every tile's, since on overflow the walk
    covers all of them (3600 stem tiles at 720p, 16 items a tile at cout
    128)."""
    sms, k = 132, module.BLOCKS_PER_SM
    stem = t_conv_tile_geometry((720, 1280, 3), (3, 3), (1, 1), (1, 1),
                                "SAME", 8, 32)
    capacity = {"zero": 0, "below": k * sms - 1, "at": k * sms,
                "above": k * sms + 1,
                "all_720p": (KSC.walk_blocks(stem, 128) if module is KSC
                             else 90 * 160)}[rel]
    if module is KSC:
        assert stem.n_tiles == 3600 and KSC.walk_blocks(stem, 128) == 7200
        assert KSC.walk_blocks(stem, 64) == 7200  # 16 lanes a block
    grid = walk_grid(capacity, sms, k)
    assert grid == min(capacity, k * sms)
    assert (grid == 0) == (capacity == 0)
    assert grid <= capacity and grid <= k * sms


@pytest.mark.parametrize("cout", [1, 6, 16, 30, 64, 68, 96, 124, 128, 160,
                                  256, 384, 512])
def test_stem_conv_lane_split_covers_every_channel_once(cout):
    """B5's split of an item's 2 pixel blocks x cout channels over the 32
    lanes of a warp and 1 << cs chunks, as stem_conv.cu maps lane and chunk
    to (block, first channel): every (block, channel) falls to exactly one
    active lane, at widths whose lanes are no power of two too (cout 96:
    24 lanes' channels), where an even split of the warp needs the lanes
    rounded up."""
    cc, lanes, cs = KSC.lane_split(cout)
    assert cc == (4 if cout % 4 == 0 else 1) and cs <= 2
    assert 32 % lanes == 0
    cover = np.zeros((2, cout), np.int32)
    for chunk in range(1 << cs):
        for lane in range(32):
            n0 = (chunk * lanes + lane % lanes) * cc
            pb0 = 0 if lanes == 32 else lane // lanes
            pb1 = 2 if lanes == 32 else min(pb0 + 1, 2)
            if n0 < cout and pb0 < 2:
                cover[pb0:pb1, n0:n0 + cc] += 1
    np.testing.assert_array_equal(cover, 1)
    assert KSC.lane_split(516)[2] > 2  # past 4 chunks: the wrapper refuses


# ------------------------------ glue around them ----------------------------


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compact_mask_matches_jax(density):
    rng = np.random.default_rng(11)
    mask = rng.uniform(size=(6, 10)) < density
    want = jcompact.compact_mask(jnp.asarray(mask), mask.size)
    got = tcompact.compact_mask(_t(mask), mask.size)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert int(got.count) == int(want.count)
    assert got.idx.dtype == torch.int32 and got.count.dtype == torch.int32


@pytest.mark.parametrize("H,W,k,s", [(20, 24, 3, 1), (32, 48, 3, 1),
                                     (33, 40, 2, 2)])
def test_full_map_detect_and_tile_mask_match_jax(H, W, k, s):
    rng = np.random.default_rng(13)
    C = 3
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    x = prev + (rng.uniform(size=(H, W, 1)) < 0.05) * 1.0
    g = conv_tile_geometry((H, W, C), (k, k), (s, s), (1, 1), "SAME", 8, 8)
    jc, jch = jdetect.detect_and_update(jnp.asarray(x), jnp.asarray(prev),
                                        0.5)
    tc, tch = tdetect.detect_and_update(_t(x), _t(prev), 0.5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    np.testing.assert_array_equal(
        tdetect.changed_tile_mask(tch, g).numpy(),
        np.asarray(jdetect.changed_tile_mask(jch, g)))
