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
from cbinfer_tpu_torch.ops import flat4
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches, walk_grid
from cbinfer_tpu_torch.ops.kernels import accept as KA
from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP
from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
from cbinfer_tpu_torch.ops.kernels import pool_fused as KP
from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC
from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD
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


@pytest.mark.parametrize("module", [KD, KP, KDP, KSC, KA, KDF],
                         ids=["B1", "B3", "B8", "B5", "B9", "B7"])
@pytest.mark.parametrize("rel", ["zero", "below", "at", "above", "all_720p"])
def test_walk_grid_is_the_list_capped_at_blocks_per_sm(module, rel):
    """B1, B3, B8, B5 and B9 launch min(capacity, k * SMs) blocks, which
    walk the device-side count: one block per entry up to k per SM, never
    more blocks than entries, none for an empty list. B5's capacity is its
    items over 8 warps a block: every tile's, since on overflow the walk
    covers all of them (3600 stem tiles at 720p, 16 items a tile at cout
    128). B9's is its (tile, part) pairs: every hint tile of pose_fwd's
    90x160 maps, 4 parts a tile at C 256 in bf16. B7's wide path walks
    every 8x8-pixel tile of the map (90x160 at 720p)."""
    sms, k = 132, module.BLOCKS_PER_SM
    stem = t_conv_tile_geometry((720, 1280, 3), (3, 3), (1, 1), (1, 1),
                                "SAME", 8, 32)
    all_720p = 90 * 160
    if module is KSC:
        all_720p = KSC.walk_blocks(stem, 128)
        assert stem.n_tiles == 3600 and all_720p == 7200
        assert KSC.walk_blocks(stem, 64) == 7200  # 16 lanes a block
    elif module is KA:
        all_720p = 12 * 20 * KA.part_split(8 * 256 * 2 // 16)[0]
        assert all_720p == 960
    capacity = {"zero": 0, "below": k * sms - 1, "at": k * sms,
                "above": k * sms + 1, "all_720p": all_720p}[rel]
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


@pytest.mark.parametrize("es", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("unit", [16, 4])
@pytest.mark.parametrize("C", [8, 16, 24, 56, 64, 128, 200, 256, 384, 512])
def test_accept_tiles_part_split_covers_every_unit_once(C, unit, es):
    """B9's split of a tile (8 rows of 8*C elements in 16- or 4-byte
    units) into parts, as accept_tiles.cu maps (part, thread, k) to the
    unit part * per + thread + 256 * k below the part's end: every unit
    of the tile falls to exactly one thread, no part is empty, a thread
    holds at most upt units (1, 2 or 4) and a part at most PART_UNITS;
    the arguments pass the kernel's own checks."""
    row_units = 8 * C * es // unit
    items = 8 * row_units
    parts, per, upt = KA.part_split(row_units)
    assert upt in (1, 2, 4) and per <= 256 * upt and per <= KA.PART_UNITS
    assert parts * per >= items > (parts - 1) * per
    cover = np.zeros(items, np.int32)
    for part in range(parts):
        end = min((part + 1) * per, items)
        for k in range(upt):
            e = part * per + np.arange(256) + 256 * k
            np.add.at(cover, e[e < end], 1)
    np.testing.assert_array_equal(cover, 1)
    # a thread of a full part moves more than one unit where it can: the
    # pose_fwd widths (C 128 and 256 in bf16, 16-byte units) take two
    if items > 256:
        assert upt == 2 and per > 256


@pytest.mark.parametrize("W", [8, 64, 248, 256, 264, 1280])
@pytest.mark.parametrize("H", [8, 24, 720])
def test_stem_detect_block_plan_covers_every_pixel_once(H, W):
    """B4's block plan, as stem_detect.cu maps (block, warp, lane, pixel)
    to map pixels: block -> (cell row, 32 cells), warp -> map row, lane ->
    cell, 8 pixels of the cell's row a thread; every pixel of 8-aligned
    maps falls to exactly one thread, widths off the 256-pixel block too,
    and lanes past the map load nothing."""
    bw, grid = KSD.block_plan(H, W)
    cover = np.zeros((H, W), np.int32)
    for blk in range(grid):
        ca, cb0 = blk // bw, blk % bw * 32
        for warp in range(8):
            for lane in range(32):
                cb = cb0 + lane
                if cb < W // 8:
                    cover[ca * 8 + warp, cb * 8:cb * 8 + 8] += 1
    np.testing.assert_array_equal(cover, 1)
    assert bw * 32 >= W // 8 > (bw - 1) * 32


def _block_marks(changed):
    """The cell mask stem_detect.cu builds from a changed map: per warp
    three ballots (a lane's cell, the cell left of its first pixel, right
    of its last) on the block's 34-cell window, per block the OR of its 8
    rows on its own cell row and rows 0 and 7 on the rows above and below,
    clipped to the map."""
    H, W = changed.shape
    ch, cw = H // 8, W // 8
    bw, grid = KSD.block_plan(H, W)
    mask = np.zeros((ch, cw), np.float32)
    for blk in range(grid):
        ca, cb0 = blk // bw, blk % bw * 32
        rows = []
        for warp in range(8):
            m = 0
            for lane in range(32):
                cb = cb0 + lane
                bits = (changed[ca * 8 + warp, cb * 8:cb * 8 + 8]
                        if cb < cw else np.zeros(8, bool))
                m |= (int(bits.any()) << (lane + 1) | int(bits[0]) << lane
                      | int(bits[7]) << (lane + 2))
            rows.append(m)
        own = 0
        for m in rows:
            own |= m
        for dr, m in enumerate((rows[0], own, rows[7])):
            row = ca - 1 + dr
            for j in range(34):
                col = cb0 - 1 + j
                if m >> j & 1 and 0 <= row < ch and 0 <= col < cw:
                    mask[row, col] = 1.0
    return mask


@pytest.mark.parametrize("H,W", [(24, 64), (16, 264), (32, 512)])
def test_stem_detect_block_marks_equal_the_windowed_or(H, W):
    """B4's block-level marking (at most one store a cell a block marks)
    gives exactly the 3x3 SAME windowed OR onto the 8x8 cells of the plain
    version (``changed_tile_mask`` on the cell geometry): changed pixels
    on every cell border and corner, across block borders (32 cells) and
    at the map's edges, and random ones."""
    rng = np.random.default_rng(H + W)
    g = flat4.cell_geometry(t_conv_tile_geometry(
        (H, W, 3), (3, 3), (1, 1), (1, 1), "SAME", 8, 32 if W % 32 == 0
        else 8))
    for trial in range(4):
        if trial == 0:  # every border and corner pixel of some cells
            changed = np.zeros((H, W), bool)
            for r in (0, 7, 8, H - 8, H - 1):
                for c in (0, 7, 8, 255, 256, W - 8, W - 1):
                    if r < H and c < W:
                        changed[r, c] = True
        elif trial == 1:
            changed = np.ones((H, W), bool)
        else:
            changed = rng.uniform(size=(H, W)) < 0.003 * trial
        want = tdetect.changed_tile_mask(_t(changed), g).float().numpy()
        np.testing.assert_array_equal(_block_marks(changed), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("shift", [0, 2, 4, 8])
def test_stem_detect_load_width(dtype, C, shift):
    """B4 takes 16-byte loads only where every thread's group of 8 pixels
    starts 16-byte aligned in the frame and in the storage, and always on
    the stem storage as ``make_storage`` allocates it (the paths' case);
    a storage whose pointer is shifted off 16 bytes takes element loads."""
    es = torch.tensor([], dtype=dtype).element_size()
    for W in (64, 1280):
        H = 16
        g = t_conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME",
                                 8, 32)
        s_row = g.store_shape[1] * C * es
        origin = (g.store_lo_h * g.store_shape[1] + g.store_lo_w) * C * es
        st_ptr = 4096 + shift * es
        vec = KSD.vec16(4096, st_ptr, s_row, origin)
        starts = [(st_ptr + origin + r * s_row + cb * 8 * C * es,
                   4096 + (r * W + cb * 8) * C * 4)
                  for r in range(H) for cb in range(W // 8)]
        aligned = all(a % 16 == 0 and b % 16 == 0 for a, b in starts)
        assert vec == aligned
        assert vec == (shift * es % 16 == 0)
        assert (8 * C * es) % 16 == 0  # a group is whole 16-byte units


# ------------------------------ glue around them ----------------------------


COMPACT_SHAPES = ((1, 1), (6, 10), (23, 40), (33, 60), (45, 80), (90, 80),
                  (135, 240))
COMPACT_CASES = [pytest.param((6, 10), d, 1.0, id=str(d))
                 for d in (0.0, 0.3, 1.0)] + [
    pytest.param(shape, d, share, id=f"{shape[0]}x{shape[1]}-{d}-{share}")
    for shape in COMPACT_SHAPES for d in ("first", "last", 0.0, 0.3, 1.0)
    for share in (1.0, 0.375)
    if not (shape == (6, 10) and share == 1.0 and d in (0.0, 0.3, 1.0))]


@pytest.mark.parametrize("shape,density,cap_share", COMPACT_CASES)
def test_compact_mask_matches_jax(shape, density, cap_share):
    """The list and count against the JAX package's: no flag, the first
    or the last alone, a share of flags set; every shape of the card's
    tests (a count that is no multiple of 16, two of its passes), the
    capacity all tiles or three eighths of them (the count past it)."""
    rng = np.random.default_rng(11)
    mask = np.zeros(shape, bool)
    if density == "first":
        mask.flat[0] = True
    elif density == "last":
        mask.flat[-1] = True
    else:
        mask = rng.uniform(size=shape) < density
    cap = mask.size if cap_share == 1.0 else -(-3 * mask.size // 8)
    want = jcompact.compact_mask(jnp.asarray(mask), cap)
    got = tcompact.compact_mask(_t(mask), cap)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert int(got.count) == int(want.count)
    assert got.idx.dtype == torch.int32 and got.count.dtype == torch.int32
    assert got.idx.shape == (cap,) and got.count.shape == ()


@pytest.mark.parametrize("mask,capacity,match", [
    (torch.zeros((6, 10), dtype=torch.uint8), 60, "must be bool"),
    (torch.zeros((6, 10)), 60, "must be bool"),
    (torch.zeros((6, 10), dtype=torch.int32), 60, "must be bool"),
    (torch.zeros((6, 10), dtype=torch.bool), -1, "capacity -1 < 0"),
    (torch.zeros((6, 10), dtype=torch.bool, device="meta"), 60,
     "on the card"),
])
def test_compact_tiles_refuses_what_it_does_not_take(mask, capacity, match):
    """A mask that is not bool, a negative capacity and a tensor on
    neither the CPU nor the card raise before anything runs."""
    from cbinfer_tpu_torch.ops.kernels import compact_tiles as KCT
    with pytest.raises(ValueError, match=match):
        KCT.compact_tiles(mask, capacity)


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
