"""The launch plan and the weight packing of the bf16 tile-conv kernels
(``cbinfer_tpu_torch/ops/conv_plan.py``): pure Python, checked here on the
CPU for every conv the 720p configurations launch on the card."""

import numpy as np
import pytest
import torch

from cbinfer_tpu_torch.config import ConvSpec
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes
from cbinfer_tpu_torch.ops import conv_plan as P
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry


CONFIGS = {
    "scene_w128": lambda: get_model("scene", num_classes=8, width=128),
    "pose_w64": lambda: get_model("pose", width=64),
    "seg_w64": lambda: get_model("seg", width=64),
}


def _convs(name):
    """(cin, cout, geometry) of every conv past the stem of a config at
    720p: what B2 and B6 launch on (the stem runs its own kernels)."""
    specs = CONFIGS[name]()
    shapes = [(720, 1280, 3)] + out_shapes(specs, (720, 1280, 3))
    out = []
    for i, spec in enumerate(specs):
        if not isinstance(spec, ConvSpec) or i == 0:
            continue
        h, w, cin = shapes[i]
        g = conv_tile_geometry((h, w, cin), spec.kernel, spec.stride,
                               spec.dilation, spec.padding, 8, 8)
        out.append((cin, spec.features, g))
    return out


@pytest.mark.parametrize("detect", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_split_plan_fits_every_720p_conv(name, detect):
    """Every conv of the config: at most 8 blocks to a cluster, slices that
    cover cout exactly once (the last may overhang into zero channels, by
    less than one slice), a ring of 1-4 stages, and a block's shared
    memory within the 232,448 bytes an H100 block may have, for B2 and
    for B6 (which also stages the consumer cache's tile)."""
    convs = _convs(name)
    assert convs
    for cin, cout, g in convs:
        kh, kw = g.kernel
        plan = P.conv_plan(cin, cout, kh, kw, g.win_h, g.win_w, detect)
        assert plan.n_blk in (16, 32, 64)
        assert 1 <= plan.csize <= P.MAX_CLUSTER
        assert plan.csize == min(P.MAX_CLUSTER, plan.slices)
        assert plan.slices * plan.n_blk >= cout > (plan.slices - 1) * plan.n_blk
        cover = np.zeros(plan.slices * plan.n_blk, int)
        for rank in range(plan.csize):
            for s in range(rank, plan.slices, plan.csize):
                cover[s * plan.n_blk:(s + 1) * plan.n_blk] += 1
        assert (cover == 1).all()
        assert 1 <= plan.stages <= P.MAX_STAGES
        assert plan.steps % P.STAGE_STEPS == 0
        assert plan.steps * 16 >= kh * kw * cin
        assert plan.smem <= P.SMEM_LIMIT


def test_split_plan_of_the_documented_widths():
    """The plan the kernels' source notes give: 256->512 is 8 x 64,
    256->256 4 x 64, 128->128 2 x 64 in B2 and 4 x 32 in B6, cout 56 one
    block."""
    for detect in (False, True):
        assert P.split(512, detect) == (64, 8, 8)
        assert P.split(256, detect) == (64, 4, 4)
        assert P.split(56, detect) == (64, 1, 1)
        assert P.split(24, detect) == (32, 1, 1)
        assert P.split(1024, detect) == (64, 8, 16)
    assert P.split(128) == (64, 2, 2)
    assert P.split(96) == (64, 2, 2)
    assert P.split(128, True) == (32, 4, 4)
    assert P.split(72, True) == (32, 3, 3)


def test_split_plan_depends_on_cout_alone():
    """The split is a function of cout and the kernel alone, whatever cin,
    kernel size or window; B2 and B6 split alike but at 64 < cout <= 128,
    where B2 takes slices of 64 channels and B6 of 32."""
    for cout in range(8, 1025, 8):
        plans = {det: {P.conv_plan(cin, cout, k, k, k + 7, k + 7, det)[:3]
                       for cin in (8, 56, 256) for k in (1, 3)}
                 for det in (False, True)}
        assert len(plans[False]) == len(plans[True]) == 1
        assert (plans[False] == plans[True]) == (not 64 < cout <= 128)


@pytest.mark.parametrize("kh,kw,cin,cout", [
    (3, 3, 64, 64), (3, 3, 24, 56), (1, 1, 256, 56), (3, 3, 56, 264),
    (3, 3, 512, 256), (1, 1, 8, 16), (3, 3, 128, 1100), (7, 7, 192, 128),
    (3, 3, 64, 96)])
def test_packed_weights_round_trip_to_hwio(kh, kw, cin, cout):
    """pack_weights is exact (a permutation plus zero padding):
    unpack_weights gives the HWIO tensor back bit for bit, every padding
    entry is zero, and entry [s, g, r, c, e] is the weight of input row
    64 g + 8 (c ^ r % 8) + e of the taps padded to 16 channels and output
    channel s n_blk + r (the 128-byte swizzle of the wgmma's B)."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((kh, kw, cin, cout)).astype(
        np.float32)).to(torch.bfloat16)
    for detect in (False, True):  # B2's slice width, and B6's
        n, _, slices = P.split(cout, detect)
        wp = P.pack_weights(w, n)
        stages = P.k_steps(cin, kh, kw) // P.STAGE_STEPS
        assert tuple(wp.shape) == (slices, stages, n, 8, 8)
        assert torch.equal(P.unpack_weights(wp, kh, kw, cin, cout), w)
        assert int((wp != 0).sum()) == int((w != 0).sum())
        cin16 = -(-cin // 16) * 16
        for s, g, r, c, e in [(0, 0, 0, 0, 0),
                              (slices - 1, stages - 1, n - 1, 7, 7),
                              (0, stages // 2, 3, 5, 2), (0, 0, 9, 1, 6)]:
            row, col = 64 * g + 8 * (c ^ r % 8) + e, s * n + r
            tap, ci = divmod(row, cin16)
            want = (w[tap // kw, tap % kw, ci, col]
                    if tap < kh * kw and ci < cin and col < cout else 0.0)
            assert float(wp[s, g, r, c, e]) == float(want)


def test_packed_weights_are_kept_and_refreshed():
    """The packed copy is made once per weight tensor and slice width, and
    made anew after the tensor is written in place."""
    w = torch.randn(3, 3, 16, 128).to(torch.bfloat16)
    a = P.packed_weights(w, 64)
    assert P.packed_weights(w, 64) is a
    a32 = P.packed_weights(w, 32)
    assert a32.shape[0] == 4 and a.shape[0] == 2
    assert P.packed_weights(w, 64) is a and P.packed_weights(w, 32) is a32
    w.mul_(2)
    b = P.packed_weights(w, 64)
    assert b is not a
    assert torch.equal(P.unpack_weights(b, 3, 3, 16, 128), w)
    assert torch.equal(P.unpack_weights(P.packed_weights(w, 32), 3, 3, 16,
                                        128), w)


def test_conv_plan_refuses_a_window_too_large_for_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        P.conv_plan(2048, 64, 3, 3, 10, 10)


# B2's launches in OpenPose at 656x368 (zoo.load("openpose")): (cin as
# stored, cout, kernel size); the 185-channel concat is stored at 192
OPENPOSE_B2 = [(192, 128, 7), (128, 128, 7), (128, 128, 3), (128, 128, 1),
               (256, 128, 3), (64, 128, 3), (128, 256, 3), (256, 256, 3),
               (512, 256, 3), (256, 512, 3), (512, 512, 3), (128, 512, 1),
               (128, 40, 1), (128, 24, 1), (512, 40, 1), (512, 24, 1),
               (64, 64, 3)]


@pytest.mark.parametrize("cin,cout,k", OPENPOSE_B2)
def test_openpose_b2_plans(cin, cout, k):
    """Every B2 launch of OpenPose fits a block's shared memory; at cout
    128 a tile is 2 blocks of 64 channels (B6 would take 4 of 32), and
    Mconv1's blocks (a 14x14 window of 192 channels) still fit 2 to an SM
    of 228 KB, 1 KB of it reserved a block."""
    plan = P.conv_plan(cin, cout, k, k, 7 + k, 7 + k)
    assert plan.smem <= P.SMEM_LIMIT
    assert plan.slices * plan.n_blk >= cout
    if 64 < cout <= 128:
        assert (plan.n_blk, plan.csize) == (64, 2)
        assert P.conv_plan(cin, cout, k, k, 7 + k, 7 + k, True)[:2] == (32, 4)
    if (cin, k) == (192, 7):
        assert plan.smem == 1024 + 1024 + 4 * 8192 + 14 * 14 * 200 * 2
        assert 2 * (plan.smem + 1024) <= 228 * 1024
