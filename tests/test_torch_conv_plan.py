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
    256->256 4 x 64, 128->128 4 x 32, cout 56 one block."""
    assert P.split(512) == (64, 8, 8)
    assert P.split(256) == (64, 4, 4)
    assert P.split(128) == (32, 4, 4)
    assert P.split(56) == (64, 1, 1)
    assert P.split(24) == (32, 1, 1)
    assert P.split(1024) == (64, 8, 16)


def test_split_plan_depends_on_cout_alone():
    """B2 and B6 must sum every output in the same order: the split is a
    function of cout alone, the same for B2 and B6 whatever cin, kernel
    size or window."""
    for cout in range(8, 1025, 8):
        plans = {P.conv_plan(cin, cout, k, k, k + 7, k + 7, det)[:3]
                 for cin in (8, 56, 256) for k in (1, 3)
                 for det in (False, True)}
        assert len(plans) == 1


@pytest.mark.parametrize("kh,kw,cin,cout", [
    (3, 3, 64, 64), (3, 3, 24, 56), (1, 1, 256, 56), (3, 3, 56, 264),
    (3, 3, 512, 256), (1, 1, 8, 16), (3, 3, 128, 1100)])
def test_packed_weights_round_trip_to_hwio(kh, kw, cin, cout):
    """pack_weights is exact (a permutation plus zero padding):
    unpack_weights gives the HWIO tensor back bit for bit, every padding
    entry is zero, and entry [s, g, r, c, e] is the weight of input row
    64 g + 8 (c ^ r % 8) + e of the taps padded to 16 channels and output
    channel s n_blk + r (the 128-byte swizzle of the wgmma's B)."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((kh, kw, cin, cout)).astype(
        np.float32)).to(torch.bfloat16)
    wp = P.pack_weights(w)
    n, _, slices = P.split(cout)
    stages = P.k_steps(cin, kh, kw) // P.STAGE_STEPS
    assert tuple(wp.shape) == (slices, stages, n, 8, 8)
    assert torch.equal(P.unpack_weights(wp, kh, kw, cin, cout), w)
    assert int((wp != 0).sum()) == int((w != 0).sum())
    cin16 = -(-cin // 16) * 16
    for s, g, r, c, e in [(0, 0, 0, 0, 0), (slices - 1, stages - 1, n - 1,
                                            7, 7), (0, stages // 2, 3, 5, 2),
                          (0, 0, 9, 1, 6)]:
        row, col = 64 * g + 8 * (c ^ r % 8) + e, s * n + r
        tap, ci = divmod(row, cin16)
        want = (w[tap // kw, tap % kw, ci, col]
                if tap < kh * kw and ci < cin and col < cout else 0.0)
        assert float(wp[s, g, r, c, e]) == float(want)


def test_packed_weights_are_kept_and_refreshed():
    """The packed copy is made once per weight tensor and made anew after
    the tensor is written in place."""
    w = torch.randn(3, 3, 16, 32).to(torch.bfloat16)
    a = P.packed_weights(w)
    assert P.packed_weights(w) is a
    w.mul_(2)
    b = P.packed_weights(w)
    assert b is not a
    assert torch.equal(P.unpack_weights(b, 3, 3, 16, 32), w)


def test_conv_plan_refuses_a_window_too_large_for_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        P.conv_plan(2048, 64, 3, 3, 10, 10)
