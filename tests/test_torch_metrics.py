"""The port's metrics against the JAX package's: host metrics equal on the
same numpy inputs, device metrics equal to the host ones (bf16 argmax
ties among them), the cost model equal to the reference's at the same
balance and logical widths, the stored widths it prices (a padded head
stores 40 channels, not 38 nor 128), and the change-rate histogram, the
drift bound and the per-tile FLOPs."""

import dataclasses

import numpy as np
import pytest
import torch

from cbinfer_tpu import metrics as jm
from cbinfer_tpu.models import get_model as jget_model

from cbinfer_tpu_torch import layers as L
from cbinfer_tpu_torch import metrics as tm
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.graph import convert_graph_flagship
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.models.pose import pose_graph
from cbinfer_tpu_torch.netview import NetView

RNG = np.random.default_rng(0)


def _logits(shape, levels=None, rng=RNG):
    x = rng.standard_normal(shape).astype(np.float32)
    if levels is not None:  # few distinct values: argmax ties are common
        x = np.round(x * levels) / levels
    return x


def test_host_mious_equal_the_reference():
    a, b = _logits((3, 12, 16, 5)), _logits((3, 12, 16, 5))
    lab = RNG.integers(0, 6, (3, 12, 16))
    assert tm.miou(a, b, 5) == jm.miou(a, b, 5)
    assert tm.miou_labels(a, lab, 6) == jm.miou_labels(a, lab, 6)
    ids = a.argmax(-1)  # an already argmaxed map
    assert tm.miou_labels(ids, lab, 6) == jm.miou_labels(ids, lab, 6)
    assert tm.pixel_accuracy(a, b) == jm.pixel_accuracy(a, b)
    empty = np.zeros((2, 2, 3), np.float32)
    assert tm.miou(empty, empty, 0) == jm.miou(empty, empty, 0) == 1.0
    # torch tensors, bf16 among them, read as their float32 values
    ta = torch.from_numpy(a).bfloat16()
    assert tm.miou(ta, b, 5) == jm.miou(ta.float().numpy(), b, 5)


def test_host_pcks_equal_the_reference():
    a, b = _logits((4, 10, 14, 6)), _logits((4, 10, 14, 6))
    np.testing.assert_array_equal(tm.keypoints_from_heatmaps(a[0]),
                                  jm.keypoints_from_heatmaps(a[0]))
    assert tm.pck(a[0], b[0]) == jm.pck(a[0], b[0])
    assert tm.pck(a, b, alpha=0.2) == jm.pck(a, b, alpha=0.2)
    with pytest.raises(ValueError, match="frame-count mismatch"):
        tm.pck(a, b[:3])
    pred = _logits((2, 9, 12, 8))
    kps = RNG.uniform(0, 36, (2, 4, 2))
    valid = RNG.random((2, 4)) > 0.3
    assert tm.pck_gt(pred, kps, valid, 4, num_keypoints=4) == \
        jm.pck_gt(pred, kps, valid, 4, num_keypoints=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_mious_equal_the_host(dtype):
    a = torch.from_numpy(_logits((4, 16, 16, 5), levels=2)).to(dtype)
    b = torch.from_numpy(_logits((4, 16, 16, 5), levels=2)).to(dtype)
    an, bn = a.float().numpy(), b.float().numpy()
    # ties are common at two levels, and both argmaxes take the first max
    assert (np.sort(an, -1)[..., -1] == np.sort(an, -1)[..., -2]).mean() \
        > 0.1
    np.testing.assert_array_equal(a.argmax(-1).numpy(), an.argmax(-1))
    lab = torch.from_numpy(RNG.integers(0, 5, (4, 16, 16)).astype(np.uint8))
    for got, want in (
            (tm.miou_device(a, b, 5), jm.miou(an, bn, 5)),
            (tm.miou_labels_device(a, lab, 5),
             jm.miou_labels(an, lab.numpy(), 5))):
        assert got.ndim == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6
    i, u = tm.miou_iu_device(a, b, 5)
    assert i.dtype == torch.int32
    assert abs(tm.merge_iu(i.numpy(), u.numpy()) - jm.miou(an, bn, 5)) \
        <= 1e-12
    i, u = tm.miou_labels_iu_device(a, lab, 5)
    assert abs(tm.merge_iu(i.numpy(), u.numpy())
               - jm.miou_labels(an, lab.numpy(), 5)) <= 1e-12
    i, u = tm.iu_maps_device(a.argmax(-1), b.argmax(-1), 5)
    assert abs(tm.merge_iu(i.numpy(), u.numpy()) - jm.miou(an, bn, 5)) \
        <= 1e-12
    # no class present in either map: the vacuous 1.0 of the host oracle
    assert float(tm.miou_device(a, b, 0)) == jm.miou(an, bn, 0) == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_pcks_equal_the_host(dtype):
    a = torch.from_numpy(_logits((3, 12, 12, 6), levels=2)).to(dtype)
    b = torch.from_numpy(_logits((3, 12, 12, 6), levels=2)).to(dtype)
    an, bn = a.float().numpy(), b.float().numpy()
    assert abs(float(tm.pck_device(a, b)) - jm.pck(an, bn)) <= 1e-6
    pred = torch.from_numpy(_logits((3, 9, 12, 8), levels=2)).to(dtype)
    kps = RNG.uniform(0, 36, (3, 4, 2))
    valid = RNG.random((3, 4)) > 0.4
    packed = torch.from_numpy(np.concatenate(
        [kps, valid[..., None]], -1).astype(np.float32))
    got = tm.pck_gt_device(pred, packed, 4, num_keypoints=4)
    want = jm.pck_gt(pred.float().numpy(), kps, valid, 4, num_keypoints=4)
    assert got.ndim == 0 and abs(float(got) - want) <= 1e-6
    none_valid = packed.clone()
    none_valid[..., 2] = 0
    assert float(tm.pck_gt_device(pred, none_valid, 4,
                                  num_keypoints=4)) == 1.0
    assert jm.pck_gt(pred.float().numpy(), kps, np.zeros_like(valid), 4,
                     num_keypoints=4) == 1.0


def _stats(view, frames=6, rng=RNG):
    """Random per-layer counters shaped like a scan's stacked stats, in a
    list by row."""
    out = []
    for row in view.rows:
        if not row.is_cb:
            out.append({})
            continue
        n = 4 + int(rng.integers(0, 60))
        comp = rng.integers(0, n + 1, frames)
        out.append({"computed_tiles": comp, "changed_tiles": comp,
                     "n_tiles": np.full(frames, n),
                     "detect_tiles": rng.integers(0, 4 * n, frames),
                     "changed_pixels": rng.integers(0, 999, frames),
                     "overflow": rng.random(frames) > 0.7})
    return out


def _torch_stats(stats):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
            for s in stats]


def test_cost_and_flops_equal_the_reference(monkeypatch):
    in_shape = (64, 128, 3)
    jspecs = jget_model("scene", num_classes=8, width=16)
    specs = get_model("scene", num_classes=8, width=16)
    stats = _stats(NetView.from_specs(specs, in_shape))
    for balance in (240.0, 295.2):
        want = jm.effective_cost(stats, jspecs, in_shape, 8, 8, balance)
        assert tm.effective_cost(stats, specs, in_shape, 8, 8,
                                 balance) == want
        assert tm.effective_cost(_torch_stats(stats), specs, in_shape, 8,
                                 8, balance) == want
    # the default balance is read at call time
    monkeypatch.setattr(tm, "MACHINE_BALANCE", 240.0)
    assert tm.effective_cost(stats, specs, in_shape, 8, 8) == \
        jm.effective_cost(stats, jspecs, in_shape, 8, 8)
    assert tm.effective_flops(stats, specs, in_shape, 8, 8) == \
        jm.effective_flops(stats, jspecs, in_shape, 8, 8)
    assert tm.layer_flops_per_tile(specs, in_shape, 8, 8) == \
        jm.layer_flops_per_tile(jspecs, in_shape, 8, 8)
    assert tm.change_rate_histogram(stats) == \
        jm.change_rate_histogram(stats)
    assert tm.change_rate_histogram(_torch_stats(stats)) == \
        jm.change_rate_histogram(stats)


def test_the_card_balance_is_its_own():
    assert tm.MACHINE_BALANCE != jm.MACHINE_BALANCE
    assert 150.0 <= tm.MACHINE_BALANCE <= 400.0


def test_cost_prices_the_widths_the_runtime_stores():
    """With a cfg, detect traffic is priced at the input storage that
    cb_layer_init allocates (``layers.cache_channels``), on every CB row
    of the DAG; the stage-1 heads' out caches are padded to the channel
    grid (38 -> 40 and 18 -> 24 in bf16), not left at 38 nor padded to
    the JAX package's 128 lanes."""
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375),
                         compute_dtype="bfloat16", cache_dtype="bfloat16",
                         device="cpu")
    nodes, out = pose_graph(width=8)
    net = convert_graph_flagship(nodes, (64, 128, 3), cfg, output=out)
    view = NetView.of(net)
    state = net.init_state()
    heads = {}
    for row in view.cb_rows():
        st = state[row.key]
        cin, cout = L.cache_channels(row.spec, row.in_shape[2], cfg)
        assert tm._detect_channels(row, cfg) == cin
        assert st.out_cache.shape[-1] == cout
        if not getattr(row.spec, "elide_in_cache", False):
            assert st.in_cache.shape[-1] == cin == row.in_shape[2]
        if getattr(row.spec, "features", None) in (38, 18):
            heads[row.spec.features] = cout
    assert heads == {38: 40, 18: 24}
    # and the cost of a graph's stats prices exactly those widths
    stats = {r.key: s for r, s in zip(view.rows, _stats(view))}
    got = tm.effective_cost_view(view, stats, 8, 8, balance=100.0)
    logical = tm.effective_cost_view(dataclasses.replace(view, cfg=None),
                                     stats, 8, 8, balance=100.0)
    assert got == logical


def test_drift_bound_equals_the_reference():
    specs = get_model("scene", num_classes=8, width=8)
    jspecs = jget_model("scene", num_classes=8, width=8)
    rng = np.random.default_rng(3)
    params_np, c = [], 3
    for s in specs:
        if hasattr(s, "features"):
            kh, kw = s.kernel
            params_np.append((rng.standard_normal(
                (kh, kw, c, s.features)).astype(np.float32) * 0.1,
                np.zeros(s.features, np.float32)))
            c = s.features
        else:
            params_np.append(None)
    taus = [0.02, 0.01, 0.03, 0.0, 0.05, 0.04, 0.01]
    want = jm.drift_bound(jspecs, params_np, taus)
    for dtype in (torch.float32, torch.bfloat16):
        params = params_from_numpy(specs, params_np, device="cpu",
                                   dtype=dtype)
        got = tm.drift_bound(specs, params, taus)
        if dtype == torch.float32:
            assert got == want
        else:  # the weights rounded to bf16
            assert got == pytest.approx(want, rel=2e-2)
    with pytest.raises(ValueError, match="thresholds"):
        tm.drift_bound(specs, params_from_numpy(specs, params_np,
                                                device="cpu"), taus[:3])
