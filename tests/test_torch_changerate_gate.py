"""The change-rate sweep's accuracy gate (``scripts/torch_bench_changerate.py``:
``map_accuracy`` and ``gate``, which ``chip_smoke.py``'s ``changerate``
phase applies per point). The gate is the repo's budget on ground truth,
GT-mIoU(dense) - GT-mIoU(CB) <= 0.005; the agreement mIoU of the CB map
with the dense map is recorded beside it and not gated, because one
class of a handful of pixels present in one map and absent from the
other scores IoU 0 and costs 1/8 of that chunk's mean while both maps are
equally right (``cbinfer_tpu/metrics.py:39-49``)."""

import importlib.util
import os

import numpy as np
import pytest

from cbinfer_tpu import metrics as jmetrics

from cbinfer_tpu_torch import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cr():
    spec = importlib.util.spec_from_file_location(
        "torch_bench_changerate",
        os.path.join(REPO, "scripts", "torch_bench_changerate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _maps():
    """Three chunks of (2, 24, 32) labels with all 8 classes in blocks;
    dense and CB maps equal to them except: in chunk 1 dense calls one
    background pixel class 2 (CB is right there), in chunk 3 CB calls one
    background pixel class 2, the only class-2 pixel of that chunk's
    maps (dense is right there). The two maps then have the same
    confusion counts against the labels."""
    rng = np.random.default_rng(0)
    labels = []
    for _ in range(3):
        lab = np.zeros((2, 24, 32), np.uint8)
        for c in range(1, 8):
            if c == 2:
                continue
            y, x = rng.integers(0, 18), rng.integers(0, 26)
            lab[:, y:y + 5, x:x + 5] = c
        labels.append(lab)
    labels[0][:, 0:6, 26:32] = 2   # class 2 lives in chunk 1 only
    dense = [lab.copy() for lab in labels]
    cb = [lab.copy() for lab in labels]
    bg = np.argwhere(labels[0][0] == 0)[0]
    dense[0][0, bg[0], bg[1]] = 2
    bg = np.argwhere(labels[2][1] == 0)[0]
    cb[2][1, bg[0], bg[1]] = 2
    return cb, dense, labels


def test_gate_passes_a_rare_class_flip_with_no_ground_truth_loss(cr):
    cb, dense, labels = _maps()
    row = cr.map_accuracy(cb, dense, labels)
    # how a clip of fast sprites once failed the agreement gate:
    # one class in one map only, in one chunk of three
    assert row["agreement_miou_chunks"][2] == pytest.approx(7 / 8, abs=1e-3)
    # far below the 0.995 the agreement was once gated at
    assert 0.95 < row["agreement_miou"] < 0.96
    cls2 = row["class_iou"][2][2]
    assert (cls2["iou"], cls2["cb_pixels"], cls2["dense_pixels"]) == \
        (0.0, 1, 0)
    assert row["pixel_agreement"] > 0.999
    assert row["miou_degradation"] == 0.0
    assert row["miou_gt_cb"] == row["miou_gt_dense"] < 1.0
    assert cr.gate(row)


def test_gate_refuses_a_ground_truth_loss_over_the_budget(cr):
    cb, dense, labels = _maps()
    worse = [c.copy() for c in cb]
    worse[1][:, :, :8] = 0          # a band of every class lost in chunk 2
    row = cr.map_accuracy(worse, dense, labels)
    assert row["miou_degradation"] > cr.GT_BUDGET
    assert not cr.gate(row)
    assert cr.gate({"miou_degradation": cr.GT_BUDGET})
    assert not cr.gate({"miou_degradation": cr.GT_BUDGET + 1e-6})


def test_miou_labels_equals_the_reference_on_those_maps():
    cb, dense, labels = _maps()
    for c, d, lab in zip(cb, dense, labels):
        for a, b in ((c, d), (c, lab), (d, lab)):
            assert tmetrics.miou_labels(a, b, 8) == \
                jmetrics.miou_labels(a, b, 8)
