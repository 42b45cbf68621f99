"""The cell ``openpose.cam1`` run whole on the CPU at a small size (the
harness's look for a card skipped, the program's plain versions
underneath): COCO OpenPose at its published widths, its stem on the
``dense_cached`` path as at 656 (80 is off the (8, 32) stem tile), its
stride-8 maps ragged (6 x 10 on 8x8 tiles). Untraced and traced, the run
is ``correct``; the float8 control fails the cell's limits."""

import pytest

from cbbench import calibrate, run, spec

CELL = "openpose.cam1"
SMALL = {"in_shape": [48, 80, 3], "ring_frames": 8, "chunk": 4,
         "refresh_every_frames": 8}
SEED = 2**31 + 11


@pytest.mark.parametrize("traced", [False, True])
def test_a_whole_run_is_correct(traced):
    r = run.run_cell(CELL, SEED, 0.3, traced, device="cpu",
                     overrides=SMALL)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert r["check"]["decisions"]["value"] == 0
    assert r["check"]["mismatched"]["value"] == 0
    assert set(r["check"]) == {"layer_gap", "answer_gap", "decisions",
                               "mismatched"}
    kind = "per_layer" if traced else "end_to_end"
    want = {n for n, _ in spec.metrics_of(spec.bench(), CELL, kind)}
    if traced:  # the CPU has no device trace: no per-layer metric reads
        assert set(r["metrics"]) <= want and "breakdown" in r
    else:
        assert set(r["metrics"]) == want == {"fps", "setup_s"}


def test_the_float8_control_fails_the_limits():
    got = list(calibrate.readings(CELL, [SEED], device="cpu",
                                  overrides=SMALL))
    assert len(got) == 1
    prog, ctl = got[0]["program"], got[0]["control"]
    assert prog["correct"] is True
    assert ctl["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in ctl["check"].items()
               if k in ("layer_gap", "answer_gap"))
