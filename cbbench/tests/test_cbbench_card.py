"""The control of ``correct`` on the card, at each cell's own size: the
plain reference at the precision below the configuration's (float8 e4m3
storage) put in the program's place, node by node on the program's stored
inputs and (cells with the free-running check) over the whole ring, must
come out not correct on three seeds, judged by the code that judges a run
(``run.verdict``), and fail both ``layer_gap`` and ``worst_gap``, while
the program's judged pass on the same seeds and a run of the program
(``run.run_cell``, a short window) on a fresh seed come out correct.
Run on a machine with a card:

    python -m pytest -m gpu cbbench/tests/test_cbbench_card.py
"""

import pytest

from cbbench import calibrate, run, spec

pytestmark = pytest.mark.gpu

CELLS = [w["name"] for w in spec.bench()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_and_the_program_is(card, cell):
    readings = list(calibrate.readings(
        cell, [2**31 + 11, 2**31 + 12, 2**31 + 13], device=card))
    assert len(readings) == 3
    for r in readings:
        assert r["control"]["correct"] is False, r
        assert r["control"]["failed"] > 0, r
        assert r["program"]["correct"] is True, r
        ctl = r["control"]["check"]
        for k in ("layer_gap", "worst_gap"):  # each fails the control
            if k in ctl:
                assert ctl[k]["value"] > ctl[k]["limit"], r
    result = run.run_cell(cell, 2**31 + 901, 2.0, False, device=card)
    assert result["correct"] is True and result["failed"] == 0, \
        result["check"]
