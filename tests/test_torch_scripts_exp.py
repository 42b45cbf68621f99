"""The twins of the last reference scripts (``scripts/torch_*.py``: many
streams per card, the per-stage trace, the tau, fused-detect, stats and
pointwise A/Bs, mask forwarding, the stem/output/tile variants and the
figures) on the CPU.

Each runs end to end at 64x128 with w8 nets and ``--device cpu`` in a
process where jax and the JAX package cannot be imported, and writes its
record to a temporary directory with the keys of the reference's record
of the same kind; the reference's records stay byte for byte as they
were, and the figures twin writes PNGs from tiny records under its
``--out`` only. Without ``--device cpu`` each device twin raises where
CUDA is absent. The parity with the reference is in
``tests/test_torch_exp_parity.py``.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest
from test_torch_calibration import _run  # the twins' jax-blocked runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--h", "64", "--w", "128", "--width-mult", "8"]
RECORDS = ("RESULTS.json", "PROFILE.json", "EXP_tau_ab.json",
           "EXP_forward.json", "EXP_fused_ab.json", "EXP_variants.json",
           "EXP_stats_ab.json", "EXP_pointwise_ab.json")
# the keys of a stages entry that scripts/profile_trace.py writes (:356)
STAGE_KEYS = {"shape", "frames", "tau_source", "per_frame_us",
              "top_ops_us_per_frame", "note"}
DEVICE_TWINS = ("torch_bench_multistream.py", "torch_profile_trace.py",
                "torch_exp_tau_ab.py", "torch_exp_forward.py",
                "torch_exp_fused_ab.py", "torch_exp_variants.py",
                "torch_exp_stats_ab.py", "torch_exp_pointwise_ab.py")


def _digest():
    return {p: hashlib.sha256(open(os.path.join(REPO, p), "rb").read())
            .hexdigest() for p in RECORDS}


def _reference(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _check_multistream(tmp):
    out = tmp / "ms.json"
    _run("torch_bench_multistream.py", [*SMALL, "--streams", "2", "--t", "4",
                                        "--chunks", "1", "--reps", "2",
                                        "--seed", "3", "--out", str(out)])
    got = json.loads(out.read_text())
    want = next(r for r in _reference("RESULTS.json")["rows"]
                if r.get("mode") == "multistream")
    row, = got["rows"]
    assert set(want) <= set(row) and row["streams"] == 2
    for k in ("sequential", "batched", "batched_nogather"):
        assert len(row["all_fps"][k]) == 2 and row[f"{k}_fps_per_chip"] > 0
    # no side CUDA streams on the CPU
    assert row["side_streams_fps_per_chip"] is None


def _check_trace(tmp):
    out = tmp / "trace.json"
    _run("torch_profile_trace.py", ["scene", "pose_graph", *SMALL, "--t",
                                    "2", "--out", str(out)])
    stages = json.loads(out.read_text())["stages"]
    assert set(stages) == {"scene", "scene_eager", "pose_graph",
                           "pose_graph_eager"}
    for name, row in stages.items():
        assert STAGE_KEYS <= set(row)
        assert row["stage_sum_over_busy"] == pytest.approx(1.0, abs=0.02)
    # the eager rows split the host's operators by stage scope
    for name in ("scene_eager", "pose_graph_eager"):
        assert {"detect", "compact", "delta_conv"} <= set(
            stages[name]["per_frame_us"])


def _check_tau_ab(tmp):
    out = tmp / "tau.json"
    _run("torch_exp_tau_ab.py", [*SMALL, "--t", "4", "--chunks", "3",
                                 "--reps", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("EXP_tau_ab.json")
    assert set(want) <= set(got)
    assert [r["taus"] for r in got["rows"]] == [r["taus"]
                                                for r in want["rows"]]
    for row in got["rows"]:
        assert set(want["rows"][0]) <= set(row) and len(row["all_fps"]) == 2
        assert set(row["mean_changed_tiles_per_layer"]) == set(
            want["rows"][0]["mean_changed_tiles_per_layer"])


def _check_forward(tmp):
    out = tmp / "fwd.json"
    _run("torch_exp_forward.py", ["pose", *SMALL, "--t", "4", "--chunks",
                                  "1", "--seed", "3", "--out", str(out)])
    got = json.loads(out.read_text())["pose_64x128"]
    want = _reference("EXP_forward.json")["pose_720x1280"]
    for mode, row in want.items():
        assert set(row) <= set(got[mode]) and got[mode]["cb_fps"] > 0
    assert got["base"]["forwarding_layers"] == []
    assert set(got["fwd_deep"]["forwarding_layers"]) < set(
        got["fwd_all"]["forwarding_layers"])


def _check_fused_ab(tmp):
    out = tmp / "fused.json"
    _run("torch_exp_fused_ab.py", ["pose_graph", *SMALL, "--t", "2",
                                   "--chunks", "3", "--reps", "1", "--seed",
                                   "3", "--out", str(out)])
    got = json.loads(out.read_text())
    assert set(_reference("EXP_fused_ab.json")["runs"][0]) <= set(got)
    assert got["outputs_identical"] and got["fused_layers"] == 17


def _check_variants(tmp):
    out = tmp / "variants.json"
    for mode in ("out_dense", "tile"):  # merged, as the reference's are
        _run("torch_exp_variants.py", [mode, *SMALL, "--t", "2", "--chunks",
                                       "1", "--reps", "1", "--out",
                                       str(out)])
    got = json.loads(out.read_text())
    assert set(_reference("EXP_variants.json")) <= set(got)
    assert set(got["ms_per_frame"]) == {
        "out=dense_logits", "out=dense_argmax_u8", "tile=8x8", "tile=8x16",
        "tile=8x32", "tile=16x16", "tile=16x32"}
    assert got["refused"] == {}


def _check_stats_ab(tmp):
    out = tmp / "stats.json"
    _run("torch_exp_stats_ab.py", [*SMALL, "--t", "4", "--chunks", "3",
                                   "--reps", "2", "--seed", "3", "--out",
                                   str(out)])
    got = json.loads(out.read_text())["models"]["scene"]
    want = _reference("EXP_stats_ab.json")["models"]["scene"]
    assert set(want) <= set(got)
    assert set(got["ms_per_frame"]) == {"mean+classic", "none+classic"}
    assert set(got["not_ported"]) == {"mean+ingest", "none+ingest"}
    assert got["outputs_identical"]


def _check_pointwise_ab(tmp):
    out = tmp / "pw.json"
    _run("torch_exp_pointwise_ab.py", [*SMALL, "--t", "4", "--chunks", "3",
                                       "--reps", "2", "--seed", "3", "--out",
                                       str(out)])
    got = json.loads(out.read_text())["models"]["scene"]
    want = _reference("EXP_pointwise_ab.json")["models"]["scene"]
    assert set(want) <= set(got)
    assert got["argmax_agreement"] >= 0.999
    assert got["pointwise_dot_default"] is True


CHECKS = {"bench_multistream": _check_multistream,
          "profile_trace": _check_trace, "exp_tau_ab": _check_tau_ab,
          "exp_forward": _check_forward, "exp_fused_ab": _check_fused_ab,
          "exp_variants": _check_variants, "exp_stats_ab": _check_stats_ab,
          "exp_pointwise_ab": _check_pointwise_ab}


@pytest.mark.parametrize("twin", sorted(CHECKS))
def test_twin_runs_on_cpu_without_jax(twin, tmp_path):
    before = _digest()
    CHECKS[twin](tmp_path)
    assert _digest() == before


_NO_CUDA = r"""
import runpy, sys
import torch
torch.cuda.is_available = lambda: False
script = sys.argv[1]
sys.argv = [script] + sys.argv[2:]
try:
    runpy.run_path(script, run_name="__main__")
except (RuntimeError, SystemExit) as e:
    if isinstance(e, SystemExit) and e.code in (None, 0):
        raise AssertionError("exited 0 without CUDA")
    print("REFUSED", type(e).__name__, e)
else:
    raise AssertionError("ran without CUDA")
"""


@pytest.mark.parametrize("script", DEVICE_TWINS)
def test_twin_raises_without_cuda(script, tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", _NO_CUDA, f"scripts/{script}", "--out",
         str(tmp_path / "x.json")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "REFUSED" in r.stdout, \
        (script, r.stdout[-1000:], r.stderr[-2000:])
    assert not (tmp_path / "x.json").exists()


def _fixture_records(d):
    """Tiny records of every kind the figures twin reads."""
    row = {"tau": "tuned", "resolution": "64x128", "card": "a card, 1 W"}
    (d / "RESULTS_torch.json").write_text(json.dumps({"rows": [
        {"model": "scene", "cb_fps": 30.0, "dense_fps": 10.0,
         "speedup": 3.0, **row},
        {"model": "scene", "cb_fps": 20.0, "dense_fps": 10.0,
         "speedup": 2.0, **row, "tau": 0.02}]}))
    (d / "RESULTS_pose_graph_torch.json").write_text(json.dumps({"rows": [
        {"model": "pose_graph", "cb_fps": 5.0, "dense_fps": 4.0,
         "speedup": 1.25, **row, "tau": None}]}))
    (d / "TUNE_scene_torch.json").write_text(json.dumps({
        "pareto": [{"budget": 0.001, "metric": 0.999,
                    "flop_reduction": 3.0},
                   {"budget": 0.01, "metric": 0.99, "flop_reduction": 9.0}],
        "sensitivity": {"0": [[0.01, 1.0], [0.1, 0.98]],
                        "1": [[0.01, 1.0], [0.1, 0.9]]}}))
    (d / "PROFILE_trace_torch.json").write_text(json.dumps({
        "card": "a card, 1 W", "stages": {
            "scene": {"per_frame_us": {"detect": 100.0, "compact": 50.0,
                                       "delta_conv": 80.0, "glue": 30.0}},
            "scene_eager": {"per_frame_us": {"detect": 120.0,
                                             "cached_conv": 10.0}}}}))
    (d / "CHANGERATE_torch.json").write_text(json.dumps({
        "break_even_changed_tile_frac": 0.5, "rows": [
            {"point": "sprites1", "changed_tile_frac_layer0": 0.01,
             "speedup": 3.0},
            {"point": "pan_fast", "changed_tile_frac_layer0": 1.0,
             "speedup": 0.8}]}))


def test_figures_from_tiny_records(tmp_path):
    records, out = tmp_path / "records", tmp_path / "figures"
    records.mkdir()
    _fixture_records(records)
    before = sorted(os.listdir(os.path.join(REPO, "figures")))
    stdout = _run("torch_plot_results.py", ["--records", str(records),
                                            "--out", str(out)])
    want = {"speedup.png", "pareto.png", "sensitivity_scene.png",
            "stages.png", "changerate.png"}
    assert set(os.listdir(out)) == want
    assert all((out / p).stat().st_size > 1000 for p in want)
    assert "speedup.png" in stdout
    assert sorted(os.listdir(os.path.join(REPO, "figures"))) == before
