"""The calibration scripts' twins (``scripts/torch_*.py``: the torch
import demo, the backend policy, the refresh cadence, the threshold tuner
and the headline evaluation) end to end on the CPU at 64x128 with w8 nets,
each in a process where jax and the JAX package cannot be imported. Each
writes its record to a temporary directory with the keys of the
reference's file of the same kind, and the reference's calibration files
(``POLICY_*``, ``REFRESH_*``, ``TUNE_*``, ``RESULTS.json``,
``ckpts/*_tau.json``) stay byte for byte as they were."""

import glob
import hashlib
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--h", "64", "--w", "128", "--width-mult", "8"]

_BLOCKED_RUN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["cbinfer_tpu"] = None
import torch
torch.set_num_threads(2)
script, argv = sys.argv[1], sys.argv[2:]
sys.argv = [script] + argv
try:
    runpy.run_path(script, run_name="__main__")
except SystemExit as e:
    if e.code not in (None, 0):
        raise
bad = [m for m in sys.modules if (m == "jax" or m.startswith("jax.")
       or m == "cbinfer_tpu" or m.startswith("cbinfer_tpu."))
       and sys.modules[m] is not None]
assert not bad, bad
"""


def _reference_files():
    pats = ("POLICY_*.json", "REFRESH_*.json", "TUNE_*.json", "RESULTS.json",
            "ckpts/*_tau.json")
    return sorted(p for pat in pats for p in glob.glob(os.path.join(REPO,
                                                                    pat)))


def _digest(paths):
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in paths}


def _keys(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


def _run(script, args):
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, f"scripts/{script}", *args],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def _check_demo(tmp):
    out = tmp / "demo.json"
    _run("torch_demo_import.py", ["--device", "cpu", "--h", "64", "--w",
                                  "128", "--steps", "5", "--frames", "5",
                                  "--out", str(out)])
    got = json.loads(out.read_text())
    # the reference demo's checks: the walked specs, CB against dense
    assert got["specs"][:3] == ["ConvSpec", "PoolSpec", "ConvSpec"]
    assert got["ok"] and got["miou_vs_dense"] >= 0.98
    assert 0.0 < got["mean_recompute_fraction"] <= 1.0


def _check_policy(tmp):
    out = tmp / "policy.json"
    # the CPU's times are noise (the plain versions under a loaded host):
    # a gain no trial can reach keeps the flow deterministic (no flip, so
    # no final re-measure and its abort guard)
    _run("torch_optimize_policy.py",
         ["scene", *SMALL, "--frames", "4", "--chunks", "2", "--reps", "1",
          "--max-layers", "1", "--seed", "3", "--min-gain", "1e9",
          "--out", str(out)])
    got = json.loads(out.read_text())
    assert set(_keys("POLICY_scene.json")) <= set(got)
    assert got["seed"] == 3 and got["shape"] == [64, 128]
    # the band stem trial first, then both modes of the deepest layer
    assert [(t["key"], t["mode"]) for t in got["trials"]] == [
        ("0", "band_cached"), ("5", "dense_cached"), ("5", "forward_hint")]
    assert all(t["fps"] > 0 and not t["accepted"] for t in got["trials"])
    assert got["overrides"] == {} and got["gain"] == 1.0


def _check_refresh(tmp):
    out = tmp / "refresh.json"
    _run("torch_validate_refresh.py",
         ["scene", *SMALL, "--t", "4", "--chunks", "3", "--cadences", "2,0",
          "--seeds", "0", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _keys("REFRESH_scene.json")
    assert set(want) <= set(got)
    assert set(want["rows"][0]) <= set(got["rows"][0])
    assert [r["cadence"] for r in got["rows"]] == [2, 0]
    assert got["T"] == 4 and got["shape"] == [64, 128]
    assert set(got["worst_by_cadence"]) == {"2", "0"}


def _check_tune(tmp):
    tau, tune = tmp / "tau.json", tmp / "tune.json"
    _run("torch_tune_model.py",
         ["scene", "0.005", *SMALL, "--t", "8", "--refresh", "4", "--skip",
          "2", "--grid", "0.02,0.15", "--out-tau", str(tau), "--out-tune",
          str(tune)])
    got = json.loads(tau.read_text())
    want = _keys("ckpts/scene_w128_tau.json")
    assert set(want) == set(got) and len(got["thresholds"]) == 6
    assert set(want["metadata"]) <= set(got["metadata"])
    assert got["metadata"]["stress_validation"]["seeds"] == [101, 203]
    assert set(_keys("TUNE_scene.json")) <= set(json.loads(tune.read_text()))
    # --stress-only: the raw tuned vector of the record just written
    tau2 = tmp / "tau2.json"
    _run("torch_tune_model.py",
         ["scene", "--stress-only", "--prior", str(tau), *SMALL, "--t", "8",
          "--refresh", "4", "--skip", "2", "--out-tau", str(tau2)])
    rows = json.loads(tau2.read_text())["metadata"]["stress_validation"][
        "rows"]
    assert rows[0]["name"] == "tuned"
    assert rows[0]["thresholds"] == got["metadata"]["stress_validation"][
        "rows"][0]["thresholds"]


def _check_headline(tmp):
    out = tmp / "results.json"
    _run("torch_eval_headline.py",
         ["scene", *SMALL, "--t", "4", "--seed", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    want = next(r for r in _keys("RESULTS.json")["rows"]
                if r["model"] == "scene" and r.get("mode") is None)
    assert len(got["rows"]) == 2  # the tuned taus and a flat 0.02
    for row in got["rows"]:
        assert set(want) <= set(row)
        assert row["seed"] == 2 and row["resolution"] == "64x128"
        assert row["dense_fps"] > 0 and row["cb_fps"] > 0
        assert row["flop_reduction"] >= 1.0
    assert got["rows"][1]["tau"] == 0.02


CHECKS = {"demo_import": _check_demo, "optimize_policy": _check_policy,
          "validate_refresh": _check_refresh, "tune_model": _check_tune,
          "eval_headline": _check_headline}


@pytest.mark.parametrize("twin", sorted(CHECKS))
def test_twin_runs_on_cpu_without_jax(twin, tmp_path):
    before = _digest(_reference_files())
    CHECKS[twin](tmp_path)
    assert _digest(_reference_files()) == before

