"""A whole run on the CPU at a small size (the harness's look for a card
skipped, the program's plain versions underneath): the result line's
keys, the refusal without a card, the import guard, and ``correct``
coming out false with the timed path broken underneath."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from cbbench import guard, run, spec

SMALL = {"in_shape": [64, 128, 3], "ring_frames": 8, "chunk": 4,
         "refresh_every_frames": 8}
SEED = 2**31 + 5
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# a test cell over the OpenPose DAG (``tests/pose_graph.cam1.json``): the
# node path, concats, B6 and the heat argmax answers through a whole run
GRAPH = "pose_graph.cam1"
SHAPE = {GRAPH: [80, 128, 3]}


def _tests_first(real):
    def find(name):
        path = os.path.join(spec.HERE, "tests", f"{name}.json")
        return spec.load_json(path) if os.path.exists(path) else real(name)
    return find


@pytest.fixture(autouse=True)
def declared_test_cells(monkeypatch):
    """The test cell found by name beside the benchmark's, and declared
    wherever ``scene.cam1`` is (the chunk cells' metrics)."""
    monkeypatch.setattr(spec, "cell", _tests_first(spec.cell))
    monkeypatch.setattr(spec, "config", _tests_first(spec.config))
    bench = spec.bench()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "scene.cam1" in m.get("workloads", []):
                m["workloads"].append(GRAPH)
    monkeypatch.setattr(spec, "bench", lambda: bench)


def _run(cell, traced=False, seconds=0.3):
    return run.run_cell(cell, SEED, seconds, traced, device="cpu",
                        overrides=dict(SMALL, in_shape=SHAPE.get(
                            cell, SMALL["in_shape"])))


@pytest.mark.parametrize("cell,traced", [("scene.cam1", False),
                                         ("scene.live", False),
                                         ("scene.pan", True),
                                         (GRAPH, False),
                                         (GRAPH, True)])
def test_the_result_line_has_the_contract_keys(cell, traced):
    r = _run(cell, traced)
    keys = list(r)
    assert set(keys) - {"breakdown"} == set(CONTRACT_KEYS + ["check"])
    assert keys[-1] == "check"  # the numbers compared come last
    assert ("breakdown" in keys) == traced
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0 and json.loads(json.dumps(r)) == r
    bench = spec.bench()
    kind = "per_layer" if traced else "end_to_end"
    want = {n for n, _ in spec.metrics_of(bench, cell, kind)}
    assert set(r["metrics"]) <= want
    if not traced:  # the CPU has no device trace: only host metrics
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["check"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(r["device"])


def test_without_a_card_it_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "cbbench.run", "--workload",
                        "scene.cam1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_guard_compares_whole_top_level_names():
    names = ["cbinfer_tpu_torch", "cbinfer_tpu_torch.runner", "jaxtyping",
             "cbinfer_tpu", "cbinfer_tpu.layers", "jax.numpy", "flax",
             "jaxlib.xla_client", "torch"]
    assert guard.forbidden_modules(names) == [
        "cbinfer_tpu", "cbinfer_tpu.layers", "flax", "jax.numpy",
        "jaxlib.xla_client"]
    assert guard.forbidden_modules(
        ["cbinfer_tpu_torch.zoo"], guard.FORBIDDEN_IN_REFERENCE) == [
            "cbinfer_tpu_torch.zoo"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", ["reference.py", "costs.py", "frames.py",
                                  "trace.py", "guard.py", "spec.py",
                                  "netdef.py", "layerwise.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    mods = list(_imports(os.path.join(spec.HERE, name)))
    assert not guard.forbidden_modules(mods, guard.FORBIDDEN_IN_REFERENCE)


def test_a_run_loads_no_jax_and_the_reference_no_program():
    code = (
        "import sys, json\n"
        "from cbbench import reference, costs, frames, guard\n"
        "ref_mods = guard.forbidden_modules(sys.modules, "
        "guard.FORBIDDEN_IN_REFERENCE)\n"
        "from cbbench import run\n"
        f"r = run.run_cell('scene.cam1', 3, 0.2, False, device='cpu', "
        f"overrides={SMALL!r})\n"
        "print(json.dumps([ref_mods, guard.forbidden_modules(sys.modules),"
        " r['correct']]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    ref_mods, run_mods, correct = json.loads(p.stdout.splitlines()[-1])
    assert ref_mods == [] and run_mods == [] and correct is True


def test_heat_argmax_answers_and_their_gaps():
    # the keypoint output form: each of the last k channels' flat argmax,
    # judged by the reference's peak less its heat at the program's place
    y = torch.zeros((2, 3, 5))
    y[0, 1, 3], y[1, 2, 4] = 1.0, 2.0
    assert run.out_map_of({"kind": "heat_argmax", "keypoints": 2})(
        y).tolist() == [1, 5]  # (0, 1) and (1, 2) of a 2x3 map
    ref = torch.zeros((1, 2, 6))
    ref[0, 0, 3], ref[0, 1, 5], ref[0, 1, 4] = 1.0, 0.9, 0.5
    g = run.gaps(ref, 0, torch.tensor([[3, 4]]))
    assert g.tolist() == [[0.0, pytest.approx(0.4)]]


# ----------------------------------------------------- broken underneath


def _nets():
    from cbinfer_tpu_torch.convert import CBNet
    from cbinfer_tpu_torch.graph import CBGraphNet
    return CBNet, CBGraphNet


def _stale_state(monkeypatch):
    """A step that returns its state unchanged: every steady frame gives
    the last refresh frame's output."""
    last = {}

    def wrap(real):
        def refresh(self, params, state, x, taus=None):
            y, st, stats = real(self, params, state, x, taus)
            last["y"] = y
            return y, st, stats
        return refresh

    def apply(self, params, state, x, taus=None):
        return last["y"], state, []
    for net in _nets():
        monkeypatch.setattr(net, "apply_refresh", wrap(net.apply_refresh))
        monkeypatch.setattr(net, "apply", apply)


def _half_the_chunk(monkeypatch):
    """Half of each chunk left out: the frames of its second half get the
    first half's outputs."""
    from cbinfer_tpu_torch import runner
    real = runner.scan_video

    def scan(net, params, frames, state=None, **kw):
        half = frames.shape[0] // 2
        ys, st, stats = real(net, params, frames[:half], state, **kw)
        return torch.cat([ys, ys]), st, stats
    monkeypatch.setattr(runner, "scan_video", scan)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: the network's output is
    raised at one place of another class (heat channel) than its best."""
    def wrap(real):
        def step(self, params, state, x, taus=None):
            y, st, stats = real(self, params, state, x, taus)
            y = y.clone()
            flat = y.reshape(-1, y.shape[-1])
            c = (int(flat[0].argmax()) + 1) % y.shape[-1]
            flat[0, c] += 50.0
            return y, st, stats
        return step
    for net in _nets():
        monkeypatch.setattr(net, "apply", wrap(net.apply))
        monkeypatch.setattr(net, "apply_refresh", wrap(net.apply_refresh))


@pytest.mark.parametrize("cell,fault", [
    ("scene.cam1", _stale_state), ("scene.cam1", _half_the_chunk),
    ("scene.cam1", _altered_answer), ("scene.live", _stale_state),
    ("scene.live", _altered_answer), ("scene.pan", _stale_state),
    ("scene.pan", _half_the_chunk), ("scene.pan", _altered_answer),
    (GRAPH, _stale_state), (GRAPH, _half_the_chunk),
    (GRAPH, _altered_answer)])
def test_correct_is_false_with_the_timed_path_broken(cell, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    r = _run(cell, traced=True)  # the traced pass: a whole ring judged
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["check"].values())
