"""The DMA-window probes' plain versions (P1 and P2) against the
reference's Pallas kernels in interpret mode, on the eleven cases of
scripts/probe_dma_constraints.py, and the twin's reading of the tensor-map
encoder's rules. The reference's script is run as it is: its pallas_call
is wrapped to run in interpret mode and record each call's input and
output (its own check of the read cases raises, so its return values
cannot serve), and its cases are read off its calls."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cbinfer_tpu_torch.ops.kernels import tma_window as K
from test_torch_calibration import _run  # the twins' jax-blocked runner
from test_torch_scripts_exp import _NO_CUDA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin():
    return _load("torch_probe_dma_constraints",
                 os.path.join(REPO, "scripts",
                              "torch_probe_dma_constraints.py"))


def _plain(spec, shape):
    """A reference index (``pl.ds`` objects and slices) as plain slices."""
    out = []
    for s, n in zip(spec, shape):
        if isinstance(s, slice):
            out.append(slice(*s.indices(n)[:2]))
        else:
            out.append(slice(int(s.start), int(s.start) + int(s.size)))
    return tuple(out)


@pytest.fixture(scope="module")
def reference():
    """[(case name, window as plain slices, kernel input, kernel output)]
    in the order the reference's main() makes its calls."""
    mp = pytest.MonkeyPatch()
    # the script points JAX's compilation cache at a fixed directory
    mp.setattr(jax.config, "update", lambda *a, **k: None)
    try:
        ref = _load("probe_dma_constraints_ref",
                    os.path.join(REPO, "scripts", "probe_dma_constraints.py"))
    finally:
        mp.undo()
    calls, cases = [], []
    orig = pl.pallas_call

    def recording(kernel, **kw):
        f = orig(kernel, interpret=True, **kw)

        def call(*args):
            out = f(*args)
            calls.append((np.asarray(args[0]), np.asarray(out)))
            return out
        return call

    def case_w(name, ws, vshape, *rest):
        cases.append((name, _plain(ws, (ref.R, ref.G, ref.L))))
        return run_w(name, ws, vshape, *rest)

    def case_r(name, shape, rs, vshape):
        cases.append((name, _plain(rs, shape)))
        return run_r(name, shape, rs, vshape)

    run_w, run_r = ref.run_case, ref.run_case_read
    mp.setattr(pl, "pallas_call", recording)
    mp.setattr(ref, "run_case", case_w)
    mp.setattr(ref, "run_case_read", case_r)
    try:
        ref.main()
    finally:
        mp.undo()
    assert len(calls) == len(cases) == 11
    return [(n, w, i, o) for (n, w), (i, o) in zip(cases, calls)]


def _twin_cases(twin):
    return [(n, w) for n, w in twin.WRITE_CASES] \
        + [(n, w) for n, _, w in twin.READ_CASES]


def test_twin_has_the_reference_cases(twin, reference):
    """The same names, sources and windows, in the same order."""
    shapes = [(twin.R, twin.G, twin.L)] * 6 \
        + [sh for _, sh, _ in twin.READ_CASES]
    assert shapes == [i.shape for _, _, i, _ in reference]
    assert [(n, K.window_bounds(sh, w)) for (n, w), sh
            in zip(_twin_cases(twin), shapes)] == \
        [(n, K.window_bounds(i.shape, w)) for n, w, i, _ in reference]


@pytest.mark.parametrize("i", range(11))
def test_plain_version_equals_the_reference_kernel(twin, reference, i):
    """Tolerance 0: both are bf16 copies. The wrappers on CPU tensors run
    the plain versions."""
    name, window, inp, want = reference[i]
    if i < 6:
        dst = torch.from_numpy(inp.astype(np.float32)).to(torch.bfloat16)
        _, box = K.window_bounds(dst.shape, window)
        got = K.window_write(dst, window, box)
        assert got is dst  # in place, as the reference aliases it
    else:
        src = torch.from_numpy(inp.astype(np.float32)).to(torch.bfloat16)
        got = K.window_read(src, window)
        # the twin's source is the reference's, from the same generator
        assert torch.equal(twin.read_source(inp.shape), src)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_refusals_are_the_windows_that_break_the_encode_rules(twin):
    got = {n.split()[0]: K.encode_refusal(
        (twin.R, twin.G, twin.L) if n.startswith("w") else sh, w)
        for n, sh, w in [(n, None, w) for n, w in twin.WRITE_CASES]
        + list(twin.READ_CASES)}
    assert {k for k, v in got.items() if v} == {"w2", "w3", "w5", "r0", "r1",
                                               "r2", "r4"}
    for k in ("w2", "w3", "w5"):
        assert got[k] == ["box row = 36 x 2 = 72 B, not a multiple of 16"]
    for k in ("r0", "r1", "r2"):
        assert got[k] == ["box extent of dim 1 = 384 > 256"]
    assert got["r4"] == ["stride of dim 0 = 10888 B, not a multiple of 16"]


@pytest.mark.parametrize("shape,window,address,want", [
    ((8, 256), (slice(0, 8), slice(0, 256)), 0, []),
    ((8, 512), (slice(0, 8), slice(0, 264)), 0,
     ["box extent of dim 1 = 264 > 256"]),
    ((300, 16), (slice(0, 257), slice(0, 16)), 0,
     ["box extent of dim 0 = 257 > 256"]),
    ((8, 8), (slice(0, 8), slice(0, 8)), 0, []),  # a 16-byte row
    ((8, 12), (slice(0, 8), slice(0, 8)), 0,
     ["stride of dim 0 = 24 B, not a multiple of 16"]),
    ((4, 64), (slice(0, 4), slice(0, 4)), 0,
     ["box row = 4 x 2 = 8 B, not a multiple of 16"]),
    ((4, 64), (slice(0, 4), slice(0, 64)), 8,
     ["global address not 16-byte aligned"]),
    ((1,) * 5 + (8,), (slice(0, 1),) * 5 + (slice(0, 8),), 0,
     ["rank 6 not in 1..5"]),
])
def test_each_encode_rule(shape, window, address, want):
    assert K.encode_refusal(shape, window, 2, address) == want


@pytest.mark.parametrize("window", [
    (slice(0, 8, 2), slice(None)), (slice(3, 3), slice(None)),
    (slice(0, 9), slice(None)), (slice(None),)])
def test_window_bounds_refuse_other_windows(window):
    with pytest.raises(ValueError):
        K.window_bounds((8, 16), window)


def test_wrappers_raise_off_the_cpu_without_a_card():
    """A tensor neither on the CPU nor on the card is refused, not copied
    another way; so is a tile that is not the window's shape."""
    meta = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        K.window_write(meta, (slice(0, 8), slice(0, 16)))
    with pytest.raises(ValueError):
        K.window_read(meta, (slice(0, 8), slice(0, 16)))
    with pytest.raises(ValueError):
        K.window_write(torch.zeros((8, 16), dtype=torch.bfloat16),
                       (slice(0, 8), slice(0, 16)), (8, 8))


def test_twin_script_on_the_cpu(twin, tmp_path, capsys):
    """The script's CPU form: every case's plain version checks out
    against numpy's plain slices, each verdict is the rules'."""
    out = tmp_path / "probe.json"
    assert twin.main(["--device", "cpu", "--out", str(out)]) == 0
    records = json.loads(out.read_text())
    assert [r["case"] for r in records] == [n for n, _ in _twin_cases(twin)]
    assert all(r["values_ok"] and r["verdict_by"] == "rules"
               for r in records)
    assert [r["verdict"] for r in records] == [
        "accepted", "refused", "refused", "accepted", "refused", "accepted",
        "refused", "refused", "refused", "accepted", "refused"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 11 and lines[0].startswith("w1 ")


# Boxes' outer extents (outermost first) for every row width: ranks 1 to
# 5, a single row, rows fewer than, equal to and more than a block's rows
# a step, and 256 rows (the most one extent takes).
OUTER = [(), (1,), (3,), (37,), (256,), (2, 3), (7, 128), (9, 5, 3),
         (2, 2, 3, 5)]


@pytest.mark.parametrize("inner", range(8, 257, 8))
def test_write_plan_covers_each_vector_once(inner):
    """P1's block plan for every legal row width (vpr 1 to 32, with 3, 5,
    7 and 9, which do not divide 256): thread (x, y) of a (vpr, threads /
    vpr) block stores vector x of rows y, y + threads / vpr, ...; every
    16-byte vector of the box is stored exactly once, with the ramp values
    8x+1 .. 8x+8 that the plain tile holds there, by at most 256 threads."""
    for outer in OUTER:
        box = outer + (inner,)
        threads, vpr = K.write_plan(box)
        rows = int(np.prod(outer, dtype=np.int64))
        nvec = rows * vpr
        assert vpr == inner // 8 and 0 < threads <= 256, box
        assert threads % vpr == 0 and threads // vpr <= rows, box
        if rows >= 256 // vpr:
            assert threads == vpr * (256 // vpr), box
        stores = np.zeros(nvec, np.int64)
        tile = np.zeros((nvec, 8), np.float32)
        for y in range(threads // vpr):
            for x in range(vpr):
                at = np.arange(y * vpr + x, nvec, threads)
                stores[at] += 1
                tile[at] = np.arange(8 * x + 1, 8 * x + 9)
        assert (stores == 1).all(), box
        want = K.ramp(box).float().numpy().reshape(nvec, 8)
        got = torch.from_numpy(tile).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [(8, 36), (4,), (2, 12), (264,), (3, 260)])
def test_write_plan_has_none_for_boxes_the_encoder_refuses(box):
    """A box row that is not whole 16-byte vectors, or wider than 256
    elements, has no plan: the encoder refuses the box first."""
    assert K.write_plan(box) == (0, 0)


@pytest.fixture(scope="module")
def probe():
    return _load("torch_probe_dma_constraints_sweep",
                 os.path.join(REPO, "scripts",
                              "torch_probe_dma_constraints.py"))


SWEEP_RULES = {"s11": "box row = 6 x 2 = 12 B, not a multiple of 16",
               "s12": "box extent of dim 0 = 257 > 256",
               "s13": "stride of dim 0 = 200 B, not a multiple of 16",
               "s14": "global address not 16-byte aligned"}


@pytest.mark.parametrize("i", range(14))
def test_sweep_window_on_the_cpu(probe, i):
    """Each window of the sweep the card tests run: the encoder rules
    predict its verdict (each refused one breaks exactly the rule it is
    there for), and P1's and P2's plain versions equal numpy's plain
    slices, tolerance 0."""
    assert len(probe.SWEEP) == 14
    case = probe.SWEEP[i]
    got = probe.check_sweep_case(case, "cpu")
    key = case.name.split()[0]
    for kernel in ("write", "read"):
        r = got[kernel]
        assert r["verdict"] == ("accepted" if case.accepted else "refused")
        assert r["rules"] == ([SWEEP_RULES[key]] if key in SWEEP_RULES
                              else [])
        assert r["exact"] and r["values_ok"], (case.name, kernel)


def test_tma_ab_runs_its_cases_on_the_cpu(probe, tmp_path):
    """scripts/torch_tma_ab.py --device cpu, with jax blocked: its cases
    are the probe's four accepted windows and each timed sweep window
    through both kernels, and every plain arm (the plain version and
    ``copy_``) equals numpy's plain slices; no time is reported."""
    out = tmp_path / "ab.json"
    _run("torch_tma_ab.py", ["--device", "cpu", "--out", str(out)])
    records = json.loads(out.read_text())
    timed = [c.name for c in probe.SWEEP if c.timed]
    assert [(r["kernel"], r["case"].split()[0]) for r in records] == \
        [("P1", "w1"), ("P1", "w4"), ("P1", "w6"), ("P2", "r3")] + \
        [(k, n.split()[0]) for n in timed for k in ("P1", "P2")]
    assert all(r["plain_equals_numpy"] and r["copy_equals_numpy"]
               and r["ms_per_launch"] is None for r in records)
    assert all(r["plan"] == list(K.write_plan(r["box"]))
               for r in records if r["kernel"] == "P1")


def test_tma_ab_raises_without_cuda(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", _NO_CUDA, "scripts/torch_tma_ab.py",
         "--csrc", "cbinfer_tpu_torch/csrc", "--out",
         str(tmp_path / "x.json")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "REFUSED" in r.stdout, \
        (r.stdout[-1000:], r.stderr[-2000:])
    assert not (tmp_path / "x.json").exists()
