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

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cbinfer_tpu_torch.ops.kernels import tma_window as K

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
