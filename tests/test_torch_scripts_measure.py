"""The measurement and accuracy scripts' twins (``scripts/torch_*.py``:
latency, the long stream, the DAG's headline row, the layer prefixes,
file footage, the change rate, the pose and DAG sweeps, the seg repro,
the graded study and the command-line shim) on the CPU.

Each runs end to end at 64x128 with w8 nets and ``--device cpu`` in a
process where jax and the JAX package cannot be imported, and writes its
record to a temporary directory with the keys of the reference's file of
the same kind; the reference's records stay byte for byte as they were.
Without ``--device cpu`` each raises where CUDA is absent. Then parity
with the reference on the same seed-made inputs, where the numbers do
not depend on the hardware:

- the graded study's per-layer changed-tile counts: exact (the
  reference's script itself runs, at 64x128 and T = 12, its file write
  redirected);
- the long stream's per-window GT-mIoU of CB and dense over 3 windows:
  within 1e-6 (float32 sums in another order), against the reference's
  protocol on its capacity-bounded ``jnp`` backend, the port's twin of it
  (``"torch"``) on the other side, the reference's weights carried over;
- the pose sweep's GT-PCK and PCK rows on one seed: equal to 4 places,
  the reference's script itself at 64x128, T = 4 and 2 chunks with a w8
  pose net, its weights carried over.
"""

import dataclasses
import glob
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from test_torch_calibration import _run  # the twins' jax-blocked runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--h", "64", "--w", "128", "--width-mult", "8"]
RECORDS = ("LATENCY.json", "LONGRUN.json", "RESULTS.json", "PROFILE.json",
           "REALFOOTAGE.json", "CHANGERATE.json", "GRAPH_ACC.json",
           "POSE_ACC.json", "STUDY_graded.json")

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _digest():
    return {p: hashlib.sha256(open(os.path.join(REPO, p), "rb").read())
            .hexdigest() for p in RECORDS}


def _reference(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------- each twin, end to end -----------------------------


def _check_latency(tmp):
    out = tmp / "latency.json"
    _run("torch_bench_latency.py", ["scene", "pose_graph", *SMALL,
                                    "--frames", "4", "--pipe-k", "8",
                                    "--windows", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("LATENCY.json")
    assert set(want) <= set(got)
    assert [r["model"] for r in got["rows"]] == ["scene", "pose_graph"]
    for row in got["rows"]:
        assert set(want["rows"][0]) <= set(row)
        assert row["frames"] == 4 and row["resolution"] == "64x128"
        assert all(np.isfinite(row[k]) and row[k] > 0 for k in (
            "wall_ms_p50", "device_ms_pipelined", "dense_ms_pipelined",
            "device_ms_chunk4", "device_ms_chunk8", "refresh_ms_p50",
            "scan_ms_per_frame"))
    assert got["rows"][0]["output_form"] == "argmax_u8"
    assert got["rows"][1]["output_form"] == "logits"


def _check_longrun(tmp):
    out = tmp / "longrun.json"
    _run("torch_bench_longrun.py", [*SMALL, "--t", "4", "--chunks", "6",
                                    "--win", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("LONGRUN.json")
    assert set(want) <= set(got)
    assert set(want["windows"][0]) <= set(got["windows"][0])
    assert [w["window_chunks"] for w in got["windows"]] == [[0, 2], [2, 4],
                                                             [4, 6]]
    assert got["horizon_frames"] == 24 and got["seed"] == 424242


def _check_pose_graph(tmp):
    out = tmp / "pose_graph.json"
    _run("torch_bench_pose_graph.py",
         ["--device", "cpu", "--sizes", "64x128", "--width-mult", "8",
          "--frames", "4", "--seed", "3", "--out", str(out)])
    got = json.loads(out.read_text())["rows"]
    want = next(r for r in _reference("RESULTS.json")["rows"]
                if r["model"] == "pose_graph")
    assert len(got) == 1 and got[0]["seed"] == 3
    # GT-PCK is scored with trained weights only, as the reference does
    assert set(want) - set(got[0]) == {"pck_gt_dense", "pck_gt_cb",
                                       "pck_degradation"}
    assert got[0]["flop_reduction"] >= 1.0 and got[0]["cb_fps"] > 0


def _check_profile(tmp):
    out = tmp / "profile.json"
    _run("torch_profile_stages.py", [*SMALL, "--frames", "4",
                                     "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("PROFILE.json")
    assert set(want) <= set(got)
    assert [r["k"] for r in got["rows"]] == [r["k"] for r in want["rows"]]
    for row in got["rows"]:
        assert set(want["rows"][0]) <= set(row)
        assert row["detect_ms_total"] > 0 and row["cb_ms_total"] > 0


def _check_footage(tmp):
    out = tmp / "footage.json"
    _run("torch_real_footage_demo.py", [*SMALL, "--frames", "32",
                                        "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("REALFOOTAGE.json")
    assert set(want) <= set(got)
    assert set(want["file"]) <= set(got["file"])
    assert set(want["cli"]) <= set(got["cli"])
    assert got["file"]["frames"] == 32
    assert not os.path.exists(os.path.join(REPO, got["file"]["path"]))
    assert 0.0 <= got["agreement_miou_vs_dense"] <= 1.0


def _check_changerate(tmp):
    out = tmp / "changerate.json"
    _run("torch_bench_changerate.py",
         [*SMALL, "--t", "4", "--chunks", "3", "--seed", "5", "--points",
          "sprites1,sprites24,pan_fast", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("CHANGERATE.json")
    assert set(want) <= set(got)
    assert [r["point"] for r in got["rows"]] == ["sprites1", "sprites24",
                                                 "pan_fast"]
    for row in got["rows"]:
        assert set(want["rows"][0]) <= set(row)
        assert row["within_budget"] == (row["miou_degradation"] <= 0.005)
        assert len(row["class_iou"]) == 2 == len(row["agreement_miou_chunks"])
    assert got["seed"] == 5


def _check_sweep(tmp, script, record):
    out = tmp / "sweep.json"
    _run(script, [*SMALL, "--t", "4", "--chunks", "2", "--seeds", "1",
                  "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference(record)
    assert set(want) <= set(got)
    assert [(r["taus"], r["cadence"]) for r in got["rows"]] == [
        (r["taus"], r["cadence"]) for r in want["rows"][:6]]
    for row in got["rows"]:
        assert set(want["rows"][0]) <= set(row)
        assert len(row["pck_gt_cb"]) == 2
    assert got["rows"][0]["seed"] == want["rows"][0]["seed"]


def _check_seg_repro(tmp):
    out = tmp / "seg.json"
    stdout = _run("torch_repro_seg_acc.py", [*SMALL, "--t", "4", "--warm",
                                             "--out", str(out)])
    got = json.loads(out.read_text())
    assert [r["chunk"] for r in got["rows"]] == [0, 1]
    assert got["seed"] == 65601 and got["warm"]
    assert stdout.count("chunk ") == 2 and "agree" in stdout


def _check_study(tmp):
    out = tmp / "study.json"
    _run("torch_study_graded.py", [*SMALL, "--t", "12", "--out", str(out)])
    got = json.loads(out.read_text())
    want = _reference("STUDY_graded.json")
    assert set(want) <= set(got)
    assert got["graded"] == want["graded"]
    assert set(got["arms"]) == set(want["arms"])
    for arm, rec in got["arms"].items():
        assert set(want["arms"][arm]) <= set(rec)
        assert [r["tau"] for r in rec["rows"]] == \
            [r["tau"] for r in want["arms"][arm]["rows"]]


def _check_run(tmp):
    stdout = _run("torch_run.py", ["--device", "cpu", "--height", "64",
                                   "--width", "128", "--width-mult", "8",
                                   "--frames", "4", "--json"])
    got = json.loads(stdout.strip().splitlines()[-1])
    assert got["model"] == "scene" and got["flop_reduction"] >= 1.0


CHECKS = {"bench_latency": _check_latency, "bench_longrun": _check_longrun,
          "bench_pose_graph": _check_pose_graph,
          "profile_stages": _check_profile,
          "real_footage_demo": _check_footage,
          "bench_changerate": _check_changerate,
          "pose_acc_sweep": lambda t: _check_sweep(
              t, "torch_pose_acc_sweep.py", "POSE_ACC.json"),
          "graph_acc_sweep": lambda t: _check_sweep(
              t, "torch_graph_acc_sweep.py", "GRAPH_ACC.json"),
          "repro_seg_acc": _check_seg_repro,
          "study_graded": _check_study, "run": _check_run}


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


def test_twins_raise_without_cuda(tmp_path):
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "scripts", "torch_*.py")))
    twins = ["torch_bench_latency.py", "torch_bench_longrun.py",
             "torch_bench_pose_graph.py", "torch_profile_stages.py",
             "torch_real_footage_demo.py", "torch_bench_changerate.py",
             "torch_pose_acc_sweep.py", "torch_graph_acc_sweep.py",
             "torch_repro_seg_acc.py", "torch_study_graded.py",
             "torch_run.py", "torch_changerate_seeds.py"]
    assert set(twins) <= set(names)
    for script in twins:
        args = ["--seeds", "0"] if script == "torch_changerate_seeds.py" \
            else ["--out", str(tmp_path / "x.json")] \
            if script != "torch_run.py" else []
        r = subprocess.run(
            [sys.executable, "-c", _NO_CUDA, f"scripts/{script}", *args],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0 and "REFUSED" in r.stdout, \
            (script, r.stdout[-1000:], r.stderr[-2000:])
        assert not (tmp_path / "x.json").exists()


# ----------------------- parity with the reference --------------------------


def test_graded_study_counts_equal_the_reference(tmp_path, monkeypatch):
    """``scripts/study_graded.py`` itself at 64x128, T = 12 (its output
    file redirected), against the twin's ``study``: the per-layer mean
    changed tiles of every arm and tau, exactly (the reference rounds to
    0.1 of a tile; one tile in 12 frames moves the mean by 0.083)."""
    ref = _load("study_graded")
    written = {}

    def fake_open(path, mode="r", *a, **k):
        assert path.endswith("STUDY_graded.json") and "w" in mode
        written["path"] = tmp_path / "study_ref.json"
        return open(written["path"], mode, *a, **k)

    monkeypatch.setattr(sys, "argv", ["study_graded.py", "64", "128", "12"])
    monkeypatch.setattr(ref, "open", fake_open, raising=False)
    ref.main()
    want = json.loads(written["path"].read_text())
    got = _load("torch_study_graded").study(64, 128, 12, "cpu",
                                            log=lambda m: None)
    for arm, rec in want["arms"].items():
        g = got["arms"][arm]
        for wr, gr in zip(rec["rows"], g["rows"]):
            assert wr["tau"] == gr["tau"]
            assert wr["mean_changed_tiles"] == [
                round(x, 1) for x in gr["mean_changed_tiles"]], (arm, wr)
        assert rec["gt_miou_dense"] == pytest.approx(g["gt_miou_dense"],
                                                     abs=1e-4)


def test_longrun_windows_equal_the_reference_protocol():
    """Three windows of two 4-frame chunks at 64x128 (scene w8, the
    shipped taus, a refresh every 2nd chunk): the twin's ``longrun`` on
    the port's ``"torch"`` backend against ``scripts/bench_longrun.py``'s
    loop run on the reference's ``jnp`` backend (the same video, warm
    chunk, refresh schedule, labels at the output's stride and per-class
    counts summed over a window), the reference's weights on both."""
    import jax
    import jax.numpy as jnp
    from cbinfer_tpu import config as jconfig
    from cbinfer_tpu.convert import convert_flagship as j_convert
    from cbinfer_tpu.metrics import iu_maps_device, merge_iu
    from cbinfer_tpu.models import get_model as j_get_model
    from cbinfer_tpu.network import init_params as j_init_params
    from cbinfer_tpu.network import out_shapes
    from cbinfer_tpu.runner import scan_video
    from cbinfer_tpu.video import SpriteVideo, SpriteVideoConfig

    from cbinfer_tpu_torch import config as tconfig
    from cbinfer_tpu_torch.checkpoint import params_from_numpy
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model

    H, W, T, CHUNKS, WIN, CADENCE, NC = 64, 128, 4, 6, 2, 2, 8
    with open(os.path.join(REPO, "ckpts", "scene_w128_tau.json")) as f:
        taus = json.load(f)["thresholds"]
    jspecs = j_get_model("scene", num_classes=NC, width=8)
    jnet = j_convert(jspecs, (H, W, 3), jconfig.PipelineConfig(
        tile=jconfig.TileConfig(8, 8, 0.375), backend="jnp"))
    jparams = j_init_params(jspecs, (H, W, 3), jax.random.PRNGKey(0))
    stride = H // out_shapes(jnet.specs, (H, W, 3))[-1][0]
    tv = jnp.asarray(taus, jnp.float32)

    def out_u8(y):
        return jnp.argmax(y, -1).astype(jnp.uint8)

    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=48, speed=4.0,
        noise_std=0.002, seed=424242))
    video.clip(T)  # the warm chunk
    st = jnet.init_state()
    want = []
    for w0 in range(0, CHUNKS, WIN):
        s_cb = s_dn = None
        for i in range(w0, w0 + WIN):
            f, lab = video.clip_with_labels(T)
            f, lab = jnp.asarray(f), jnp.asarray(lab[:, ::stride, ::stride])
            ys, st, _ = scan_video(jnet, jparams, f, state=st,
                                   thresholds=tv,
                                   refresh_start=i % CADENCE == 0,
                                   out_map=out_u8, collect_stats=False)
            dn = jax.lax.map(lambda x: out_u8(jnet.apply_dense(jparams, x)),
                             f)
            a = [np.asarray(v, np.int64) for v in iu_maps_device(ys, lab, NC)]
            b = [np.asarray(v, np.int64) for v in iu_maps_device(dn, lab, NC)]
            s_cb = a if s_cb is None else [x + y for x, y in zip(s_cb, a)]
            s_dn = b if s_dn is None else [x + y for x, y in zip(s_dn, b)]
        want.append((merge_iu(*s_cb), merge_iu(*s_dn)))

    specs = get_model("scene", num_classes=NC, width=8)
    net = convert_flagship(specs, (H, W, 3), tconfig.PipelineConfig(
        tile=tconfig.TileConfig(8, 8, 0.375), backend="torch",
        device="cpu"))
    params = params_from_numpy(
        specs, jax.tree.map(np.asarray, jparams), device="cpu")
    got = _load("torch_bench_longrun").longrun(
        net, params, taus, CADENCE, H, W, T, CHUNKS, WIN, 424242, stride,
        log=lambda m: None)
    assert len(got["windows"]) == len(want) == 3
    for row, (m_cb, m_dn) in zip(got["windows"], want):
        assert row["miou_gt_cb"] == pytest.approx(m_cb, abs=1e-6)
        assert row["miou_gt_dense"] == pytest.approx(m_dn, abs=1e-6)
    # the protocol is not vacuous: CB differs from dense somewhere
    assert any(r["degradation"] != 0 for r in got["windows"])


def test_pose_sweep_rows_equal_the_reference(tmp_path, monkeypatch):
    """``scripts/pose_acc_sweep.py`` itself at 64x128, T = 4, 2 chunks, one
    seed, on a w8 pose net (random weights from the reference's
    generator; its CPU path: the ``jnp`` backend in float32), against the
    twin's ``sweep`` on the same weights on the port's twin of that
    backend (``"torch"``, float32): every row's GT-PCK of dense and CB
    and PCK against dense, to the reference's 4 places."""
    import jax
    from cbinfer_tpu import zoo as jzoo

    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.checkpoint import params_from_numpy

    ref = _load("pose_acc_sweep")
    monkeypatch.setattr(ref, "H", 64)
    monkeypatch.setattr(ref, "W", 128)
    monkeypatch.setattr(ref, "T", 4)
    monkeypatch.setattr(ref, "CHUNKS", 2)
    monkeypatch.setitem(jzoo.REGISTRY, "pose", dataclasses.replace(
        jzoo.REGISTRY["pose"], width=8))
    loaded = {}
    real_load = jzoo.load

    def load(*a, **k):
        loaded["wl"] = real_load(*a, **k)
        return loaded["wl"]

    monkeypatch.setattr(ref, "zoo", types.SimpleNamespace(load=load))
    out = tmp_path / "pose_acc_ref.json"
    monkeypatch.setattr(sys, "argv", ["pose_acc_sweep.py", "1", str(out)])
    ref.main()
    want = json.loads(out.read_text())["rows"]
    jwl = loaded["wl"]
    assert jwl.weights.startswith("random")

    wl = zoo.load("pose", (64, 128, 3), dataclasses.replace(
        zoo.default_pipeline_config("cpu"), backend="torch"), width=8)
    wl = dataclasses.replace(wl, params=params_from_numpy(
        wl.specs, jax.tree.map(np.asarray, jwl.params), device="cpu"))
    assert wl.taus == pytest.approx(list(jwl.taus))
    got = _load("torch_pose_acc_sweep").sweep(wl, 64, 128, 4, 2, 1,
                                              log=lambda m: None)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["seed"], g["taus"], g["cadence"]) == \
            (w["seed"], w["taus"], w["cadence"])
        for key in ("pck_gt_dense", "pck_gt_cb", "agreement"):
            assert [round(x, 4) for x in g[key]] == w[key], (key, g, w)
