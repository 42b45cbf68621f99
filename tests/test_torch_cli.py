"""The port's console entry (``cbinfer-torch``, ``cbinfer_tpu_torch.cli``)
on the CPU: the same ``miou_vs_dense`` and ``flop_reduction`` as the JAX
package's CLI on the same net, weights and clip (the reference's
``"pallas"`` path in interpret mode; its weights carried into the port by
patching the port's ``init_params``); the file-video, live and tuner
paths; the JSON keys; and the refusal to run without CUDA unless
``--device cpu`` is given."""

import json

import jax
import numpy as np
import pytest
import torch

import cbinfer_tpu.config as jconfig
from cbinfer_tpu import cli as jcli
from cbinfer_tpu.models import get_model as jget_model
from cbinfer_tpu.network import init_params as jinit_params

import cbinfer_tpu_torch.network as tnetwork
from cbinfer_tpu_torch import cli
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.fileio import write_y4m
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

SMALL = ["--model", "scene", "--width-mult", "8", "--height", "32",
         "--width", "64", "--frames", "4"]
KEYS = {"model", "backend", "miou_vs_dense", "flop_reduction", "thresholds"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: these tests run beside other
    test processes, where a small CPU op's worker threads mostly wait for
    one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, main, argv):
    """(the JSON result line, the lines after it)."""
    main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    i = next(i for i, ln in enumerate(lines) if ln.startswith("{"))
    return json.loads(lines[i]), lines[i + 1:]


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's CLI builds its params from the reference's init_params
    of the same seed."""
    def init_params(specs, in_shape, seed=0, device="cuda",
                    dtype=torch.float32):
        jp = jinit_params(jget_model("scene", num_classes=8, width=8),
                          in_shape, jax.random.PRNGKey(seed))
        return params_from_numpy(
            specs, [None if p is None else (np.asarray(p[0]),
                                            np.asarray(p[1])) for p in jp],
            device, dtype)
    monkeypatch.setattr(tnetwork, "init_params", init_params)


def test_cli_equals_the_reference_cli(capsys, monkeypatch,
                                      reference_weights):
    got, _ = _run(capsys, cli.main, SMALL + ["--device", "cpu", "--json"])

    cfg = jconfig.PipelineConfig  # its Pallas kernels in interpret mode
    monkeypatch.setattr(jconfig, "PipelineConfig",
                        lambda **kw: cfg(**kw, interpret=True))
    want, _ = _run(capsys, jcli.main, SMALL + ["--backend", "pallas",
                                               "--json"])
    assert set(got) == set(want) == KEYS
    assert got["backend"] == "cpu" and want["backend"] == "pallas"
    assert got["miou_vs_dense"] == want["miou_vs_dense"]
    assert got["flop_reduction"] == want["flop_reduction"]
    assert got["thresholds"] == want["thresholds"]
    assert got["flop_reduction"] > 1.0


@pytest.mark.parametrize("container", ["y4m", "npz"])
def test_cli_video_file(capsys, tmp_path, container):
    clip = SpriteVideo(SpriteVideoConfig(height=32, width=64, noise_std=0.0,
                                         seed=3)).clip(6)
    path = str(tmp_path / f"clip.{container}")
    if container == "y4m":
        write_y4m(path, clip)
    else:
        np.savez(path, frames=clip)
    out, table = _run(capsys, cli.main, [
        "--model", "scene", "--width-mult", "8", "--frames", "6",
        "--device", "cpu", "--video", path])
    assert set(out) == KEYS and out["flop_reduction"] > 1.0
    assert table[0].startswith("layer |") and len(table) == 8


def test_cli_live_and_tune(capsys):
    out, _ = _run(capsys, cli.main, SMALL + [
        "--frames", "8", "--device", "cpu", "--tune", "--budget", "0.05",
        "--live", "2", "--json"])
    assert set(out) == KEYS | {"live_ms_per_frame", "live_chunk"}
    assert out["live_chunk"] == 2 and out["live_ms_per_frame"] > 0
    assert len(out["thresholds"]) == 7
    assert all(t in (0.0,) + tuple(np.float32(
        (0.01, 0.02, 0.04, 0.08, 0.16, 0.32))) for t in out["thresholds"])
    out, lines = _run(capsys, cli.main, SMALL + [
        "--device", "cpu", "--tune", "--live"])
    assert out["live_chunk"] == 1
    assert lines[0].startswith("layer |")


def test_cli_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(SMALL + ["--json"])
