"""The port stands alone and runs on the card by default: it imports with
jax and cbinfer_tpu made unimportable, and its entry points raise where
CUDA is absent instead of carrying on on the CPU."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import cbinfer_tpu_torch
from cbinfer_tpu_torch.config import PipelineConfig
from cbinfer_tpu_torch.convert import convert_flagship
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cbinfer_tpu"] = None
import cbinfer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cbinfer_tpu_torch.__path__,
                                               "cbinfer_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "cbinfer_tpu" or m.startswith("cbinfer_tpu.")]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n = int(r.stdout.strip().splitlines()[-1])
    names = {m.name for m in pkgutil.walk_packages(cbinfer_tpu_torch.__path__,
                                                   "cbinfer_tpu_torch.")}
    assert n == len(names) >= 33
    # the workflow modules: the tuner, the command line, the file readers
    assert {"cbinfer_tpu_torch.tuner", "cbinfer_tpu_torch.cli",
            "cbinfer_tpu_torch.fileio"} <= names
    # many streams, the dry run, the native frame source
    assert {"cbinfer_tpu_torch.parallel", "cbinfer_tpu_torch.parallel.streams",
            "cbinfer_tpu_torch.parallel.dryrun",
            "cbinfer_tpu_torch.data"} <= names


def test_sources_never_name_jax():
    pkg = os.path.join(REPO, "cbinfer_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                for line in src.splitlines():
                    s = line.strip()
                    assert not (s.startswith(("import jax", "from jax",
                                              "import cbinfer_tpu ",
                                              "from cbinfer_tpu "))
                                or s.startswith("from cbinfer_tpu.")), \
                        (f, line)


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    specs = get_model("scene", width=16)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(specs, (64, 128, 3))
    net = convert_flagship(specs, (64, 128, 3), PipelineConfig(),
                           extra_overrides={0: "dense_cached"})
    with pytest.raises(RuntimeError, match="cuda"):
        net.init_state()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no
    result line; alone in a directory it cannot import the port either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), None)):
        if script is None:
            script = str(tmp_path / "chip_smoke.py")
            with open(os.path.join(REPO, "chip_smoke.py")) as f:
                src = f.read()
            with open(script, "w") as f:
                f.write(src)
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
