"""Build and load the hand-written CUDA kernels (nvcc -> shared library with
a plain C interface -> ctypes), and the host-only graph reader beside them
(``graph_nodes``, read by ``ops/kernels/graph_nodes.py``).

Every ``csrc/*.cu`` file becomes its own library, built at first use into
``build/kernels/`` beside the package (listed in ``.gitignore``). The nvcc
processes for all sources start together, so a fresh checkout pays for the
slowest file only. Nothing here runs at import time: the CPU tests import
every module of the port on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "kernels"
SOURCES = ("detect_sparse", "delta_conv", "pool_fused", "stem_detect",
           "stem_conv", "detect_full", "delta_pool", "delta_conv_detect",
           "accept_tiles", "tma_window", "compact_tiles", "graph_nodes")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "cbinfer_tpu_torch kernels)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(ARCH.encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, object]:
    """Compile every kernel source not yet built (all nvcc processes in
    parallel), load the libraries, and return ``{"seconds": wall time,
    "ptxas": {name: register/shared-memory report}}``. Raises with nvcc's
    output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use)."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch function (a launch
    that is refused never runs, and a later synchronize does not say so)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
