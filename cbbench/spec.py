"""The benchmark's data: ``BENCHMARK.json``, one file per configuration
(``configs/<config>.json``) and one per cell (``workloads/<cell>.json``),
found by name; the per-layer metric readers (``layer_metrics/<metric>.py``)
are loaded by path. Adding a model, a traffic mix or a metric adds files
and entries and edits none."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad cell name {name!r}")
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad config name {name!r}")
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def reader(metric: str) -> Callable:
    """``read(ctx)`` of a per-layer metric, from its own file."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = os.path.join(HERE, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "cbbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def pinned(entry: Dict[str, str]) -> str:
    """The absolute path of a pinned file of the checkout, after checking
    its sha256: another file would measure other weights."""
    path = os.path.join(ROOT, entry["file"])
    got = sha256(path)
    if got != entry["sha256"]:
        raise RuntimeError(f"{entry['file']}: sha256 {got}, pinned "
                           f"{entry['sha256']}")
    return path


def metrics_of(bench_: dict, cell_name: str, kind: str):
    """The (name, entry) pairs of ``kind`` (``end_to_end`` or
    ``per_layer``) that a cell reports: every metric without a
    ``workloads`` key, and those whose key lists the cell."""
    return [(m["name"], m) for m in bench_[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
