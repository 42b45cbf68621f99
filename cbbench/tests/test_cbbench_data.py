"""The benchmark's data files: BENCHMARK.json against the contract's shape,
every configuration and cell file, the names and units, the per-layer
readers, and the checkpoint pins."""

import json
import os

import pytest

from cbbench import netdef, spec

BENCH_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
              "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
METRIC_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def bench():
    return spec.bench()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_and_paths(bench):
    assert set(bench) == BENCH_KEYS
    assert bench["paths"] == ["cbbench"]
    assert bench["command"] == ["python3", "-m", "cbbench.run"]
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
        assert spec.NAME.match(c["name"]) and _line(c["source"])
        assert c["file"] == f"cbbench/configs/{c['name']}.json"
        assert all(spec.NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == CELL_KEYS
        assert spec.NAME.match(w["name"]) and spec.NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert w["config"] in {c["name"] for c in bench["configs"]}
    for kind, keys in (("end_to_end", METRIC_KEYS), ("per_layer", LAYER_KEYS)):
        for m in bench[kind]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["name"] not in names
            names.add(m["name"])
    cells = {w["name"] for w in bench["workloads"]}
    assert len(cells) == len(bench["workloads"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = [n for n, _ in spec.metrics_of(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], "per_layer")


def test_cell_and_config_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["why"] == w["why"] and cell["chips"] == w["chips"]
        assert cell["entry"] in ("chunk", "live")
        cfg = spec.config(cell["config"])
        # each pass of the ring starts on a refresh, in whole chunks
        assert cell["ring_frames"] % cfg["refresh_every_frames"] == 0
        assert cfg["refresh_every_frames"] % cell["chunk"] == 0
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        n_cb = sum(n["cb"] for n in netdef.nodes_of(cfg))
        taus = spec.load_json(os.path.join(spec.ROOT, cfg["taus"]["file"]))
        assert len(taus["thresholds"]) == n_cb


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_checkpoint_pins_match_the_files(bench):
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        for entry in (cfg["weights"], cfg["taus"]):
            assert spec.sha256(os.path.join(spec.ROOT, entry["file"])) \
                == entry["sha256"]
            assert spec.pinned(entry).endswith(entry["file"])


def test_a_changed_checkpoint_is_refused(tmp_path, monkeypatch):
    fake = tmp_path / "ckpts"
    fake.mkdir()
    (fake / "w.npz").write_bytes(b"other weights")
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="sha256"):
        spec.pinned({"file": "ckpts/w.npz", "sha256": "0" * 64})
