"""The layer-wise judgement on the CPU at small sizes (the program's plain
versions underneath): a scene-sized and a pose-sized net with seeded random
weights pass it; a tile off beyond the limit, a decision flipped and the
float8 control fail it; a chain written as nodes judges as the chain
reference; the OpenPose DAG passes through the node path."""

import json
import os
import types

import numpy as np
import pytest
import torch

from cbbench import frames, layerwise, netdef, run, spec
from cbbench.reference import Reference, rounder

# the DAG test cell beside the benchmark's (``tests/pose_graph.cam1.json``)
GRAPH_CELL = spec.load_json(os.path.join(spec.HERE, "tests",
                                         "pose_graph.cam1.json"))
LIMIT = spec.cell("scene.cam1")["limits"]["layer_gap"]
ANSWER_LIMIT = GRAPH_CELL["limits"]["answer_gap"]
SEED = 2**31 + 21
TAU = 0.02
NETS = {  # zoo name -> (width, frame, output form, a cell's traffic)
    "scene": (8, (64, 128, 3), {"kind": "class_map"},
              spec.cell("scene.cam1")["video"]),
    "pose": (8, (80, 128, 3), {"kind": "heat_argmax", "keypoints": 18},
             GRAPH_CELL["video"]),
}


def _cpu_cfg():
    from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
    return PipelineConfig(tile=TileConfig(8, 8, 0.375), backend="cuda",
                          compute_dtype="bfloat16", cache_dtype="bfloat16",
                          device="cpu")


def _small(name, tmp_path, seed=0):
    """The program's net at a small width, seeded random weights given to
    the program and (as an npz) to the judge, the configuration the
    judge reads, a run's sizes, and a ring of 8 frames refreshing every
    4."""
    from cbinfer_tpu_torch import checkpoint, zoo
    width, shape, output, video = NETS[name]
    wl = zoo.load(name, shape, _cpu_cfg(), width=width)
    rng = np.random.default_rng(seed)
    layers, params_np, weights = [], [], {}
    fused = False  # the layer before ran this one's detect (B6)
    for i, (s, p) in enumerate(zip(wl.net.specs, wl.params)):
        if s.kind == "pool":
            layers.append({"kind": "pool", "window": s.window[0],
                           "cb": s.use_cb, "forward": s.elide_in_cache,
                           "kernels": ["B3"] if s.elide_in_cache
                           else ["B1", "B8"]})
            params_np.append(None)
            fused = False
            continue
        k, _, cin, cout = p[0].shape
        w = rng.normal(0, (2.0 / (k * k * cin)) ** 0.5, (k, k, cin, cout))
        b = rng.normal(0, 0.05, cout)
        weights[f"w{i}"], weights[f"b{i}"] = w, b
        params_np.append((w.astype(np.float32), b.astype(np.float32)))
        kernels = ([] if not s.use_cb else ["B4", "B5"]
                   if s.backend == "patch_stem" else
                   ([] if fused else ["B1"])
                   + (["B6"] if s.fuse_next_detect else ["B2"]))
        fused = s.fuse_next_detect
        layers.append({"kind": "conv", "features": s.features, "kernel": k,
                       "activation": s.activation, "cb": s.use_cb,
                       "kernels": kernels})
    params = checkpoint.params_from_numpy(wl.net.specs, params_np, "cpu",
                                          torch.bfloat16)
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **weights)
    taus = [TAU] * sum(1 for layer in layers if layer["cb"])
    config = {"layers": layers, "cache_dtype": "bfloat16",
              "compute_dtype": "bfloat16", "capacity_fraction": 0.375,
              "output": output}
    prep = types.SimpleNamespace(
        torch=torch, shape=shape, ring_frames=8, refresh=4, device="cpu",
        wl=types.SimpleNamespace(net=wl.net, params=params, taus=taus),
        out_map=run.out_map_of(output), weights_path=path, taus=taus)
    ring = frames.make_ring(video, 8, SEED, *shape[:2], "cpu")
    return prep, config, ring


def _after_each_call(monkeypatch, fault):
    """``fault(stepper, t, frame, before)`` after the t-th frame of every
    ``FrameStepper``, ``before`` the in-caches as they were before it."""
    from cbinfer_tpu_torch.runner import FrameStepper
    real = FrameStepper.__call__
    seen = {}

    def call(self, frame):
        t = seen.setdefault(id(self), 0)
        before = [None if s is None else s.in_cache.clone()
                  for s in self.state]
        y, stats = real(self, frame)
        fault(self, t, frame, before)
        seen[id(self)] = t + 1
        return y, stats
    monkeypatch.setattr(FrameStepper, "__call__", call)


@pytest.mark.parametrize("name", list(NETS))
def test_a_scene_and_a_pose_sized_run_pass_the_layerwise_check(name,
                                                                tmp_path):
    prep, config, ring = _small(name, tmp_path)
    jp = run.judged_pass(prep, config, ring, count=True)
    assert jp.answers.shape[0] == 8
    assert int(jp.decisions.sum()) == 0
    assert 0 < float(jp.layer_gap.max()) <= LIMIT
    assert float(jp.answer_gap.max()) <= ANSWER_LIMIT
    check, failed, correct = run.verdict(
        jp, [(0, jp.answers)], {"layer_gap": LIMIT})
    assert correct and failed == 0 and check["mismatched"]["value"] == 0
    got = jp.judge.counter.launches.host()
    assert {"B1", "B3", "B4", "B5"} <= set(got)
    assert ("B6" in got) == (name == "pose")


@pytest.mark.parametrize("name", list(NETS))
def test_a_tile_off_beyond_the_limit_fails(name, tmp_path, monkeypatch):
    def fault(stepper, t, frame, before):
        if t == 5:  # one 8x8 tile of layer 1's out cache, 1.5 limits off
            out = stepper.state[1].out_cache
            top = out.float().abs().max()
            out[:8, :8] += (1.5 * LIMIT * top).to(out.dtype)
    _after_each_call(monkeypatch, fault)
    prep, config, ring = _small(name, tmp_path)
    jp = run.judged_pass(prep, config, ring)
    assert float(jp.layer_gap[:5].max()) <= LIMIT
    assert float(jp.layer_gap[5]) > LIMIT
    _, failed, _ = run.verdict(jp, [], {"layer_gap": LIMIT})
    assert failed >= 1


@pytest.mark.parametrize("name", list(NETS))
def test_one_flipped_decision_fails(name, tmp_path, monkeypatch):
    at = {}

    def fault(stepper, t, frame, before):
        store = stepper.state[0].in_cache  # the stem's input cache
        h, w, c = frame.shape
        if t == 0:  # the refresh: the whole frame is in the cache
            at["o"] = layerwise.locate(
                store, frame.to(store.dtype).float())
        if t == 5:  # a pixel that moved well past tau kept, not accepted
            oh, ow = at["o"]
            prev = before[0][oh:oh + h, ow:ow + w, :c]
            d = (frame - prev.float()).abs().amax(-1)
            p = torch.nonzero(d > TAU + 0.05)[0]
            store[oh + p[0], ow + p[1], :c] = prev[p[0], p[1]]
            at["d"] = float(d[p[0], p[1]])
    _after_each_call(monkeypatch, fault)
    prep, config, ring = _small(name, tmp_path)
    jp = run.judged_pass(prep, config, ring)
    assert at["d"] > TAU + 0.05
    assert int(jp.decisions[:5].sum()) == 0
    assert int(jp.decisions[5]) >= 1
    _, failed, _ = run.verdict(jp, [], {"layer_gap": LIMIT})
    assert failed >= 1


@pytest.mark.parametrize("name", list(NETS))
def test_the_float8_control_fails(name, tmp_path):
    prep, config, ring = _small(name, tmp_path)
    jp = run.judged_pass(prep, config, ring, control=True)
    assert float(jp.layer_gap.max()) <= LIMIT
    assert float(jp.control_layer_gap.min()) > LIMIT
    assert float(jp.control_layer_gap.max()) \
        >= 3 * float(jp.layer_gap.max())


def test_a_chain_written_as_nodes_judges_as_the_chain_reference():
    # the chain reference's own caches and outputs handed to the judge of
    # the same chain written as nodes: per node, the judge's function of
    # the cache is exactly the chain's output, its decisions the chain's
    cfg = spec.config("scene_w128")
    weights = dict(np.load(os.path.join(spec.ROOT, cfg["weights"]["file"])))
    taus = spec.load_json(os.path.join(spec.ROOT,
                                       cfg["taus"]["file"]))["thresholds"]
    as_nodes = {k: v for k, v in cfg.items() if k != "layers"}
    as_nodes["nodes"] = [dict(layer, name=f"n{i}",
                              inputs=[f"n{i - 1}" if i else "input"])
                         for i, layer in enumerate(cfg["layers"])]
    node_weights = {f"{k[0]}:n{k[1:]}": v for k, v in weights.items()}
    chain = Reference(cfg, weights, taus, "cpu")
    judge = layerwise.LayerJudge(as_nodes, node_weights, taus, (64, 128, 3),
                                 "cpu")
    assert [n["name"] for n in judge.nodes] == [f"n{i}" for i in range(7)]
    ring = frames.make_ring(spec.cell("scene.cam1")["video"], 6, SEED, 64,
                            128, "cpu")
    q = rounder("bfloat16")

    def hwc(t):
        return None if t is None else t.permute(1, 2, 0)
    for t in range(6):
        before = [None if c is None else c.clone() for c in chain.caches]
        y = chain.step(ring[t], refresh=t % 3 == 0)
        stored = {f"n{i}": (hwc(before[i]), hwc(chain.caches[i]),
                            hwc(chain.outputs[str(i)]))
                  for i, n in enumerate(chain.nodes) if n["cb"]}
        out, _, gap, wrong, _ = judge.frame(ring[t], t % 3 == 0, stored)
        assert float(gap) == 0.0 and int(wrong) == 0
        assert torch.equal(out, y) and torch.equal(q(out), q(y))


def test_pose_graph_loads_as_nodes_and_passes_on_the_node_path():
    with open(os.path.join(spec.HERE, "tests", "pose_graph_w64.json")) as f:
        config = json.load(f)
    assert "nodes" in config and "layers" not in config
    nodes = netdef.nodes_of(config)
    assert any(n["kind"] == "concat" for n in nodes)
    cell = {"entry": "chunk", "chunk": 4, "ring_frames": 8}
    prep = run.prepare(cell, config, "cpu", {"in_shape": [80, 128, 3],
                                             "refresh_every_frames": 4})
    assert [n.name for n in prep.wl.net.nodes] == [n["name"] for n in nodes]
    ring = frames.make_ring(GRAPH_CELL["video"], 8, SEED, 80, 128, "cpu")
    jp = run.judged_pass(prep, config, ring, count=True)
    assert int(jp.decisions.sum()) == 0
    assert float(jp.layer_gap.max()) <= LIMIT
    assert float(jp.answer_gap.max()) <= ANSWER_LIMIT
    assert set(jp.judge.by_node()) == {n["name"] for n in nodes if n["cb"]}
    got = jp.judge.counter.launches.host()
    assert {"B1", "B2", "B3", "B4", "B5", "B6", "B8"} <= set(got)
    # bb11's fused launch is completed by s1_paf_c0, whose input bb11 is
    # also read by the concat of stage 2
    assert netdef.fused_consumers(nodes)["bb11"] == "s1_paf_c0"
