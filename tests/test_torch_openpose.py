"""COCO OpenPose at its published widths (``models.pose.openpose_coco``,
``zoo.load("openpose")``) against the plain float32 reference
(``models/openpose_reference.py``), on the CPU at 48x64: the topology and
the parameter count, the CB path through ``FrameStepper`` at tau = 0
against the reference frame by frame, every CB node's stored state at
tau > 0 against the reference's function of it, and the seeded weights'
script. The JAX package has no OpenPose: nothing here imports it."""

import os

import numpy as np
import pytest
import torch

from cbinfer_tpu_torch import checkpoint, zoo
from cbinfer_tpu_torch import layers as L
from cbinfer_tpu_torch.config import ConvSpec, PoolSpec
from cbinfer_tpu_torch.graph import (ConcatSpec, init_graph_params,
                                     node_out_shapes)
from cbinfer_tpu_torch.models import openpose_reference as ref_mod
from cbinfer_tpu_torch.models.pose import openpose_coco
from cbinfer_tpu_torch.ops.delta_conv import storage_interior
from cbinfer_tpu_torch.runner import FrameStepper
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

H, W = 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_make_openpose_weights.py")
PARAMS = 52_311_446  # the published COCO net's weights and biases


@pytest.fixture(scope="module")
def wl():
    return zoo.load("openpose", (H, W, 3), zoo.default_pipeline_config("cpu"))


@pytest.fixture(scope="module")
def ref():
    return ref_mod.OpenPoseReference(
        dict(np.load(zoo.REGISTRY["openpose"].npz)))


def _clip(n=4, seed=3):
    return torch.from_numpy(np.asarray(SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=2, sprite_size=12, speed=3.0,
        noise_std=0.002, seed=seed, distinct_classes=True)).clip(n)))


def _rel(a, b):
    return float((a - b).abs().amax() / b.abs().amax())


def test_topology_and_parameter_count(wl, ref):
    nodes, out = openpose_coco()
    shapes = node_out_shapes(nodes, (H, W, 3))
    # openpose_coco and the reference, written apart, give one net
    got = []
    for n in nodes:
        kind = n.spec.kind
        k = (n.spec.kernel[0] if isinstance(n.spec, ConvSpec)
             else n.spec.window[0] if isinstance(n.spec, PoolSpec) else 0)
        got.append((n.name, kind, k,
                    getattr(n.spec, "features", None),
                    getattr(n.spec, "activation", None) == "relu",
                    n.inputs))
    assert got == ref_mod.layers() and out == "out" and len(nodes) == 101
    cats = [n.name for n in nodes if isinstance(n.spec, ConcatSpec)]
    assert cats == [f"s{t}_cat" for t in range(2, 7)] + ["out"]
    assert all(shapes[c] == (H // 8, W // 8, 185) for c in cats[:-1])
    assert shapes["out"] == (H // 8, W // 8, 38 + 19)
    assert sum(1 for n in nodes if isinstance(n.spec, ConvSpec)
               and n.spec.kernel == (7, 7)) == 50
    assert sum(p[0].numel() + p[1].numel()
               for p in wl.params.values()) == PARAMS
    assert (wl.kind, wl.weights, wl.tau_source, wl.warnings) == (
        "graph", "trained(npz)", "tuned", [])
    # every node's scope names its part
    assert all(n.name.startswith(("bb_", "s1_", "s2_", "s3_", "s4_", "s5_",
                                  "s6_")) for n in nodes[:-1])


def test_the_converted_net_at_the_published_resolution():
    # the stem is dense_cached where 656 is off the (8, 32) stem tile; the
    # last stage's 1x1 heads feed no CB node and run dense
    net = zoo.load("openpose", (368, 656, 3),
                   zoo.default_pipeline_config("cpu")).net
    by = {n.name: n.spec for n in net.nodes}
    assert by["bb_conv1_1"].backend == "dense_cached"
    dense = [n.name for n in net.nodes
             if isinstance(n.spec, ConvSpec) and not n.spec.use_cb]
    assert dense == ["s6_Mconv6_L1", "s6_Mconv7_L1", "s6_Mconv6_L2",
                     "s6_Mconv7_L2"]
    assert net.num_cb_layers() == 91
    assert all(by[f"bb_pool{i}_stage1"].forward_hint for i in (1, 2, 3))


def test_cb_path_at_tau0_equals_the_reference(wl, ref):
    # at tau = 0 every pixel the noise moves is recomputed, the others keep
    # values computed from the same input: the CB path is the reference up
    # to float32 reassociation (the plain tile conv sums k*k shifted GEMMs,
    # F.conv2d in its own order), ~4e-6 of the output's scale after the
    # ~40 layers of its deepest path; 1e-4 leaves room and is far below a
    # bf16 rounding (4e-3)
    stepper = FrameStepper(wl.net, wl.params,
                           thresholds=[0.0] * wl.net.num_cb_layers())
    for f in _clip():
        y, _ = stepper(f)
        assert _rel(y.permute(2, 0, 1), ref(f)) < 1e-4


def _interior(net, name, state):
    """A CB node's accepted input, (C, H, W), out of its input cache."""
    n = next(x for x in net.nodes if x.name == name)
    shapes = node_out_shapes(net.nodes, net.in_shape)
    h, w, c = shapes[n.inputs[0]]
    cfg = L._layer_cfg(n.spec, net.cfg)
    g = L._geometry(n.spec, (h, w, state.in_cache.shape[-1]), cfg)
    return storage_interior(state.in_cache, g)[:h, :w, :c].permute(2, 0, 1)


def test_each_cb_node_holds_the_reference_of_its_accepted_input(wl, ref):
    # at tau > 0 the caches drift from the frame's own values; each CB
    # node's out cache must still be its function of the input it
    # accepted (a forward-hint pool: of its producer's out cache), up to
    # float32 reassociation in one layer (1e-5 of the node's scale)
    taus = [0.04] * wl.net.num_cb_layers()
    stepper = FrameStepper(wl.net, wl.params, thresholds=taus,
                           collect_stats=True)
    shapes = node_out_shapes(wl.net.nodes, wl.net.in_shape)
    skipped = 0
    for t, f in enumerate(_clip()):
        _, stats = stepper(f)
        st = stepper.state
        for n in wl.net.nodes:
            if st.get(n.name) is None:
                continue
            h, w, c = shapes[n.name]
            out = st[n.name].out_cache[:h, :w, :c].permute(2, 0, 1)
            if getattr(n.spec, "elide_in_cache", False):
                p = n.inputs[0]
                ph, pw, pc = shapes[p]
                x = st[p].out_cache[:ph, :pw, :pc].permute(2, 0, 1)
            else:
                x = _interior(wl.net, n.name, st[n.name])
            want = ref.node(n.name, x)
            assert float((out - want).abs().amax()) <= 1e-5 * max(
                float(want.abs().amax()), 1e-6), (t, n.name)
            if t and isinstance(n.spec, ConvSpec):
                s = stats[n.name]
                skipped += int(s["changed_tiles"]) < s["n_tiles"]
    assert skipped > 0  # tau > 0 left tiles alone


def test_the_weights_script_round_trips(tmp_path):
    import runpy
    mod = runpy.run_path(SCRIPT)
    path = tmp_path / "op8.npz"
    assert mod["main"](["--seed", "5", "--width", "8",
                        "--out", str(path)]) == 0
    again = tmp_path / "again.npz"
    mod["main"](["--seed", "5", "--width", "8", "--out", str(again)])
    assert path.read_bytes() == again.read_bytes()
    nodes, _ = openpose_coco(8)
    like = init_graph_params(nodes, (H, W, 3), 0, "cpu")
    got = checkpoint.load_npz_graph_params(str(path), like)
    flat = np.load(path)
    assert set(got) == {n.name for n in nodes if isinstance(n.spec,
                                                            ConvSpec)}
    for name, (w, b) in got.items():
        assert flat[f"w:{name}"].dtype == np.float16
        np.testing.assert_array_equal(w.numpy(), flat[f"w:{name}"])
        np.testing.assert_array_equal(b.numpy(), flat[f"b:{name}"])
    w = flat["w:s2_Mconv1_L1"]  # 7 * 7 * (38 + 19 + 16) inputs
    assert w.shape == (7, 7, 73, 16)
    assert abs(float(w.astype(np.float64).std())
               / np.sqrt(2 / (49 * 73)) - 1) < 0.05
    assert abs(float(np.concatenate(
        [flat[k].astype(np.float64) for k in flat if k[0] == "b"]).std())
        / 0.01 - 1) < 0.1
    other = mod["make_weights"](6, 8)
    assert not np.array_equal(other["w:bb_conv1_1"], flat["w:bb_conv1_1"])
