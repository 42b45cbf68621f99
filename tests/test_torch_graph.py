"""The DAG slice on the CPU: the port's ``pose_graph`` nodes, the graph IR
(``node_out_shapes``), ``NetView`` and ``hint_reaches``, the graph
converter's flags, the graph params (numpy carry-across, the
``w:{node}``/``b:{node}`` npz), ``zoo.load("pose_graph")``, and a small
pose_graph (width 8 at 64x128) streamed through ``scan_video`` against the
JAX package's ``"pallas"`` path in interpret mode with the fused consumer
detect on, on the same clip with the JAX package's ``init_graph_params``
carried across.

As in ``test_torch_pose.py``: per-node stats must be identical, outputs
and caches agree within 5e-6 (float32, another summation order), and no
detect input of the reference run lies within 1.5e-5 of tau (asserted),
so a rounding difference can never flip a detect decision. Inside the
port, fused and unfused streams are bit-identical, and the runner's
one-dispatch and live forms, packed stats and state checkpoints take the
name-keyed state and stats of a ``CBGraphNet``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import checkpoint as jckpt
from cbinfer_tpu import graph as jgraph
from cbinfer_tpu import metrics as jmetrics
from cbinfer_tpu import netview as jnetview
from cbinfer_tpu import runner as jrunner
from cbinfer_tpu import video as jvideo
from cbinfer_tpu import zoo as jzoo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.models.pose import pose_graph as j_pose_graph

from _torch_carry import cache_from_lanes, cache_to_lanes
from cbinfer_tpu_torch import checkpoint, graph, metrics, profiling, zoo
from cbinfer_tpu_torch import layers as L
from cbinfer_tpu_torch import video as tvideo
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, TileConfig
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.models.pose import pose_graph
from cbinfer_tpu_torch.netview import NetView, hint_reaches
from cbinfer_tpu_torch.ops.kernels import launches, reset_launches
from cbinfer_tpu_torch.runner import (STAT_KEYS, FrameStepper, pack_stats,
                                      scan_video, scan_video_jit,
                                      unpack_stats)

H, W, T, TAU, SEED, WIDTH = 64, 128, 6, 0.05, 3, 8
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=12, speed=2.0,
             noise_std=0.0, seed=SEED, distinct_classes=True)
JCFG = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
TCFG = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
N_CB = 28
# producers of the fused consumer detect at 720p (the JAX converter's)
FUSED_720P = ["bb3", "bb6", "bb7", "bb10", "bb11", "s1_paf_c0", "s1_paf_c1",
              "s1_paf_c2", "s1_paf_1x1", "s1_heat_c0", "s1_heat_c1",
              "s1_heat_c2", "s1_heat_1x1", "s2_paf_c0", "s2_paf_c1",
              "s2_heat_c0", "s2_heat_c1"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: these tests run beside other
    test processes, where a small CPU op's worker threads mostly wait for
    one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec_dict(spec):
    d = dataclasses.asdict(spec)
    if d.get("backend") == "pallas":
        d["backend"] = "cuda"
    return d


def _node_dicts(nodes):
    return [(n.name, n.inputs, _spec_dict(n.spec)) for n in nodes]


def _np_params(jparams):
    return {k: (np.asarray(w), None if b is None else np.asarray(b))
            for k, (w, b) in jparams.items()}


# ------------------------------- model and IR --------------------------------


@pytest.mark.parametrize("kw", [{}, {"width": 8}, {"stages": 1},
                                {"stages": 3, "num_keypoints": 4,
                                 "num_pafs": 6}])
def test_pose_graph_nodes_match_reference(kw):
    jn, jo = j_pose_graph(**kw)
    tn, to = pose_graph(**kw)
    assert _node_dicts(tn) == _node_dicts(jn) and to == jo == "out"
    if not kw:
        assert len(tn) == 34
        assert [n.inputs for n in tn if n.spec.kind == "concat"] == [
            ("bb11", "s1_paf_out", "s1_heat_out"),
            ("s2_paf_out", "s2_heat_out")]


@pytest.mark.parametrize("shape", [(720, 1280, 3), (H, W, 3), (90, 100, 3)])
def test_node_out_shapes_match_reference(shape):
    jn, _ = j_pose_graph()
    tn, _ = pose_graph()
    got = graph.node_out_shapes(tn, shape)
    assert got == jgraph.node_out_shapes(jn, shape)
    if shape == (720, 1280, 3):
        assert got["s2_cat"] == (90, 160, 312) and got["out"] == (90, 160, 56)


def _views(kind):
    """(port view, reference view) of one topology."""
    shape = (720, 1280, 3)
    if kind == "pose_graph":
        jn, jo = j_pose_graph()
        tn, to = pose_graph()
        return (NetView.from_nodes(
            graph.convert_graph_flagship(tn, shape, TCFG, output=to,
                                         fuse_detect=True).nodes, shape),
                jnetview.NetView.from_nodes(
            jgraph.convert_graph_flagship(jn, shape, JCFG, output=jo,
                                          fuse_detect=True).nodes, shape))
    if kind == "pose_graph_unconverted":
        return (NetView.from_nodes(pose_graph(width=8)[0], shape),
                jnetview.NetView.from_nodes(j_pose_graph(width=8)[0], shape))
    return (NetView.from_specs(get_model(kind), shape),
            jnetview.NetView.from_specs(j_get_model(kind), shape))


@pytest.mark.parametrize("kind", ["pose_graph", "pose_graph_unconverted",
                                  "seg", "pose"])
def test_netview_and_hint_reaches_match_reference(kind):
    tv, jv = _views(kind)
    assert len(tv.rows) == len(jv.rows)
    for i, (tr, jr) in enumerate(zip(tv.rows, jv.rows)):
        assert (tr.key, tr.in_shape, tr.out_shape, tr.producers, tr.is_cb,
                tr.dense_flops) == (jr.key, jr.in_shape, jr.out_shape,
                                    jr.producers, jr.is_cb, jr.dense_flops)
        assert _spec_dict(tr.spec) == _spec_dict(jr.spec)
        assert tv.consumers(i) == jv.consumers(i)
        assert tv.descendants(i) == jv.descendants(i)
        assert hint_reaches(tv, i) == jnetview.hint_reaches(jv, i), tr.key
        p, q = tv.producer_row(i), jv.producer_row(i)
        assert (p is None and q is None) or p.key == q.key
    assert [r.key for r in tv.cb_rows()] == [r.key for r in jv.cb_rows()]
    if kind == "pose_graph":
        # the concat's readers see the OR of three CB hints
        i = [r.key for r in tv.rows].index("s2_paf_c0")
        assert hint_reaches(tv, i) and len(tv.cb_rows()) == N_CB


# -------------------------------- converter ----------------------------------


@pytest.mark.parametrize("shape", [(720, 1280, 3), (H, W, 3), (360, 640, 3)])
@pytest.mark.parametrize("kw", [
    dict(fuse_detect=True), dict(fuse_detect=False),
    dict(fuse_detect=True, extra_overrides={"s1_paf_c1": "forward_hint",
                                            "bb0": "dense_cached"}),
    dict(fuse_detect=True, extra_overrides={"bb9": "forward_hint",
                                            "s2_heat_c1": "forward_hint"}),
])
def test_convert_graph_flagship_marks_the_same_nodes(shape, kw):
    jn, jo = j_pose_graph()
    tn, to = pose_graph()
    jnet = jgraph.convert_graph_flagship(jn, shape, JCFG, output=jo, **kw)
    tnet = graph.convert_graph_flagship(tn, shape, TCFG, output=to, **kw)
    assert _node_dicts(tnet.nodes) == _node_dicts(jnet.nodes)
    assert tnet.output == "out" and tnet.num_cb_layers() == N_CB
    assert tnet.fused_consumer_map() == jnet.fused_consumer_map()
    fused = [n.name for n in tnet.nodes
             if getattr(n.spec, "fuse_next_detect", False)]
    spec = {n.name: n.spec for n in tnet.nodes}
    if shape[0] == 720 and kw == dict(fuse_detect=True):
        assert fused == FUSED_720P
        assert spec["bb0"].backend == "patch_stem"
        # the stage-1 heads feed the concat and stay CB; stage 2's are
        # dense (no CB descendant); the 180-row pool keeps its cache
        assert spec["s1_paf_out"].use_cb and spec["s1_heat_out"].use_cb
        assert not spec["s2_paf_out"].use_cb and not spec["s2_heat_1x1"].use_cb
        assert [spec[k].elide_in_cache for k in ("bb2", "bb5", "bb9")] \
            == [True, True, False]
        # bb11 serves s1_paf_c0; s1_heat_c0 and s2_cat read it too
        assert tnet.fused_consumer_map()["bb11"] == "s1_paf_c0"
    if not kw["fuse_detect"]:
        assert fused == []


def test_convert_graph_refuses_stale_overrides_and_taus():
    tn, to = pose_graph(width=8)
    with pytest.raises(ValueError, match="unknown node"):
        graph.convert_graph_flagship(tn, (H, W, 3), TCFG, output=to,
                                     extra_overrides={"bb99": "cuda"})
    with pytest.raises(ValueError, match="thresholds"):
        graph.convert_graph_flagship(tn, (H, W, 3), TCFG, output=to,
                                     thresholds=[0.1] * (N_CB - 1))
    net = graph.convert_graph_flagship(tn, (H, W, 3), TCFG, output=to)
    with pytest.raises(ValueError, match="thresholds"):
        net.apply(graph.init_graph_params(tn, (H, W, 3), device="cpu"),
                  net.init_state(), torch.zeros(H, W, 3), [0.1] * 3)


# ------------------------------- params, npz ---------------------------------


def test_graph_params_from_numpy_carries_reference_params(runs):
    tn = runs["nodes"]
    jparams = runs["jparams"]
    tparams = checkpoint.graph_params_from_numpy(tn, _np_params(jparams),
                                                 device="cpu")
    assert list(tparams) == list(jparams) == [
        n.name for n in tn if n.spec.kind == "conv"]
    for k, (w, b) in tparams.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jparams[k][0]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jparams[k][1]))
        assert w.dtype == torch.float32 and b.dtype == torch.float32
    bf = checkpoint.graph_params_from_numpy(tn, _np_params(jparams),
                                            device="cpu",
                                            dtype=torch.bfloat16)
    assert bf["bb0"][0].dtype == torch.bfloat16
    assert bf["bb0"][1].dtype == torch.float32
    # the port's own init has the reference's shapes
    mine = graph.init_graph_params(tn, (H, W, 3), seed=1, device="cpu")
    assert {k: tuple(v[0].shape) for k, v in mine.items()} == {
        k: tuple(v[0].shape) for k, v in jparams.items()}
    short = _np_params(jparams)
    short.pop("s1_heat_out")
    with pytest.raises(ValueError, match="s1_heat_out"):
        checkpoint.graph_params_from_numpy(tn, short, device="cpu")
    bad = _np_params(jparams)
    bad["bb3"] = (np.zeros((3, 3, 8, 5), np.float32), bad["bb3"][1])
    with pytest.raises(ValueError, match="bb3"):
        checkpoint.graph_params_from_numpy(tn, bad, device="cpu")


def test_npz_graph_params_round_trip(runs, tmp_path):
    """The reference's npz loads into the port, the port's into the
    reference, and each side reads back what it wrote."""
    tn, jparams = runs["nodes"], runs["jparams"]
    like = graph.init_graph_params(tn, (H, W, 3), seed=0, device="cpu")
    jckpt.save_npz_graph_params(str(tmp_path / "ref.npz"), jparams)
    got = checkpoint.load_npz_graph_params(str(tmp_path / "ref.npz"), like)
    for k, (w, b) in got.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jparams[k][0]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jparams[k][1]))
    checkpoint.save_npz_graph_params(str(tmp_path / "port.npz"), got)
    back = jckpt.load_npz_graph_params(str(tmp_path / "port.npz"), jparams)
    again = checkpoint.load_npz_graph_params(str(tmp_path / "port.npz"),
                                             like)
    for k in jparams:
        np.testing.assert_array_equal(np.asarray(back[k][0]),
                                      np.asarray(jparams[k][0]))
        assert torch.equal(again[k][0], got[k][0])


@pytest.mark.parametrize("fault,match", [
    ("missing_node", "missing w:bb4"), ("shape", "w:bb0 shape"),
    ("bias_free", "bias-free"), ("missing_bias", "missing b:bb1")])
def test_npz_graph_params_validation(tmp_path, fault, match):
    """Each fault the reference's loader names, the port's names too."""
    tn, _ = pose_graph(width=8)
    like = graph.init_graph_params(tn, (H, W, 3), seed=0, device="cpu")
    flat = {f"w:{k}": v[0].numpy() for k, v in like.items()}
    flat.update({f"b:{k}": v[1].numpy() for k, v in like.items()})
    if fault == "missing_node":
        del flat["w:bb4"]
    elif fault == "shape":
        like = graph.init_graph_params(pose_graph(width=16)[0], (H, W, 3),
                                       seed=0, device="cpu")
    elif fault == "bias_free":
        like = {k: (w, None) for k, (w, b) in like.items()}
    else:
        del flat["b:bb1"]
    np.savez(tmp_path / "p.npz", **flat)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_npz_graph_params(str(tmp_path / "p.npz"), like)


# ----------------------------------- zoo -------------------------------------


@pytest.mark.parametrize("kw", [{}, {"apply_policy": False}, {"tau": 0.03}])
def test_zoo_load_pose_graph_matches_reference(kw):
    shape = (720, 1280, 3)
    jw = jzoo.load("pose_graph", shape, JCFG, **kw)
    tw = zoo.load("pose_graph", shape, TCFG, **kw)
    assert _node_dicts(tw.net.nodes) == _node_dicts(jw.net.nodes)
    assert _node_dicts(tw.specs) == _node_dicts(jw.specs)
    for f in ("name", "kind", "metric", "weights", "tau_source",
              "policy_source", "warnings", "upsample_scale", "fuse_detect",
              "taus", "refresh_every"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert tw.kind == "graph" and tw.weights == "trained(npz)"
    assert len(tw.taus) == tw.net.num_cb_layers() == N_CB
    if not kw:
        assert tw.tau_source == "tuned" and tw.fuse_detect is True
        assert tw.policy_source.endswith("POLICY_pose_graph.json")
    if kw.get("apply_policy") is False:
        assert tw.fuse_detect is False and tw.policy_source == "none"
    assert list(tw.params) == list(jw.params)
    for k, (w, b) in tw.params.items():
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw.params[k][0]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jw.params[k][1]))
    assert tuple(tw.params["s2_paf_c0"][0].shape) == (3, 3, 312, 256)


def test_zoo_graph_policy_fallback_matches_reference(tmp_path, monkeypatch):
    """A policy file naming a node the topology lacks degrades to a
    no-policy build, fuse_detect dropped with it, in both packages."""
    bad = tmp_path / "POLICY_pose_graph.json"
    bad.write_text(json.dumps({"overrides": {"gone": "dense_cached"},
                               "fuse_detect": True}))
    for mod in (zoo, jzoo):
        monkeypatch.setitem(mod.REGISTRY, "pose_graph", dataclasses.replace(
            mod.REGISTRY["pose_graph"], policy_json=str(bad)))
    jw = jzoo.load("pose_graph", (H, W, 3), JCFG)
    tw = zoo.load("pose_graph", (H, W, 3), TCFG)
    assert tw.policy_source == jw.policy_source == "none"
    assert tw.fuse_detect is jw.fuse_detect is False
    assert len(tw.warnings) == len(jw.warnings) == 1
    assert "NOT applied" in tw.warnings[0] and "gone" in tw.warnings[0]
    assert not any(getattr(n.spec, "fuse_next_detect", False)
                   for n in tw.net.nodes)


@pytest.mark.parametrize("t,want", [(12, 8), (32, 2)])
def test_pose_graph_refresh_cadence_matches_reference(t, want):
    got = zoo.load_refresh_cadence("pose_graph", t, 720, 1280)
    assert got == jzoo.load_refresh_cadence("pose_graph", t, 720, 1280)
    assert got[0] == want
    assert got[1].endswith("REFRESH_pose_graph.json") == (t == 12)


def test_pose_graph_keypoint_clip_is_byte_identical():
    cfg = dict(height=48, width=64, n_sprites=3, sprite_size=10, speed=3.0,
               noise_std=0.002, seed=4, distinct_classes=True,
               **tvideo.workload_video_kwargs("pose_graph"))
    want = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**cfg))
    got = tvideo.SpriteVideo(tvideo.SpriteVideoConfig(**cfg))
    for _ in range(2):
        wf, wk, wv = want.clip_with_keypoints(3)
        gf, gk, gv = got.clip_with_keypoints(3)
        assert gf.tobytes() == wf.tobytes()
        assert gk.tobytes() == wk.tobytes() and gv.tobytes() == wv.tobytes()


# ---------------------------- padded out caches ------------------------------


@pytest.mark.parametrize("dtype,cout,stored", [
    ("float32", 38, 40), ("float32", 18, 20), ("bfloat16", 38, 40),
    ("bfloat16", 18, 24), ("bfloat16", 56, 56), ("float32", 6, 8)])
def test_cuda_convs_off_the_channel_grid_store_padded(dtype, cout, stored):
    """The tile-conv kernels store whole vectors of 8 (bf16) or 4 (f32)
    outputs: such a layer's out cache is padded, its Feature is not, and
    it never fuses its consumer's detect."""
    cfg = dataclasses.replace(TCFG, compute_dtype=dtype, cache_dtype=dtype)
    spec = ConvSpec(features=cout, kernel=(1, 1), activation=None)
    assert L.stored_features(spec, cfg) == stored
    st = L.cb_layer_init(spec, (16, 32, 128), cfg)
    assert st.out_cache.shape[-1] == stored
    stem = dataclasses.replace(spec, backend="dense_cached")
    assert L.stored_features(stem, cfg) == cout
    nxt = ConvSpec(features=64)
    assert L.fuse_next_gate(spec, nxt, (16, 32, 128), cfg) == (
        stored == cout)


def test_padded_producer_feeds_cb_and_dense_consumers():
    """A cout-6 "cuda" conv (an 8-channel cache) read by a CB conv, a CB
    pool and a dense 1x1: the same stats as the JAX package's lane-padded
    run, outputs within 5e-6, and the pad channels stay zero."""
    from cbinfer_tpu.config import ConvSpec as JConv
    from cbinfer_tpu.config import PoolSpec as JPool
    from cbinfer_tpu.convert import convert as jconvert
    from cbinfer_tpu.network import init_params as j_init_params
    from cbinfer_tpu_torch.checkpoint import params_from_numpy
    from cbinfer_tpu_torch.config import PoolSpec
    from cbinfer_tpu_torch.convert import convert
    jspecs = [JConv(features=8), JConv(features=6), JConv(features=8),
              JPool(window=(2, 2), stride=(2, 2)), JConv(features=6),
              JConv(features=4, kernel=(1, 1), activation=None)]
    tspecs = [ConvSpec(features=8), ConvSpec(features=6),
              ConvSpec(features=8), PoolSpec(window=(2, 2), stride=(2, 2)),
              ConvSpec(features=6),
              ConvSpec(features=4, kernel=(1, 1), activation=None)]
    shape = (32, 64, 3)
    taus = [0.05] * 6  # one for the head too, which runs dense
    jnet = jconvert(jspecs, shape, JCFG, thresholds=taus, dense_layers=(5,),
                    backend_overrides={0: "dense_cached"})
    tnet = convert(tspecs, shape, TCFG, thresholds=taus, dense_layers=(5,),
                   backend_overrides={0: "dense_cached"})
    jparams = j_init_params(jspecs, shape, jax.random.PRNGKey(4))
    tparams = params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")
    frames = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(
        height=32, width=64, n_sprites=2, sprite_size=8, seed=6)).clip(4)
    jys, jst, jss = jrunner.scan_video(jnet, jparams, jnp.asarray(frames))
    ys, state, stats = scan_video(tnet, tparams, torch.from_numpy(frames))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=5e-6)
    for k in (1, 2, 3, 4):
        for key in jss[k]:
            assert stats[k][key].tolist() == np.asarray(
                jss[k][key]).tolist(), (k, key)
    assert state[1].out_cache.shape[-1] == 8 and state[4].out_cache \
        .shape[-1] == 8
    assert not state[1].out_cache[..., 6:].any()
    np.testing.assert_allclose(
        state[1].out_cache[..., :6].numpy(),
        cache_from_lanes(jst[1].out_cache, 6), atol=5e-6)


# ----------------------------- the small graph -------------------------------


@pytest.fixture(scope="module")
def runs():
    jn, jo = j_pose_graph(width=WIDTH)
    jnet = jgraph.convert_graph_flagship(jn, (H, W, 3), JCFG, output=jo,
                                         thresholds=[TAU] * N_CB,
                                         fuse_detect=True)
    jparams = jgraph.init_graph_params(jn, (H, W, 3),
                                       jax.random.PRNGKey(SEED))
    frames, kps, valid = jvideo.SpriteVideo(
        jvideo.SpriteVideoConfig(**VIDEO)).clip_with_keypoints(T)
    apply = jax.jit(jnet.apply)
    y, st, s = jax.jit(jnet.apply_refresh)(jparams, jnet.init_state(),
                                           jnp.asarray(frames[0]))
    jys, jstates, jstats = [y], [st], [s]
    for t in range(1, T):
        y, st, s = apply(jparams, st, jnp.asarray(frames[t]))
        jys.append(y)
        jstates.append(st)
        jstats.append(s)
    tn, to = pose_graph(width=WIDTH)
    tparams = checkpoint.graph_params_from_numpy(tn, _np_params(jparams),
                                                 device="cpu")
    out = {}
    for name, fuse in (("fused", True), ("unfused", False)):
        tnet = graph.convert_graph_flagship(tn, (H, W, 3), TCFG, output=to,
                                            thresholds=[TAU] * N_CB,
                                            fuse_detect=fuse)
        ys, state, stats = scan_video(tnet, tparams,
                                      torch.from_numpy(frames),
                                      collect_stats=True, refresh_start=True)
        out[name] = dict(net=tnet, ys=ys, state=state, stats=stats)
    return dict(jnet=jnet, jparams=jparams, frames=frames, kps=kps,
                valid=valid, jys=jys, jstates=jstates, jstats=jstats,
                tparams=tparams, nodes=tn, **out)


def test_small_graph_flags_match_and_fuse(runs):
    tnet = runs["fused"]["net"]
    assert _node_dicts(tnet.nodes) == _node_dicts(runs["jnet"].nodes)
    assert [n.name for n in tnet.nodes
            if getattr(n.spec, "fuse_next_detect", False)] == FUSED_720P


def _detect_input(net, states, frames, t, name, shapes):
    """What node ``name``'s detect compared at frame t in the reference
    run (its producers' outputs, concatenated), and its cache before."""
    from cbinfer_tpu.layers import _geometry as j_geometry
    from cbinfer_tpu.layers import _layer_cfg as j_layer_cfg
    from cbinfer_tpu.ops import flat4 as jflat4
    by = {n.name: n for n in net.nodes}
    node = by[name]
    h, w, c = shapes[node.inputs[0]]

    def value(src):
        if src == "input":
            return frames[t].astype(np.float32)
        if by[src].spec.kind == "concat":
            return np.concatenate([value(i) for i in by[src].inputs], -1)
        hs, ws, cs = shapes[src]
        return np.asarray(states[t][src].out_cache,
                          np.float32)[:hs, :ws, :cs]
    # numpy views of the reference's storage (its storage_interior and
    # from_flat4 are slices)
    cache = np.asarray(states[t - 1][name].in_cache, np.float32)
    if node.inputs == ("input",):
        before = jflat4.from_flat4(cache, jflat4.flat4_geom(h, w, c))
    else:
        lcfg = j_layer_cfg(node.spec, net.cfg)
        g = j_geometry(node.spec, (h, w, cache.shape[-1]), lcfg)
        before = cache[g.store_lo_h:g.store_lo_h + g.in_h,
                       g.store_lo_w:g.store_lo_w + g.in_w]
    return value(node.inputs[0]), before[..., :c]


def test_reference_diffs_keep_clear_of_tau(runs):
    """No detect input of the reference run sits within 1.5e-5 of tau,
    the concat's readers included."""
    net, states, frames = runs["jnet"], runs["jstates"], runs["frames"]
    shapes = jgraph.node_out_shapes(net.nodes, (H, W, 3))
    margin = np.inf
    for t in range(1, T):
        for n in net.nodes:
            if n.spec.kind != "conv" or not n.spec.use_cb:
                continue  # forward-hint pools compare nothing
            x, before = _detect_input(net, states, frames, t, n.name, shapes)
            d = np.abs(x - before).max(-1)
            d = d[d > 0]
            if d.size:
                margin = min(margin, float(np.abs(d - TAU).min()))
    assert margin > 1.5e-5, margin


def test_small_graph_stats_identical_to_reference(runs):
    jstats = runs["jstats"]
    names = [n.name for n in runs["nodes"]]
    for which in ("fused", "unfused"):
        tstats = runs[which]["stats"]
        # name-keyed, in topological order
        assert list(tstats) == names and set(jstats[0]) == set(names)
        for name, ts in tstats.items():
            if not jstats[0][name]:
                assert ts == {}, name
                continue
            assert set(ts) == set(STAT_KEYS)
            for key in ts:
                want = [int(np.asarray(s[name][key])) for s in jstats]
                got = [int(v) for v in ts[key].tolist()]
                assert got == want, (which, name, key, got, want)
    st = runs["fused"]["stats"]
    # the chosen consumer of a fused producer reports its tile count; the
    # other reader of bb11 detected for itself over bb11's hint
    assert st["s1_paf_c0"]["detect_tiles"].tolist()[1:] \
        == st["bb11"]["computed_tiles"].tolist()[1:]
    # the concat's readers detect over the OR of its inputs' hints
    assert max(st["s2_paf_c0"]["detect_tiles"].tolist()[1:]) > 0


def test_small_graph_outputs_and_caches_match_reference(runs):
    jys = np.stack([np.asarray(y) for y in runs["jys"]])
    ys = runs["fused"]["ys"].numpy()
    assert ys.shape == (T, H // 8, W // 8, 56)
    np.testing.assert_allclose(ys, jys, atol=5e-6)
    assert metrics.pck_gt(ys, runs["kps"], runs["valid"], 8) \
        == jmetrics.pck_gt(jys, runs["kps"], runs["valid"], 8)
    jstats = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *runs["jstats"])
    net = runs["fused"]["net"]
    assert metrics.effective_flops_view(
        NetView.of(net), runs["fused"]["stats"], 8, 8) \
        == jmetrics.effective_flops_view(
            jnetview.NetView.of(runs["jnet"]), jstats, 8, 8)
    shapes = graph.node_out_shapes(net.nodes, (H, W, 3))
    for n in net.nodes:
        ts, js = runs["fused"]["state"][n.name], runs["jstates"][-1][n.name]
        if ts is None:
            assert js is None, n.name
            continue
        np.testing.assert_allclose(
            ts.out_cache.numpy(),
            cache_from_lanes(js.out_cache, ts.out_cache.shape[-1]),
            atol=5e-6, err_msg=f"{n.name} out cache")
        np.testing.assert_allclose(cache_to_lanes(ts.out_cache.numpy()),
                                   np.asarray(js.out_cache), atol=5e-6,
                                   err_msg=f"{n.name} out cache, padded")
        if n.inputs == ("input",) or ts.in_cache.shape == (1, 1, 1):
            continue
        c = shapes[n.inputs[0]][2]
        assert ts.in_cache.shape[-1] == c
        np.testing.assert_allclose(
            ts.in_cache.numpy(), cache_from_lanes(js.in_cache, c),
            atol=5e-6, err_msg=f"{n.name} in cache")
    # the stage-1 heads' caches are padded to the kernels' channel grid
    assert runs["fused"]["state"]["s1_paf_out"].out_cache.shape[-1] == 40
    assert runs["fused"]["state"]["s1_heat_out"].out_cache.shape[-1] == 20


def test_fused_graph_stream_bit_identical_to_unfused(runs):
    a, b = runs["fused"], runs["unfused"]
    assert torch.equal(a["ys"], b["ys"])
    for name, sa in a["stats"].items():
        for key in sa:
            assert torch.equal(sa[key], b["stats"][name][key]), (name, key)
    for name, sa in a["state"].items():
        if sa is not None:
            sb = b["state"][name]
            assert torch.equal(sa.in_cache, sb.in_cache), name
            assert torch.equal(sa.out_cache, sb.out_cache), name


def test_graph_refresh_equals_dense(runs):
    """A refresh frame recomputes every node densely: the dense path's
    output, and the reference's dense output."""
    net, params = runs["fused"]["net"], runs["tparams"]
    x = torch.from_numpy(runs["frames"][3])
    y_ref, state, stats = net.apply_refresh(params, net.init_state(), x)
    y_dense = net.apply_dense(params, x)
    np.testing.assert_allclose(y_ref.numpy(), y_dense.numpy(), atol=1e-5)
    jd = runs["jnet"].apply_dense(runs["jparams"], jnp.asarray(
        runs["frames"][3]))
    np.testing.assert_allclose(y_dense.numpy(), np.asarray(jd), atol=5e-6)
    assert list(stats) == [n.name for n in net.nodes]
    assert all(s["computed_tiles"] == s["n_tiles"]
               for s in stats.values() if s)


def test_pack_stats_rows_in_topological_order(runs):
    """One frame's packed rows: the CB nodes in topological order, as the
    reference's live stepper packs them inside its dispatch."""
    net = runs["fused"]["net"]
    jframe = runs["jstats"][-1]
    ordered = {n.name: jframe[n.name] for n in runs["jnet"].nodes}
    want = np.asarray(jrunner.pack_stats(ordered))
    # the last frame's counters, out of the stream's stacks
    stats = {name: {k: v[-1] for k, v in s.items()}
             for name, s in runs["fused"]["stats"].items()}
    packed = pack_stats(stats)
    assert packed.shape == (N_CB, 6) and packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), want)
    rows = unpack_stats(packed)
    keys = [r.key for r in NetView.of(net).cb_rows()]
    assert [int(r["computed_tiles"]) for r in rows] == [
        int(stats[k]["computed_tiles"]) for k in keys]


def test_graph_runner_forms_equal_the_eager_loop(runs):
    """scan_video_jit, FrameStepper (each collect_stats form, packed small
    buffers, reset) on the CPU equal scan_video on the graph."""
    net, params = runs["fused"]["net"], runs["tparams"]
    frames = torch.from_numpy(runs["frames"])
    ys, _, stats = scan_video(net, params, frames[:4], refresh_start=True,
                              collect_stats="mean")
    assert list(stats) == [n.name for n in net.nodes]
    run = scan_video_jit(net)
    ys2, st2, stats2 = run(params, frames[:4], net.init_state(),
                           refresh_start=True, collect_stats="mean")
    assert torch.equal(ys, ys2)
    for name, s in stats.items():
        for key in s:
            assert torch.equal(s[key], stats2[name][key])
    for form in (True, "packed"):
        stepper = FrameStepper(net, params, collect_stats=form,
                               pack_small_buffers=4096)
        assert stepper._n_packed > 0
        outs = [stepper(f) for f in frames[:4]]
        assert torch.equal(torch.stack([y for y, _ in outs]), ys)
        last = outs[-1][1]
        if form == "packed":
            assert last.shape == (N_CB, 6)
        else:
            assert list(last) == list(stats)
        stepper.reset()
        assert torch.equal(stepper(frames[0])[0], ys[0])
    chunked = FrameStepper(net, params)
    yc, sc = chunked.step_chunk(frames[:4])
    assert torch.equal(yc, ys) and list(sc) == list(stats)
    table = profiling.summarize_stats(stats, net.nodes)
    assert len(table.splitlines()) == 1 + len(net.nodes)
    assert "s2_cat" in table and "ConcatSpec" in table


def test_graph_empty_clip_and_checkpoint(runs, tmp_path):
    """An empty clip returns name-keyed (0,) stacks and (0, h, w, 56)
    outputs; checkpoint.save / restore round-trips the name-keyed state,
    in place too."""
    net, params = runs["fused"]["net"], runs["tparams"]
    state = runs["fused"]["state"]
    ys, _, stats = scan_video(net, params, torch.zeros((0, H, W, 3)),
                              state)
    assert ys.shape == (0, H // 8, W // 8, 56) and ys.dtype == torch.float32
    assert list(stats) == [n.name for n in net.nodes]
    assert stats["bb0"]["computed_tiles"].shape == (0,)
    assert stats["s2_cat"] == {}
    path = str(tmp_path / "ck.pt")
    checkpoint.save(path, params, state, extra={"frame": T})
    got = checkpoint.restore(path, like={"params": params,
                                         "state": net.init_state()})
    assert got["extra"] == {"frame": T}
    for name, s in state.items():
        if s is None:
            assert got["state"][name] is None
            continue
        assert torch.equal(got["state"][name].in_cache, s.in_cache)
        assert torch.equal(got["state"][name].out_cache, s.out_cache)
    live = net.init_state()
    kept = {k: v.out_cache for k, v in live.items() if v is not None}
    checkpoint.restore(path, like={"state": live}, in_place=True)
    for k, t in kept.items():
        assert live[k].out_cache is t
        assert torch.equal(t, state[k].out_cache)


def test_cpu_graph_runs_launch_no_kernel(runs):
    reset_launches()
    net = runs["fused"]["net"]
    scan_video(net, runs["tparams"], torch.from_numpy(runs["frames"][:2]),
               refresh_start=True)
    assert set(launches()) >= {"delta_conv_detect", "detect_sparse",
                               "delta_pool", "stem_conv"}
    assert not any(launches().values())


def _graded_clip(n, seed=11):
    return tvideo.SpriteVideo(tvideo.SpriteVideoConfig(
        **{**VIDEO, "seed": seed, "noise_std": 0.002},
        **tvideo.workload_video_kwargs("pose_graph"))).clip(n)


def test_trained_graph_fused_equals_unfused_on_graded_video():
    """The trained pose_graph through zoo.load at 64x128 in bf16 (the
    stage-1 heads padded 38 -> 40 and 18 -> 24), the tuned taus, the
    graded dynamics, 6 frames with a refresh every 3: fused and unfused
    bit-identical, sparse on steady frames."""
    cfg = dataclasses.replace(TCFG, compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    clip = torch.from_numpy(_graded_clip(6))
    res = []
    for policy in (True, False):
        wl = zoo.load("pose_graph", (H, W, 3), cfg, apply_policy=policy)
        res.append(scan_video(wl.net, wl.params, clip, thresholds=wl.taus,
                              refresh_every=3) + (wl,))
    (ya, sa, ta, wa), (yb, sb, tb, wb) = res
    assert wa.fuse_detect and not wb.fuse_detect
    assert sa["s1_heat_out"].out_cache.shape[-1] == 24
    assert torch.equal(ya, yb) and bool(torch.isfinite(ya.float()).all())
    for name, a in ta.items():
        for key in a:
            assert torch.equal(a[key], tb[name][key]), (name, key)
    for name, a in sa.items():
        if a is not None:
            assert torch.equal(a.in_cache, sb[name].in_cache)
            assert torch.equal(a.out_cache, sb[name].out_cache)
    full = ta["bb1"]["computed_tiles"] == ta["bb1"]["n_tiles"]
    assert full.tolist() == [True, False, False] * 2


def test_graph_state_tensors_keep_their_storage(runs):
    """Every tensor of the name-keyed state keeps its address across
    refresh and steady frames, FrameStepper's two entries and reset(): what
    a captured CUDA graph of the DAG relies on (the concat is a new tensor
    a frame, no state)."""
    from cbinfer_tpu_torch.runner import _tensors
    net, params = runs["fused"]["net"], runs["tparams"]
    clip = torch.from_numpy(runs["frames"][:5])

    def ptrs(state):
        return [t.data_ptr() for t in _tensors(state)]
    state = net.init_state()
    before = ptrs(state)
    scan_video(net, params, clip[:3], state, refresh_start=True)
    scan_video(net, params, clip[3:], state)
    assert ptrs(state) == before
    stepper = FrameStepper(net, params, refresh_every=3)
    before = ptrs(stepper.state)
    for t in range(3):
        stepper(clip[t])
    stepper.step_chunk(clip[3:5])
    assert ptrs(stepper.state) == before
    stepper.reset()
    assert ptrs(stepper.state) == before
    for a, b in zip(_tensors(stepper.state), _tensors(net.init_state())):
        assert torch.equal(a, b)
