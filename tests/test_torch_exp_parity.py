"""The last twins (``scripts/torch_exp_*.py``, ``torch_profile_trace.py``)
and the pieces of the port they need held against the reference on the
CPU, where the numbers do not depend on the hardware:

- the tau A/B's per-vector mean changed tiles: exact, against
  ``scripts/exp_tau_ab.py`` itself at 64x128 (T 4, one rep, a w8 scene
  net, its file write redirected);
- the forwarding variants' ``flop_reduction`` on seg and pose: within
  1e-6, against ``scripts/exp_forward.py`` itself at 64x128 (w8 nets, its
  clock seed fixed, its rounding and file write bypassed);
- the fused A/B's fused layers: equal to those of the reference script's
  ``strip_fused``/``with_fused`` (pose) and of its DAG build (pose_graph)
  at 720p;
- the trace's ``self_times`` and kernel classifier: equal to
  ``scripts/profile_trace.py``'s on a synthetic nested trace, its stage
  scope table equal to the reference's; and the stage scopes
  (``layers.stage``) in a CPU profile of one frame;
- ``POINTWISE_DOT``: the CB outputs under each value equal to the
  reference's under the same value within float32 tolerance, the dense
  path unchanged by the flag;
- the tile conv's sub-tile launch (``split_tiles``): the plain version
  over the sub-tiles equal to it over the coarse tiles.

The reference runs on its CPU backend (``jnp``, float32); the port on its
twin of it (``"torch"``, float32), the reference's weights carried over.
"""

import ast
import dataclasses
import importlib.util
import inspect
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_cfg():
    from cbinfer_tpu_torch import zoo
    return dataclasses.replace(zoo.default_pipeline_config("cpu"),
                               backend="torch")


def _redirect_writes(monkeypatch, mod, tmp_path, name):
    """``mod``'s ``open`` with writes to ``name`` sent to ``tmp_path``;
    returns the redirected path."""
    target = tmp_path / name

    def fake_open(path, mode="r", *a, **k):
        if "w" in mode:
            assert str(path).endswith(name), path
            return open(target, mode, *a, **k)
        return open(path, mode, *a, **k)
    monkeypatch.setattr(mod, "open", fake_open, raising=False)
    return target


def test_tau_ab_changed_tiles_equal_the_reference(tmp_path, monkeypatch):
    import jax
    from cbinfer_tpu import zoo as jzoo

    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.checkpoint import params_from_numpy

    ref = _load("exp_tau_ab")
    monkeypatch.setattr(ref, "H", H)
    monkeypatch.setattr(ref, "W", W)
    monkeypatch.setattr(ref, "CHUNKS", 3)
    monkeypatch.setitem(jzoo.REGISTRY, "scene", dataclasses.replace(
        jzoo.REGISTRY["scene"], width=8))
    loaded = {}

    def load(*a, **k):
        loaded["wl"] = jzoo.load(*a, **k)
        return loaded["wl"]
    monkeypatch.setattr(ref, "zoo", types.SimpleNamespace(load=load))
    out = _redirect_writes(monkeypatch, ref, tmp_path, "EXP_tau_ab.json")
    monkeypatch.setattr(sys, "argv", ["exp_tau_ab.py", "scene", "4", "1"])
    ref.main()
    want = json.loads(out.read_text())["rows"]
    jwl = loaded["wl"]
    assert jwl.weights.startswith("random")

    wl = zoo.load("scene", (H, W, 3), _torch_cfg(), width=8)
    wl = dataclasses.replace(wl, params=params_from_numpy(
        wl.specs, jax.tree.map(np.asarray, jwl.params), device="cpu"))
    got = _load("torch_exp_tau_ab").tau_ab(wl, "scene", H, W, 4, 1, 3,
                                           log=lambda m: None)["rows"]
    assert [r["taus"] for r in got] == [r["taus"] for r in want]
    for g, w in zip(got, want):
        assert g["thresholds"] == pytest.approx(w["thresholds"])
        assert g["mean_changed_tiles_per_layer"] == \
            w["mean_changed_tiles_per_layer"], g["taus"]
    # not vacuous: the vectors see different tiles
    assert len({json.dumps(r["mean_changed_tiles_per_layer"])
                for r in got}) > 1


@pytest.mark.parametrize("name", ["seg", "pose"])
def test_forward_flop_reduction_equals_the_reference(name, tmp_path,
                                                     monkeypatch):
    import jax
    import cbinfer_tpu.models as jmodels
    import cbinfer_tpu.network as jnetwork

    from cbinfer_tpu_torch.checkpoint import params_from_numpy

    ref = _load("exp_forward")
    get_model, init_params = jmodels.get_model, jnetwork.init_params
    made = {}

    def small_model(n, **kw):
        return get_model(n, **{**kw, "width": 8})

    def init(*a, **k):
        made["params"] = init_params(*a, **k)
        return made["params"]
    monkeypatch.setattr(jmodels, "get_model", small_model)
    monkeypatch.setattr(jnetwork, "init_params", init)
    seed = 4242
    monkeypatch.setattr(ref, "time", types.SimpleNamespace(
        time=lambda: seed / 1e3, perf_counter=__import__("time")
        .perf_counter))
    monkeypatch.setattr(ref, "round", lambda x, n=None: x, raising=False)
    out = _redirect_writes(monkeypatch, ref, tmp_path, "EXP_forward.json")
    monkeypatch.setattr(sys, "argv", ["exp_forward.py", name, str(H),
                                      str(W)])
    ref.main()
    want = json.loads(out.read_text())[f"{name}_{H}x{W}"]

    mod = _load("torch_exp_forward")
    from cbinfer_tpu_torch import zoo
    specs = zoo.load(name, (H, W, 3), _torch_cfg(), width=8).specs
    params = params_from_numpy(specs, jax.tree.map(np.asarray,
                                                   made["params"]),
                               device="cpu")
    got = mod.forward(name, H, W, 32, 2, seed, "cpu", 8, _torch_cfg(),
                      params, log=lambda m: None)["variants"]
    assert set(got) == set(want) == {"base", "fwd_deep", "fwd_all"}
    for mode in want:
        assert got[mode]["flop_reduction"] == pytest.approx(
            want[mode]["flop_reduction"], abs=1e-6), mode
    assert got["fwd_all"]["flop_reduction"] < got["base"]["flop_reduction"]


@pytest.mark.parametrize("name", ["pose", "pose_graph"])
def test_fused_layers_equal_the_reference(name):
    from cbinfer_tpu import zoo as jzoo
    from cbinfer_tpu.config import PipelineConfig as JCfg
    from cbinfer_tpu.config import TileConfig as JTile

    from cbinfer_tpu_torch import zoo

    ref, mod = _load("exp_fused_ab"), _load("torch_exp_fused_ab")
    shape = (720, 1280, 3)
    jcfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    jwl = jzoo.load(name, shape, jcfg)
    if name == "pose_graph":
        from cbinfer_tpu.graph import convert_graph_flagship
        jnet = convert_graph_flagship(list(jwl.specs), shape, jcfg,
                                      output=jwl.net.output,
                                      fuse_detect=True)
        want = [n.name for n in jnet.nodes
                if getattr(n.spec, "fuse_next_detect", False)]
    else:
        jnet = ref.with_fused(ref.strip_fused(jwl.net))
        want = [i for i, s in enumerate(jnet.specs)
                if getattr(s, "fuse_next_detect", False)]
    wl = zoo.load(name, shape, zoo.default_pipeline_config("cpu"))
    net_u, net_f = mod.arms_of(wl, name, *shape[:2])
    assert mod.fused_layers(net_f) == want and len(want) > 10
    assert mod.fused_layers(net_u) == []
    assert ref.count_fused(jnet) == len(want)


def _synthetic_trace():
    """(name, ts, dur, pid, tid) events on two tracks: wrappers around
    nested kernels, siblings, and an event that starts as its parent
    ends."""
    return [
        ("while.1", 0.0, 100.0, 1, 1), ("_sparse_kernel.3", 5.0, 10.0, 1, 1),
        ("fusion.7", 15.0, 30.0, 1, 1), ("copy.2", 20.0, 5.0, 1, 1),
        ("_delta_conv_kernel.4", 50.0, 40.0, 1, 1),
        ("_fused_pool_kernel.9", 100.0, 8.0, 1, 1),
        ("fusion.8", 0.0, 12.0, 1, 2), ("_delta_pool_kernel.1", 2.0, 4.0, 1,
                                        2),
        ("convolution.3", 12.0, 6.0, 1, 2)]


def test_self_times_and_classifier_equal_the_reference():
    ref, mod = _load("profile_trace"), _load("torch_profile_trace")
    evs = _synthetic_trace()
    got = mod.self_times(evs)
    assert sorted(got) == sorted(ref.self_times(evs))
    assert sum(d for _, d in got) == pytest.approx(100.0 + 8.0 + 18.0)
    # the reference's kernels by name against the port's same kernels
    pairs = {"_sparse_kernel.3": "detect_sparse",
             "_delta_conv_kernel.4": "delta_conv",
             "_delta_pool_kernel.1": "delta_pool",
             "_fused_pool_kernel.9": "detect_pool_fused"}
    for jname, kname in pairs.items():
        assert ref.classify(jname) == mod.KERNEL_STAGE[kname], jname
    # the port's kernel functions are named after their sources
    assert mod.kernel_stage("void detect_sparse_kernel<__nv_bfloat16>("
                            "Args)") == "detect"
    assert mod.kernel_stage("delta_conv_detect_bf16_kernel") == "delta_conv"
    assert mod.kernel_stage("void (anonymous namespace)::delta_conv_wg_"
                            "kernel<64>(__nv_bfloat16 const*, int)") \
        == "delta_conv"
    assert mod.kernel_stage("void cub::DeviceRadixSortOnesweepKernel<>"
                            ) == "compact"
    assert mod.kernel_stage("void at::native::radixSortKVInPlace<-2, -1, "
                            "32, 32, int, long>(Args)") == "compact"
    assert mod.kernel_stage("vectorized_elementwise_kernel") is None
    # the scope table: the reference's (the literal in its main) bins its
    # named scopes as the port's SCOPE_STAGE bins the same stage scopes;
    # its "_pool/" entry keys on layer scopes, which the port does not
    # open (pool kernels are classified by name)
    table = next(
        ast.literal_eval(node.iter) for node in ast.walk(ast.parse(
            inspect.getsource(ref.main)))
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple)
        and len(node.iter.elts) > 5)
    scopes = {s.strip("/"): st for s, st in table if s.startswith("/")}
    assert scopes == mod.SCOPE_STAGE


def test_trace_attributes_kernels_by_launch_scope():
    """A synthetic device trace: kernels named by the port's registry go
    to their stage, others to the innermost stage scope around their
    launch, the rest to glue; stage sums equal busy time."""
    mod = _load("torch_profile_trace")

    def x(cat, name, ts, dur, pid, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": pid, "tid": tid, "args": args}
    host = dict(pid=10, tid=11)
    ev = [x("user_annotation", "detect", 0, 10, **host),
          x("user_annotation", "compact", 10, 10, **host),
          x("user_annotation", "delta_kernel", 20, 10, **host),
          x("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1, **host),
          x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2, **host),
          x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=3, **host),
          x("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=4, **host),
          x("kernel", "detect_sparse_kernel", 100, 5, 0, 7, correlation=1),
          x("kernel", "cub::DeviceRadixSortOnesweepKernel", 105, 3, 0, 7,
            correlation=2),
          x("kernel", "elementwise_kernel", 108, 2, 0, 7, correlation=3),
          x("kernel", "elementwise_kernel", 110, 4, 0, 7, correlation=4)]
    row = mod.stage_rows(ev, 1, True, True)
    assert row["per_frame_us"] == {"detect": 5.0, "compact": 3.0,
                                   "delta_conv": 2.0, "glue": 4.0}
    assert row["stage_sum_over_busy"] == pytest.approx(1.0)
    graphed = mod.stage_rows(ev, 1, False, True)
    assert graphed["per_frame_us"] == {"detect": 5.0, "compact": 3.0,
                                       "glue": 6.0}


def test_stage_scopes_show_in_a_cpu_profile():
    """One frame of the w8 scene flagship on the CPU (the kernels' plain
    versions) under torch.profiler: the stem's and the convs' stage
    scopes; none is opened when no profiler records."""
    from cbinfer_tpu_torch import layers, zoo
    from cbinfer_tpu_torch.runner import scan_video

    wl = zoo.load("scene", (H, W, 3), zoo.default_pipeline_config("cpu"),
                  width=8)
    frames = torch.rand((2, H, W, 3))
    state = wl.net.init_state()
    scan_video(wl.net, wl.params, frames[:1], state, thresholds=wl.taus)
    assert isinstance(layers.stage("detect"), type(layers._NO_SCOPE))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scan_video(wl.net, wl.params, frames[1:], state, thresholds=wl.taus)
    names = {e.key for e in prof.key_averages()}
    assert {"detect", "compact", "delta_kernel", "patch_conv"} <= names


def test_pointwise_gate_equals_the_reference():
    """The w8 scene net at 64x128 on both CPU backends over 3 frames: CB
    logits under POINTWISE_DOT True and False each within float32
    tolerance of the reference's under the same value; the dense path
    the same under both."""
    import jax
    import jax.numpy as jnp
    from cbinfer_tpu import network as jnetwork
    from cbinfer_tpu.config import PipelineConfig as JCfg
    from cbinfer_tpu.config import TileConfig as JTile
    from cbinfer_tpu.convert import convert_flagship as j_convert
    from cbinfer_tpu.models import get_model as j_get_model
    from cbinfer_tpu.runner import scan_video as j_scan
    from cbinfer_tpu.video import SpriteVideo, SpriteVideoConfig

    from cbinfer_tpu_torch import network
    from cbinfer_tpu_torch.checkpoint import params_from_numpy
    from cbinfer_tpu_torch.convert import convert_flagship
    from cbinfer_tpu_torch.models import get_model
    from cbinfer_tpu_torch.runner import scan_video

    jspecs = j_get_model("scene", num_classes=8, width=8)
    jnet = j_convert(jspecs, (H, W, 3), JCfg(tile=JTile(8, 8, 0.375),
                                             backend="jnp"))
    jparams = jnetwork.init_params(jspecs, (H, W, 3), jax.random.PRNGKey(1))
    specs = get_model("scene", num_classes=8, width=8)
    net = convert_flagship(specs, (H, W, 3), _torch_cfg())
    params = params_from_numpy(specs, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    clip = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=4, sprite_size=16, speed=4.0,
        noise_std=0.002, seed=7)).clip(3)
    taus = [0.05] * 6
    outs, dense = {}, {}
    j_orig, t_orig = jnetwork.POINTWISE_DOT, network.POINTWISE_DOT
    try:
        for dot in (False, True):
            jnetwork.POINTWISE_DOT = network.POINTWISE_DOT = dot
            jy, _, _ = j_scan(jnet, jparams, jnp.asarray(clip),
                              thresholds=jnp.asarray(taus, jnp.float32),
                              refresh_start=True)
            ty, _, _ = scan_video(net, params, torch.from_numpy(clip),
                                  thresholds=taus, refresh_start=True)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                       rtol=1e-4, atol=1e-4)
            outs[dot] = ty
            dense[dot] = net.apply_dense(params, torch.from_numpy(clip[1]))
    finally:
        jnetwork.POINTWISE_DOT, network.POINTWISE_DOT = j_orig, t_orig
    assert network.POINTWISE_DOT is True
    assert torch.equal(dense[False], dense[True])
    torch.testing.assert_close(outs[False], outs[True], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("geom", [
    (40, 72, 8, 16, 3, 1, 1, 8, 16), (40, 72, 8, 16, 3, 1, 1, 16, 16),
    (37, 70, 8, 8, 3, 2, 1, 16, 32), (40, 72, 8, 16, 3, 1, 2, 8, 32),
    (12, 40, 8, 8, 3, 1, 1, 16, 16), (24, 40, 8, 8, 1, 1, 1, 16, 16)])
def test_split_tiles_computes_the_coarse_tiles(geom):
    """Tiles of more than 64 output pixels are launched as sub-tiles of at
    most 8x8 (``ops/kernels/delta_conv.split_tiles``): the plain version
    over the sub-tile list writes the out cache of the coarse list, bit
    for bit, half the tiles listed and the rest untouched."""
    from cbinfer_tpu_torch.ops.delta_conv import make_storage
    from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
    from cbinfer_tpu_torch.ops.kernels import delta_conv as K

    Hh, Ww, cin, cout, k, dil, stride, th, tw = geom
    gen = torch.Generator().manual_seed(sum(geom))
    g = conv_tile_geometry((Hh, Ww, cin), (k, k), (stride, stride),
                           (dil, dil), "SAME", th, tw)
    xp = make_storage(g, 0.0, 0.0, torch.float32, "cpu")
    xp.normal_(generator=gen)
    w = torch.randn(k, k, cin, cout, generator=gen)
    b = torch.randn(cout, generator=gen)
    n = g.n_tiles
    ids = torch.randperm(n, generator=gen)[:max(1, n // 2)].int()
    idx = torch.full((n,), n, dtype=torch.int32)
    idx[:len(ids)] = ids
    count = torch.tensor(len(ids), dtype=torch.int32)
    out0 = torch.randn(g.out_h_pad, g.out_w_pad, cout, generator=gen)
    want = K.delta_conv_plain(xp, idx, w, b, out0.clone(), g, "relu",
                              count=count)
    sidx, scount, gs = K.split_tiles(idx, count, g)
    assert gs.th * gs.tw <= K.TILE_PIXELS
    assert (gs.out_h_pad, gs.out_w_pad, gs.store_shape) == \
        (g.out_h_pad, g.out_w_pad, g.store_shape)
    assert int(scount) == len(ids) * (g.th // gs.th) * (g.tw // gs.tw)
    got = K.delta_conv_plain(xp, sidx, w, b, out0.clone(), gs, "relu",
                             count=scount)
    assert torch.equal(got, want)
    assert not torch.equal(want, out0)
