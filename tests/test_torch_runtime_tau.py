"""Thresholds at run time: a float32 tensor of taus gives what host floats
give, bit for bit, at the plain versions of the four detecting kernels
(B1, B4, B6, B7), through whole nets and the one-dispatch runners, and
against the reference's jitted scan with traced thresholds; the tuner's
runner keeps one state per clip shape and resets it in place."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import runner as jrunner
from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.convert import convert as jconvert
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.video import SpriteVideo as JSpriteVideo
from cbinfer_tpu.video import SpriteVideoConfig as JSpriteVideoConfig

from cbinfer_tpu_torch import runner, tuner
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, PoolSpec
from cbinfer_tpu_torch.config import TileConfig
from cbinfer_tpu_torch.convert import convert
from cbinfer_tpu_torch.graph import convert_graph_flagship, init_graph_params
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.models.pose import pose_graph
from cbinfer_tpu_torch.netview import NetView
from cbinfer_tpu_torch.network import init_params
from cbinfer_tpu_torch.ops import detect as detect_ops
from cbinfer_tpu_torch.ops.delta_conv import make_storage, storage_interior
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry
from cbinfer_tpu_torch.ops.kernels import delta_conv_detect as KF
from cbinfer_tpu_torch.ops.kernels import detect_full as KDF
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD
from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD
from cbinfer_tpu_torch.runner import scan_video, scan_video_jit
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import build_net  # noqa: E402  (the paths' converters)

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: these tests run beside other
    test processes, where a small CPU op's worker threads mostly wait for
    one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# a tau that float32 rounds (0.1), one that a host float compare would
# place differently from float32 (the float32 neighbour of 0.3), a
# negative one (every pixel) and one above every difference (none)
TAUS = (0.1, float(np.nextafter(np.float32(0.3), np.float32(1.0))), -1.0,
        0.05, 1e9)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _tensor(tau):
    return torch.tensor(tau, dtype=torch.float32)


def _inputs(seed, H, W, C, dtype, g):
    """A frame and a padded storage that differ by steps near the taus."""
    rng = np.random.default_rng(seed)
    prev = rng.standard_normal((H, W, C)).astype(np.float32)
    step = rng.choice([0.0, 0.05, 0.1, 0.3, 0.31], size=(H, W, 1))
    x = torch.from_numpy(prev + step.astype(np.float32)).to(dtype)
    st = make_storage(g, 0.0, 0.0, dtype, "cpu")
    storage_interior(st, g).copy_(torch.from_numpy(prev).to(dtype))
    return x, st


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_detect_sparse_and_full_take_tensor_taus(tau, dtype):
    """B1 and B7 (their wrappers on CPU tensors: the plain versions)."""
    H, W, C = 20, 32, 6
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 8)
    x, st = _inputs(0, H, W, C, dtype, g)
    idx = torch.tensor([0, 2, 5, 9, 11], dtype=torch.int32)
    count = torch.tensor(4, dtype=torch.int32)
    _same(KD.detect_sparse(x, st.clone(), tau, idx, count, g),
          KD.detect_sparse(x, st.clone(), _tensor(tau), idx, count, g))
    _same(KDF.detect_full(x, st.clone(), tau, g),
          KDF.detect_full(x, st.clone(), _tensor(tau), g))


@pytest.mark.parametrize("tau", TAUS)
def test_stem_detect_takes_tensor_taus(tau):
    """B4: the unrounded float32 frame against a bf16 stem cache."""
    H, W, C = 16, 32, 3
    g = conv_tile_geometry((H, W, C), (3, 3), (1, 1), (1, 1), "SAME", 8, 32)
    x, st = _inputs(1, H, W, C, torch.bfloat16, g)
    x = x.float() + 0.001
    _same(KSD.stem_detect(x, st.clone(), tau, g),
          KSD.stem_detect(x, st.clone(), _tensor(tau), g))


@pytest.mark.parametrize("tau", TAUS)
def test_delta_conv_detect_takes_a_tensor_tau2(tau):
    """B6: the consumer's tau2 as a tensor."""
    H, W, cin, cout = 16, 24, 8, 8
    g = conv_tile_geometry((H, W, cin), (3, 3), (1, 1), (1, 1), "SAME",
                           8, 8)
    g2 = conv_tile_geometry((H, W, cout), (3, 3), (1, 1), (1, 1), "SAME",
                            8, 8)
    rng = np.random.default_rng(2)
    xp = make_storage(g, 0.0, 0.0, torch.float32, "cpu")
    storage_interior(xp, g).copy_(torch.from_numpy(
        rng.standard_normal((H, W, cin)).astype(np.float32)))
    w = torch.from_numpy(rng.standard_normal((3, 3, cin, cout))
                         .astype(np.float32) * 0.2)
    b = torch.zeros(cout)
    out0 = torch.from_numpy(rng.standard_normal(
        (g.out_h_pad, g.out_w_pad, cout)).astype(np.float32))
    nc0 = make_storage(g2, 0.0, 0.0, torch.float32, "cpu")
    storage_interior(nc0, g2).copy_(out0[:H, :W] + torch.from_numpy(
        rng.choice([0.0, 0.1, 0.3], size=(H, W, 1)).astype(np.float32)))
    idx = torch.arange(g.n_tiles, dtype=torch.int32)
    count = torch.tensor(4, dtype=torch.int32)

    def run(t):
        return KF.delta_conv_detect(xp, idx, w, b, out0.clone(), g, "relu",
                                    torch.float32, nc0.clone(), t, g2,
                                    count=count)
    _same(run(tau), run(_tensor(tau)))


def test_tau_helpers():
    """tau32 passes a float32 tensor through and rounds the rest; tau_on
    hands the kernels a tensor; tau_list splits a vector into views."""
    t = torch.tensor([0.1, 0.2], dtype=torch.float32)
    assert detect_ops.tau32(0.1) == float(np.float32(0.1))
    assert detect_ops.tau32(t[0]) is not None
    assert detect_ops.tau32(t[0]).data_ptr() == t.data_ptr()
    assert detect_ops.tau32(torch.tensor(0.1, dtype=torch.float64)).dtype \
        == torch.float32
    views = detect_ops.tau_list(t, 2)
    assert [v.data_ptr() for v in views] == [t.data_ptr(),
                                             t.data_ptr() + 4]
    assert detect_ops.tau_list(np.float32([0.1, 0.2]), 2) == \
        [float(np.float32(0.1)), float(np.float32(0.2))]
    with pytest.raises(ValueError):
        detect_ops.tau_list(t, 3)
    with pytest.raises(ValueError):
        detect_ops.tau_list(t.view(1, 2), 2)
    c = detect_ops.tau_on(0.1, "cpu")
    assert c.dtype == torch.float32 and c.ndim == 0
    assert detect_ops.tau_on(0.1, "cpu") is c  # made once
    assert detect_ops.tau_on(t[1], "cpu") is not None
    with pytest.raises(ValueError):
        detect_ops.tau_on(torch.tensor(0.1, dtype=torch.float64), "cpu")


# ------------------------------ whole nets ----------------------------------


def _net(kind, path=None):
    """A w8 (scene: w16) net at 64x128 on the CPU, float32, with a clip."""
    h, w = 64, 128
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    if kind == "pose_graph":
        nodes, out = pose_graph(width=8)
        net = convert_graph_flagship(nodes, (h, w, 3), cfg, output=out,
                                     fuse_detect=True)
        params = init_graph_params(nodes, (h, w, 3), seed=3, device="cpu")
    else:
        specs = (get_model("pose", width=8) if kind == "pose"
                 else get_model("scene", num_classes=8, width=16))
        net = build_net(path or kind, specs, (h, w, 3), cfg)
        params = init_params(specs, (h, w, 3), seed=3, device="cpu")
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=12, seed=3,
        distinct_classes=kind.startswith("pose"))).clip(5))
    return net, params, clip


def _vectors(n):
    """Three tau vectors: flat, halved, and alternating up and down."""
    return [[0.05] * n, [0.025] * n,
            [0.1 if i % 2 else 0.0125 for i in range(n)]]


def _same_runs(a, b):
    (ya, sa, ta), (yb, sb, tb) = a, b
    assert torch.equal(ya, yb)
    assert torch.equal(runner.pack_stats(ta), runner.pack_stats(tb))
    for x, y in zip(runner._tensors(sa), runner._tensors(sb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind,path", [("scene", "flagship"),
                                       ("scene", "hintless"),
                                       ("pose", "pose"),
                                       ("pose_graph", None)])
def test_nets_take_tensor_taus(kind, path):
    """scan_video with a float32 vector equals it with the floats; the
    one-dispatch runner takes each vector in turn into its static taus."""
    net, params, clip = _net(kind, path)
    n = len(NetView.of(net).cb_rows())
    run = scan_video_jit(net)
    state = net.init_state()
    for v in _vectors(n):
        fl = scan_video(net, params, clip, net.init_state(), thresholds=v)
        tv = scan_video(net, params, clip, net.init_state(),
                        thresholds=torch.tensor(v, dtype=torch.float32))
        _same_runs(fl, tv)
        for dst, src in zip(runner._tensors(state),
                            runner._tensors(net.init_state())):
            dst.copy_(src)
        _same_runs(fl, run(params, clip, state, thresholds=v))


def test_frame_stepper_holds_its_taus_as_a_tensor():
    net, params, clip = _net("scene", "flagship")
    n = len(NetView.of(net).cb_rows())
    v = _vectors(n)[2]
    stepper = runner.FrameStepper(net, params, thresholds=v,
                                  collect_stats=True)
    assert isinstance(stepper._taus, torch.Tensor)
    assert stepper._taus.dtype == torch.float32
    ys = torch.stack([stepper(f)[0] for f in clip])
    want = scan_video(net, params, clip, net.init_state(), thresholds=v,
                      refresh_start=True)[0]
    assert torch.equal(ys, want)


# ------------------------ against the reference ------------------------------


H, W = 32, 48


def _ref_specs(conv, pool):
    return [conv(features=8, threshold=0.02), pool(threshold=0.02),
            conv(features=8, threshold=0.02),
            conv(features=5, kernel=(1, 1), activation=None,
                 threshold=0.02)]


def test_tensor_taus_equal_the_reference_traced_taus():
    """The reference jits its scan once with the thresholds traced; the
    port's one-dispatch runner takes them as a tensor. At three vectors,
    outputs within the float32 bound and counters equal."""
    jspecs = _ref_specs(JConv, JPool)
    jnet = jconvert(jspecs, (H, W, 3), JCfg(tile=JTile(tile_h=4, tile_w=4)))
    jparams = j_init_params(jspecs, (H, W, 3), jax.random.PRNGKey(1))
    tnet = convert(_ref_specs(ConvSpec, PoolSpec), (H, W, 3),
                   PipelineConfig(tile=TileConfig(4, 4), device="cpu"))
    tparams = params_from_numpy(
        tnet.specs, [None if p is None else (np.asarray(p[0]),
                                             np.asarray(p[1]))
                     for p in jparams], device="cpu")
    clip = JSpriteVideo(JSpriteVideoConfig(height=H, width=W,
                                           seed=5)).clip(6)
    jrun = jax.jit(lambda fr, th: jrunner.scan_video(jnet, jparams, fr,
                                                     thresholds=th))
    run = scan_video_jit(tnet)
    for v in ([0.02, 0.02, 0.02, 0.02], [0.0, 0.05, 0.01, 0.3],
              [0.1, 0.1, -1.0, 0.0]):
        jy, _, jstats = jrun(jnp.asarray(clip), jnp.asarray(v, jnp.float32))
        ty, _, tstats = run(tparams, torch.from_numpy(clip),
                            tnet.init_state(),
                            thresholds=torch.tensor(v, dtype=torch.float32))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
        for k, (ts, js) in enumerate(zip(tstats, jstats)):
            assert set(ts) == set(js), k
            for key in js:
                np.testing.assert_array_equal(
                    ts[key].numpy(), np.asarray(js[key]),
                    err_msg=f"layer {k} {key}")
    assert jrun._cache_size() == 1  # one program for every vector


# ------------------------------ the tuner -----------------------------------


@pytest.mark.parametrize("refresh_every", [None, 4])
def test_tuner_runner_resets_one_state_per_shape(refresh_every):
    """The tuner's runner: each scan equals a fresh eager scan at its taus,
    in any order of vectors, on one state per clip shape whose tensors
    keep their storage (what its graph on the card is bound to)."""
    net, params, clip = _net("scene", "flagship")
    n = len(NetView.of(net).cb_rows())
    vectors = _vectors(n)
    run = tuner._make_runner(net, params, refresh_every)
    ptrs = None
    for v in (vectors[0], vectors[1], vectors[2], vectors[0]):
        ys, stats = run(clip, np.asarray(v, np.float32))
        want = scan_video(net, params, clip, net.init_state(),
                          thresholds=v, refresh_every=refresh_every)
        assert torch.equal(ys, want[0])
        assert torch.equal(runner.pack_stats(stats),
                           runner.pack_stats(want[2]))
        (state, _, _), = run.states.values()
        now = [t.data_ptr() for t in runner._tensors(state)]
        assert ptrs is None or now == ptrs
        ptrs = now
    ys, _ = run(clip[:4], np.asarray(vectors[1], np.float32))
    assert len(run.states) == 2  # a second clip shape
    assert torch.equal(ys, scan_video(net, params, clip[:4],
                                      net.init_state(), thresholds=vectors[1],
                                      refresh_every=refresh_every)[0])



def test_tuner_on_one_state_selects_the_reference_taus(monkeypatch):
    """tune through the runner above (one state for the two calibration
    clips, reset in place, taus written into one vector) selects what the
    reference's tune selects, its jitted scan taking traced thresholds:
    test_torch_tuner's refresh case, with the runner recorded."""
    import functools
    from cbinfer_tpu import convert as jconvert_mod
    from cbinfer_tpu import metrics as jmetrics
    from cbinfer_tpu import tuner as jtuner
    from cbinfer_tpu.models import get_model as jget_model
    from cbinfer_tpu_torch import metrics
    from cbinfer_tpu_torch.convert import convert_flagship
    h, w, classes = 32, 64, 5
    jcfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    jspecs = jget_model("scene_tiny", num_classes=classes, width=16)
    specs = get_model("scene_tiny", num_classes=classes, width=16)
    jnet = jconvert_mod.convert_flagship(jspecs, (h, w, 3), jcfg)
    net = convert_flagship(specs, (h, w, 3), cfg)
    jparams = j_init_params(jspecs, (h, w, 3), jax.random.PRNGKey(1))
    params = params_from_numpy(
        specs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                for p in jparams], device="cpu")
    clips = np.stack([JSpriteVideo(JSpriteVideoConfig(
        height=h, width=w, n_sprites=2, sprite_size=10, speed=2.0,
        noise_std=0.01, seed=s)).clip(8) for s in (7, 11)])
    kw = dict(tau_grid=(0.05, 0.15, 0.4), budgets=(0.02, 0.1), budget=0.1,
              skip_frames=2, refresh_every=4, base_tau=0.01)
    want = jtuner.tune(jnet, jparams, clips, functools.partial(
        jmetrics.miou, num_classes=classes), **kw)
    # the reference's cost model on the port's stats
    monkeypatch.setattr(metrics, "MACHINE_BALANCE", jmetrics.MACHINE_BALANCE)
    monkeypatch.setattr(metrics, "_detect_channels", lambda row, c: (
        row.in_shape[2] if (row.spec.backend or c.backend) != "cuda"
        else -(-row.in_shape[2] // 128) * 128))
    runners, make = [], tuner._make_runner
    monkeypatch.setattr(tuner, "_make_runner", lambda *a, **k: (
        runners.append(make(*a, **k)) or runners[-1]))
    got = tuner.tune(net, params, clips, functools.partial(
        metrics.miou, num_classes=classes), **kw)
    assert got.thresholds == want.thresholds
    assert [p["thresholds"] for p in got.pareto] == \
        [p["thresholds"] for p in want.pareto]
    assert got.flop_frac == want.flop_frac
    (run,) = runners
    assert len(run.states) == 1  # both clips, every evaluation
