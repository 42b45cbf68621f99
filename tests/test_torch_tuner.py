"""The port's threshold tuner against the JAX package's.

* ``_tau_is_dead`` equals the reference's (``"pallas"`` read as
  ``"cuda"``) on the static views of the shipped nets.
* ``tune`` on ``scene_tiny`` (32x64, float32, the flagship converter, a
  3-tau grid, 2 budgets) selects the reference's taus and Pareto points,
  with equal FLOP reductions and metrics within 1e-6. The reference runs
  its ``"pallas"`` path in interpret mode with its weights carried across;
  in this test only, its pricing (balance 240, detect traffic at 128-lane
  widths) is patched into the port's cost model. The case with a refresh
  tunes from base tau 0.01, not 0: at tau = 0 the frame after a refresh
  compares the stem kernel's sequential float32 sum against the dense
  refresh conv's, which differ in the last bit on the CPU (the
  reference's interpret-mode kernel happens to match XLA's conv there),
  so every such pixel is a tie with tau.
* the device-metric path equals the host path; ``stress_validate`` as the
  reference's three tests hold it; the dense reference (CB at tau = -1)
  equals ``apply_dense``; stacked stats pack and unpack in one copy.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import graph as jgraph
from cbinfer_tpu import metrics as jmetrics
from cbinfer_tpu import tuner as jtuner
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import ConvSpec as JConvSpec
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPoolSpec
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.models import get_model as jget_model
from cbinfer_tpu.models.pose import pose_graph as jpose_graph
from cbinfer_tpu.netview import NetView as JNetView
from cbinfer_tpu.network import init_params as jinit_params

from cbinfer_tpu_torch import graph, metrics, tuner
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import (ConvSpec, PipelineConfig, PoolSpec,
                                      TileConfig)
from cbinfer_tpu_torch.convert import convert, convert_flagship
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.models.pose import pose_graph
from cbinfer_tpu_torch.netview import NetView
from cbinfer_tpu_torch.runner import pack_stats, scan_video, unpack_stats
from cbinfer_tpu_torch.video import SpriteVideo, SpriteVideoConfig

POSE_FWD = {15: "forward_hint", 16: "forward_hint", 20: "forward_hint"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs on one thread: these tests run beside other
    test processes, where a small CPU op's worker threads mostly wait for
    one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    return (JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True),
            PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu"))


@pytest.mark.parametrize("name,in_shape", [
    ("scene", (64, 128, 3)), ("scene", (720, 1280, 3)),
    ("pose", (720, 1280, 3)), ("pose_fwd", (720, 1280, 3)),
    ("pose_graph", (720, 1280, 3)), ("pose_graph", (64, 128, 3))])
def test_dead_taus_equal_the_reference(name, in_shape):
    jcfg, cfg = _cfgs()
    if name == "pose_graph":
        jnodes, jout = jpose_graph(width=64)
        nodes, out = pose_graph(width=64)
        jnet = jgraph.convert_graph_flagship(jnodes, in_shape, jcfg,
                                             output=jout, fuse_detect=True)
        net = graph.convert_graph_flagship(nodes, in_shape, cfg, output=out,
                                           fuse_detect=True)
    else:
        base = "pose" if name.startswith("pose") else "scene"
        kw = dict(width=64) if base == "pose" else dict(width=128)
        extra = POSE_FWD if name == "pose_fwd" else None
        fuse = base == "pose"
        jnet = jconvert.convert_flagship(jget_model(base, **kw), in_shape,
                                         jcfg, extra_overrides=extra,
                                         fuse_detect=fuse)
        net = convert_flagship(get_model(base, **kw), in_shape, cfg,
                               extra_overrides=extra, fuse_detect=fuse)
    jview, view = JNetView.of(jnet), NetView.of(net)
    want = [jtuner._tau_is_dead(jview, i)
            for i, r in enumerate(jview.rows) if r.is_cb]
    got = [tuner._tau_is_dead(view, i)
           for i, r in enumerate(view.rows) if r.is_cb]
    assert got == want
    assert any(got)  # every shipped net forwards a hint somewhere


H, W, T = 32, 64, 8
CLASSES = 5
VIDEO = dict(height=H, width=W, n_sprites=2, sprite_size=10, speed=2.0,
             noise_std=0.01)
TUNE = dict(tau_grid=(0.05, 0.15, 0.4), budgets=(0.02, 0.1), budget=0.1,
            skip_frames=2)


def _reference_pricing(monkeypatch):
    """The JAX package's cost model on the port's stats: its v5e balance
    and its 128-lane detect widths (logical on the stem's own backend)."""
    monkeypatch.setattr(metrics, "MACHINE_BALANCE", jmetrics.MACHINE_BALANCE)

    def lane_padded(row, cfg):
        c = row.in_shape[2]
        return c if (row.spec.backend or cfg.backend) != "cuda" \
            else -(-c // 128) * 128
    monkeypatch.setattr(metrics, "_detect_channels", lane_padded)


@pytest.fixture(scope="module")
def tiny():
    """scene_tiny both ways, the reference's weights carried across, and a
    two-clip calibration set."""
    jcfg, cfg = _cfgs()
    jspecs = jget_model("scene_tiny", num_classes=CLASSES, width=16)
    specs = get_model("scene_tiny", num_classes=CLASSES, width=16)
    jnet = jconvert.convert_flagship(jspecs, (H, W, 3), jcfg)
    net = convert_flagship(specs, (H, W, 3), cfg)
    jparams = jinit_params(jspecs, (H, W, 3), jax.random.PRNGKey(1))
    params = params_from_numpy(
        specs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                for p in jparams], device="cpu")
    clips = np.stack([jvideo.SpriteVideo(jvideo.SpriteVideoConfig(
        seed=s, **VIDEO)).clip(T) for s in (7, 11)])
    return jnet, jparams, net, params, clips


@pytest.mark.parametrize("refresh_every,base_tau", [(None, 0.0), (4, 0.01)])
def test_tune_selects_the_reference_taus(tiny, monkeypatch, refresh_every,
                                         base_tau):
    jnet, jparams, net, params, clips = tiny
    kw = dict(TUNE, refresh_every=refresh_every, base_tau=base_tau)
    want = jtuner.tune(jnet, jparams, clips, functools.partial(
        jmetrics.miou, num_classes=CLASSES), **kw)
    _reference_pricing(monkeypatch)
    got = tuner.tune(net, params, clips, functools.partial(
        metrics.miou, num_classes=CLASSES), **kw)
    assert got.thresholds == want.thresholds
    assert got.flop_reduction == want.flop_reduction
    assert abs(got.metric - want.metric) <= 1e-6
    assert len(got.pareto) == len(want.pareto)
    for p, q in zip(got.pareto, want.pareto):
        assert p["budget"] == q["budget"]
        assert p["thresholds"] == q["thresholds"]
        assert p["flop_reduction"] == q["flop_reduction"]
        assert abs(p["metric"] - q["metric"]) <= 1e-6
        assert p["cost_reduction"] == pytest.approx(q["cost_reduction"],
                                                    rel=1e-9)
    assert got.flop_frac == want.flop_frac
    for l, curve in want.sensitivity.items():
        for (t, m), (t2, m2) in zip(curve, got.sensitivity[l]):
            assert t == t2 and abs(m - m2) <= 1e-6
    assert got.evaluations > 0


def test_device_metric_path_equals_the_host_path(tiny):
    _, _, net, params, clips = tiny
    host = tuner.tune(net, params, clips, functools.partial(
        metrics.miou, num_classes=CLASSES), **TUNE)
    dev = tuner.tune(net, params, clips, functools.partial(
        metrics.miou, num_classes=CLASSES),
        device_metric_fn=functools.partial(metrics.miou_device,
                                           num_classes=CLASSES), **TUNE)
    assert dev.thresholds == host.thresholds
    assert dev.flop_reduction == host.flop_reduction
    assert abs(dev.metric - host.metric) <= 1e-6
    assert dev.evaluations == host.evaluations


def test_dense_reference_equals_apply_dense():
    """The tuner's dense reference is the CB run at tau = -1: the patch
    stem overflows its capacity and computes every tile, every other layer
    recomputes everything. It must equal the dense path."""
    specs = get_model("scene", num_classes=8, width=8)
    net = convert_flagship(specs, (64, 128, 3), _cfgs()[1])
    params = params_from_numpy(specs, [
        None if not isinstance(s, ConvSpec) else
        (np.random.default_rng(i).standard_normal(
            s.kernel + (c, s.features)).astype(np.float32) * 0.3,
         np.zeros(s.features, np.float32))
        for i, (s, c) in enumerate(zip(specs, [3, 8, 8, 16, 16, 16, 16]))],
        device="cpu")
    clip = torch.from_numpy(SpriteVideo(SpriteVideoConfig(
        height=64, width=128, noise_std=0.01, seed=2)).clip(6))
    run = tuner._make_runner(net, params, refresh_every=4)
    ys, stats = run(clip, [-1.0] * 6)
    dense = torch.stack([net.apply_dense(params, f) for f in clip])
    np.testing.assert_allclose(ys.numpy(), dense.numpy(), atol=1e-4,
                               rtol=0)
    assert torch.equal(ys.argmax(-1), dense.argmax(-1))
    # every frame but the refreshes (0 and 4) overflowed the stem
    assert stats[0]["overflow"].tolist() == [False, True, True, True,
                                             False, True]


def test_stacked_stats_pack_in_one_tensor(tiny):
    _, _, net, params, clips = tiny
    _, _, stats = scan_video(net, params, torch.from_numpy(clips[0]),
                             thresholds=[0.05] * 3)
    packed = pack_stats(stats)
    assert packed.shape == (3, 6, T) and packed.dtype == torch.int32
    rows = unpack_stats(packed)
    cb = [s for s in stats if s]
    for r, s in zip(rows, cb):
        for k, v in s.items():
            np.testing.assert_array_equal(r[k], v.numpy().astype(np.int32))
    host = tuner._host_stats([stats, stats], 2)
    assert host[0][3] == {} and len(host) == 2
    np.testing.assert_array_equal(host[1][0]["computed_tiles"],
                                  stats[0]["computed_tiles"][2:].numpy())
    assert host[0][0]["overflow"].dtype == bool


# ---- stress_validate: mirrors of the reference's three tests ----


def _setup():
    specs = [
        ConvSpec(features=8, threshold=0.0),
        PoolSpec(threshold=0.0),
        ConvSpec(features=8, threshold=0.0),
        ConvSpec(features=5, kernel=(1, 1), activation=None, threshold=0.0),
    ]
    net = convert(specs, (32, 48, 3), PipelineConfig(device="cpu"))
    rng = np.random.default_rng(2)
    params_np, c = [], 3
    for s in specs:
        if isinstance(s, ConvSpec):
            kh, kw = s.kernel
            params_np.append((rng.standard_normal((kh, kw, c, s.features))
                              .astype(np.float32) * np.sqrt(2 / (kh * kw * c)),
                              np.zeros(s.features, np.float32)))
            c = s.features
        else:
            params_np.append(None)
    params = params_from_numpy(specs, params_np, device="cpu")
    clip = SpriteVideo(SpriteVideoConfig(height=32, width=48, n_sprites=2,
                                         sprite_size=8, noise_std=0.01,
                                         seed=4)).clip(8)
    return net, params, clip


def test_stress_validate_prefers_first_passing_candidate():
    net, params, clip = _setup()
    metric = functools.partial(metrics.miou, num_classes=5)
    res = tuner.stress_validate(
        net, params, {"tuned": [0.0] * 4, "flat9": [9.0] * 4}, clip,
        metric_fn=metric, budget=0.005)
    assert res.source == "tuned" and res.passed
    assert res.thresholds == [0.0] * 4
    assert [r["name"] for r in res.rows] == ["tuned", "flat9"]
    assert res.rows[0]["worst_degradation"] <= 0.005


def test_stress_validate_falls_back_when_tuned_fails():
    net, params, clip = _setup()
    metric = functools.partial(metrics.miou, num_classes=5)
    res = tuner.stress_validate(
        net, params, {"tuned": [9.0] * 4, "flat0": [0.0] * 4}, clip,
        metric_fn=metric, budget=0.005)
    assert res.rows[0]["worst_degradation"] > 0.005  # sabotage measured
    assert res.source == "flat0" and res.passed
    res2 = tuner.stress_validate(net, params, {"tuned": [9.0] * 4}, clip,
                                 metric_fn=metric, budget=0.005)
    assert not res2.passed and res2.source == "tuned"


def test_stress_validate_multi_clip_worst_and_labels():
    net, params, _ = _setup()
    pairs = [SpriteVideo(SpriteVideoConfig(
        height=32, width=48, n_sprites=2, sprite_size=8, noise_std=0.01,
        seed=s)).clip_with_labels(8) for s in (5, 6)]
    clips = np.stack([f for f, _ in pairs])
    labels = np.stack([lab[:, ::2, ::2] for _, lab in pairs])

    def gt_metric(cb, dn, lab):
        return 1.0 - (metrics.miou_labels(dn, lab, 5)
                      - metrics.miou_labels(cb, lab, 5))

    def gt_device(cb, dn, lab):
        return 1.0 - (metrics.miou_labels_device(dn, lab, 5)
                      - metrics.miou_labels_device(cb, lab, 5))

    res = tuner.stress_validate(net, params, {"tuned": [0.0] * 4}, clips,
                                metric_fn=gt_metric, labels=labels,
                                budget=0.005)
    assert res.passed
    assert len(res.rows[0]["per_clip_degradation"]) == 2
    assert res.rows[0]["worst_degradation"] == max(
        res.rows[0]["per_clip_degradation"])
    # host-side list inputs, and the device metric, give the same rows
    res_l = tuner.stress_validate(
        net, params, {"tuned": [0.0] * 4, "flat": [0.2] * 4},
        list(clips), metric_fn=gt_metric, labels=list(labels),
        budget=0.005, device_metric_fn=gt_device)
    host = tuner.stress_validate(
        net, params, {"tuned": [0.0] * 4, "flat": [0.2] * 4}, clips,
        metric_fn=gt_metric, labels=labels, budget=0.005)
    for a, b in zip(res_l.rows, host.rows):
        np.testing.assert_allclose(a["per_clip_degradation"],
                                   b["per_clip_degradation"], atol=2e-6)
    with pytest.raises(ValueError, match="taus"):
        tuner.stress_validate(net, params, {"short": [0.0]}, clips,
                              metric_fn=gt_metric, labels=labels)


# ---- stress_validate: the port's rows against the reference's ----


def test_stress_rows_equal_the_reference_rows():
    """The reference's and the port's ``stress_validate`` on one net and
    weights (carried across), the same two labelled clips and three
    distinct tau vectors, with the GT-mIoU degradation as the metric, a
    refresh every 4 frames and 2 skipped frames: every row (name, taus,
    per-clip, worst and mean degradation) and the choice are equal, and
    the three vectors' rows differ from one another."""
    def layers(conv, pool):
        return [conv(features=8, threshold=0.0), pool(threshold=0.0),
                conv(features=8, threshold=0.0),
                conv(features=5, kernel=(1, 1), activation=None,
                     threshold=0.0)]
    specs, jspecs = layers(ConvSpec, PoolSpec), layers(JConvSpec, JPoolSpec)
    jnet = jconvert.convert(jspecs, (32, 48, 3), JCfg())
    jparams = jinit_params(jspecs, (32, 48, 3), jax.random.PRNGKey(5))
    net = convert(specs, (32, 48, 3), PipelineConfig(device="cpu"))
    params = params_from_numpy(
        net.specs, [None if p is None else (np.asarray(p[0]),
                                            np.asarray(p[1]))
                    for p in jparams], device="cpu")
    pairs = [SpriteVideo(SpriteVideoConfig(
        height=32, width=48, n_sprites=3, sprite_size=8, noise_std=0.02,
        seed=s)).clip_with_labels(10) for s in (21, 22)]
    clips = np.stack([f for f, _ in pairs])
    labels = np.stack([lab[:, ::2, ::2] for _, lab in pairs])
    candidates = {"fine": [0.01] * 4, "mid": [0.08, 0.05, 0.08, 0.05],
                  "coarse": [0.3] * 4}

    def metric(miou_labels):
        def gt(cb, dn, lab):
            return 1.0 - (miou_labels(dn, lab, 5) - miou_labels(cb, lab, 5))
        return gt

    kw = dict(labels=labels, budget=0.01, skip_frames=2, refresh_every=4)
    ref = jtuner.stress_validate(jnet, jparams, candidates, clips,
                                 metric(jmetrics.miou_labels), **kw)
    got = tuner.stress_validate(net, params, candidates, clips,
                                metric(metrics.miou_labels), **kw)
    assert got.rows == ref.rows
    assert (got.source, got.passed, got.thresholds) == \
        (ref.source, ref.passed, ref.thresholds)
    worst = [r["per_clip_degradation"] for r in got.rows]
    assert len({tuple(w) for w in worst}) == 3, worst
