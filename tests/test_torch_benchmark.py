"""The port's benchmark module on the CPU against the JAX package's
(``cbinfer_tpu/benchmark.py``): ``make_clips``, ``RunConfig``,
``concat_stats``, ``BenchResult``, and ``bench_network``'s accuracy and
FLOP figures on a small scene net (width 8 at 64x128, the flagship
converter, the reference's ``init_params`` carried across), with and
without a refresh schedule. The timings are not compared: on the CPU
they are the CPU's.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cbinfer_tpu import benchmark as jbench
from cbinfer_tpu import config as jconfig
from cbinfer_tpu import convert as jconvert
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import init_params as j_init_params

from cbinfer_tpu_torch import benchmark as tbench
from cbinfer_tpu_torch import config as tconfig
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.convert import convert_flagship
from cbinfer_tpu_torch.models import get_model

H, W, T, SEED, TAU = 64, 128, 4, 3, 0.05
TCFG = tconfig.PipelineConfig(tile=tconfig.TileConfig(8, 8, 0.375),
                              device="cpu")
JCFG = jconfig.PipelineConfig(tile=jconfig.TileConfig(8, 8, 0.375),
                              backend="pallas", interpret=True)
RUN = dict(model="scene", height=H, width=W, frames=T, seed=SEED)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_make_clips_are_the_reference():
    got = tbench.make_clips(tconfig.RunConfig(pipeline=TCFG, **RUN), 3)
    want = jbench.make_clips(jconfig.RunConfig(**RUN), 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    one = tbench.make_clip(tconfig.RunConfig(pipeline=TCFG, **RUN))
    assert torch.equal(one, got[0])


def test_make_clips_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.make_clips(tconfig.RunConfig(**RUN), 2)


def test_run_config_fields_and_json_round_trip():
    port = [f.name for f in dataclasses.fields(tconfig.RunConfig)]
    ref = [f.name for f in dataclasses.fields(jconfig.RunConfig)]
    assert port == ref
    assert {f.name: f.default for f in dataclasses.fields(
        tconfig.RunConfig) if f.name != "pipeline"} == {
        f.name: f.default for f in dataclasses.fields(jconfig.RunConfig)
        if f.name != "pipeline"}
    pipe = {f.name for f in dataclasses.fields(tconfig.PipelineConfig)}
    jpipe = {f.name for f in dataclasses.fields(jconfig.PipelineConfig)}
    assert pipe - jpipe == {"device"} and jpipe - pipe == {"interpret"}
    rc = tconfig.RunConfig(model="pose", height=360, width=640, frames=16,
                           streams=4, seed=9, pipeline=TCFG)
    back = tconfig.from_json(tconfig.to_json(rc))
    assert back == rc and isinstance(back.pipeline.tile, tconfig.TileConfig)
    # the same document as the reference's, but for the pipeline's device
    mine = json.loads(tconfig.to_json(tconfig.RunConfig()))
    theirs = json.loads(jconfig.to_json(jconfig.RunConfig()))
    del mine["pipeline"]["device"], theirs["pipeline"]["interpret"]
    mine["pipeline"]["backend"] = theirs["pipeline"]["backend"]
    assert mine == theirs


def _stats(rng, n_layers=4):
    return [{"computed_tiles": rng.integers(0, 30, (T,)).astype(np.int32),
             "n_tiles": np.full((T,), 32, np.int32),
             "overflow": rng.uniform(size=T) < 0.2} if i % 2 == 0 else {}
            for i in range(n_layers)]


@pytest.mark.parametrize("mean", [False, True])
def test_concat_stats_is_the_reference(mean):
    rng = np.random.default_rng(1)
    chunks = [_stats(rng) for _ in range(3)]
    if mean:  # "mean" stats: one 0-dim value per chunk
        chunks = [[{k: np.float32(v.mean()) for k, v in s.items()}
                   for s in c] for c in chunks]
    want = jbench.concat_stats(chunks)
    got = tbench.concat_stats([[{k: torch.from_numpy(np.asarray(v))
                                 for k, v in s.items()} for s in c]
                               for c in chunks])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == np.asarray(w[k]).dtype
            assert np.array_equal(g[k], np.asarray(w[k]))
    by_name = tbench.concat_stats([{"a": c[0], "b": c[1]} for c in chunks])
    assert np.array_equal(by_name["a"]["n_tiles"], got[0]["n_tiles"])


def test_bench_result_json_and_headline_are_the_reference():
    kw = dict(dense_fps=100.0, cb_fps=250.123456, speedup=2.5012345,
              cold_start_ms=3.0, flop_reduction=7.5, metric_name="miou",
              metric_value=0.999, change_rates=[{}, {"layer": 1}],
              config={"model": "scene"})
    got, want = tbench.BenchResult(**kw), jbench.BenchResult(**kw)
    assert got.headline() == want.headline()
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert [f.name for f in dataclasses.fields(tbench.BenchResult)] == \
        [f.name for f in dataclasses.fields(jbench.BenchResult)]


def test_time_chunked_and_sync_overhead_on_cpu():
    assert tbench.measure_sync_overhead(3, device="cpu") >= 0.0
    chunks = [torch.ones(T, 4, 4, 3) for _ in range(2)]
    fps = tbench.time_chunked(lambda i, ch: ch * 2, chunks, T, 0.0)
    assert fps > 0
    x = np.random.default_rng(0).standard_normal((T, 4, 4, 3)).astype(
        np.float32)
    assert tbench.scalar_sync(torch.from_numpy(x)) == pytest.approx(
        jbench.scalar_sync(jax.numpy.asarray(x)), rel=1e-6)
    assert tbench.scalar_sync(torch.from_numpy(x[0])) == pytest.approx(
        jbench.scalar_sync(jax.numpy.asarray(x[0])), rel=1e-6)


def _nets():
    specs = get_model("scene", num_classes=8, width=8)
    jspecs = j_get_model("scene", num_classes=8, width=8)
    jparams = j_init_params(jspecs, (H, W, 3), jax.random.PRNGKey(SEED))
    tnet = convert_flagship(specs, (H, W, 3), TCFG)
    jnet = jconvert.convert_flagship(jspecs, (H, W, 3), JCFG)
    tparams = params_from_numpy(
        specs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                for p in jparams], device="cpu")
    taus = [TAU] * jconvert.num_cb_layers(jnet.specs)
    return tnet, tparams, jnet, jparams, taus


@pytest.fixture(scope="module", params=[None, 2 * T])
def bench_pair(request):
    """bench_network of both packages on the same clips (3 clips of T
    frames: one to warm, two timed), without a refresh and with one every
    second chunk."""
    tnet, tparams, jnet, jparams, taus = _nets()
    run = tconfig.RunConfig(pipeline=TCFG, **RUN)
    got = tbench.bench_network(tnet, tparams, tbench.make_clips(run, 3),
                               thresholds=taus, refresh_every=request.param,
                               run_config=run)
    want = jbench.bench_network(
        jnet, jparams, jbench.make_clips(jconfig.RunConfig(**RUN), 3),
        thresholds=taus, refresh_every=request.param)
    return got, want


def test_bench_network_figures_are_the_reference(bench_pair):
    got, want = bench_pair
    assert got.metric_name == want.metric_name == "miou"
    assert got.metric_value == pytest.approx(want.metric_value, abs=1e-6)
    assert got.flop_reduction == pytest.approx(want.flop_reduction,
                                               rel=1e-6)
    assert got.flop_reduction > 1
    assert len(got.change_rates) == len(want.change_rates)
    for g, w in zip(got.change_rates, want.change_rates):
        assert set(g) == set(w)
        for k in g:
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-9), k
    for r in (got.dense_fps, got.cb_fps, got.speedup):
        assert np.isfinite(r) and r > 0
    assert got.cold_start_ms >= 0.0
    assert got.config["pipeline"]["device"] == "cpu"
    assert set(got.headline()) == {"metric", "value", "unit", "vs_baseline"}


def test_bench_network_refuses_a_refresh_off_the_chunk_grid():
    """scan_video_jit refreshes only a chunk's first frame: a schedule
    off the chunk grid raises instead of timing the eager loop."""
    tnet, tparams, _, _, taus = _nets()
    clips = tbench.make_clips(tconfig.RunConfig(pipeline=TCFG, **RUN), 2)
    with pytest.raises(ValueError, match="multiple of the clip length"):
        tbench.bench_network(tnet, tparams, clips, thresholds=taus,
                             refresh_every=T + 1)
    with pytest.raises(ValueError, match=">= 2 clips"):
        tbench.bench_network(tnet, tparams, clips[:1])
