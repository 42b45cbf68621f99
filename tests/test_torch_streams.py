"""The port's multi-stream runner (``cbinfer_tpu_torch.parallel``) against
the JAX package's ``MultiStreamRunner`` on the same nets, weights and clips.

The reference runs on ``make_stream_mesh(D)`` over the conftest's virtual
CPU devices, the port on a mesh of ``["cpu"] * D``, at D = 1, 2, 4 and 8:
the waves, the deployment knobs, the output and stats shapes ((S, T, ...),
(T, S), (S,) and []), the un-gathered forms, uneven streams, state
isolation, the DAG ``pose_graph`` net and the dry run's three sub-runs.
The nets and clips are those of the reference's ``tests/test_sharding.py``
with its weights carried across. uint8 maps and every counter are exact;
float outputs and caches agree within the slice tests' float32 bound
(1e-4, as in ``test_torch_runner.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu.config import ConvSpec as JConv
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import PoolSpec as JPool
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.convert import convert as jconvert
from cbinfer_tpu.network import init_params as j_init_params
from cbinfer_tpu.parallel import MultiStreamRunner as JRunner
from cbinfer_tpu.parallel import make_stream_mesh as j_mesh
from cbinfer_tpu.video import SpriteVideo, SpriteVideoConfig

from _torch_carry import cache_from_lanes
from cbinfer_tpu_torch import graph as tgraph
from cbinfer_tpu_torch.checkpoint import params_from_numpy
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, PoolSpec
from cbinfer_tpu_torch.config import TileConfig
from cbinfer_tpu_torch.convert import convert, num_cb_layers
from cbinfer_tpu_torch.models.pose import pose_graph
from cbinfer_tpu_torch.parallel import (MultiStreamRunner,
                                        dryrun_multistream, make_stream_mesh,
                                        shard_streams)
from cbinfer_tpu_torch.runner import scan_video

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs(conv, pool):
    return [conv(features=8, threshold=0.02), pool(threshold=0.02),
            conv(features=5, kernel=(1, 1), activation=None, threshold=0.02)]


def _carry(jparams, tspecs):
    return params_from_numpy(
        tspecs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                 for p in jparams], device="cpu")


def _nets(h=32, w=48, tile=4, jbackend="jnp", specs=_specs, seed=3):
    """The reference's ``_net()`` (default: 4x4 tiles on its plain
    backend) and the port's twin on the same weights."""
    jspecs = specs(JConv, JPool)
    jnet = jconvert(jspecs, (h, w, 3),
                    JCfg(tile=JTile(tile_h=tile, tile_w=tile),
                         backend=jbackend, interpret=jbackend == "pallas"))
    jparams = j_init_params(jspecs, (h, w, 3), jax.random.PRNGKey(seed))
    tnet = convert(specs(ConvSpec, PoolSpec), (h, w, 3),
                   PipelineConfig(tile=TileConfig(tile, tile), device="cpu"))
    return jnet, jparams, tnet, _carry(jparams, tnet.specs)


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _clips(n, t, h=32, w=48, base=100, **kw):
    return np.stack([SpriteVideo(SpriteVideoConfig(
        height=h, width=w, seed=base + s, **kw)).clip(t) for s in range(n)])


def _u8(y):
    return y.argmax(-1).to(torch.uint8)


def _j_u8(y):
    return jnp.argmax(y, -1).astype(jnp.uint8)


def _cpu(d):
    return ["cpu"] * d


def _same_stats(tstats, jstats, exact=True):
    """Counter trees (lists of per-layer dicts) equal leaf for leaf, with
    the same shapes."""
    assert len(tstats) == len(jstats)
    for k, (ts, js) in enumerate(zip(tstats, jstats)):
        assert set(ts) == set(js), k
        for key in js:
            a, b = ts[key].numpy(), np.asarray(js[key])
            assert a.shape == b.shape, (k, key, a.shape, b.shape)
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=f"{k} {key}")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           err_msg=f"{k} {key}")


def _same_states(tstates, jstates, jaxis=None):
    """Each stream's final caches: the port's against the reference's
    (``jaxis``: index of the stream within a (D, ...) wave array)."""
    for ts, js in zip(tstates, jstates):
        for a, b in zip(ts, js):
            if a is None:
                assert b is None
                continue
            for name in ("in_cache", "out_cache"):
                ref = np.asarray(getattr(b, name))
                if jaxis is not None:
                    ref = ref[jaxis]
                t = getattr(a, name).numpy()
                c = min(t.shape[-1], ref.shape[-1])  # lane or grid padding
                np.testing.assert_allclose(t[..., :c],
                                           cache_from_lanes(ref, c),
                                           atol=TOL, err_msg=name)


def _j_states(runner):
    """The reference runner's states, one per stream (waves unstacked)."""
    if runner._D == 1:
        return [(st, None) for st in runner.states]
    return [(runner.states[s // runner._D], s % runner._D)
            for s in range(runner.n_streams)]


def _check_states(truns, jrun):
    for ts, (js, ax) in zip(truns.states, _j_states(jrun)):
        _same_states([ts], [js], ax)


# ------------------------------- the mesh ------------------------------------


def test_cpu_meshes_and_the_reference_mesh():
    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_stream_mesh(8, device="cpu")
    assert mesh == [torch.device("cpu")] * 8
    assert make_stream_mesh(device="cpu") == [torch.device("cpu")]


def test_a_gpu_mesh_never_shrinks_or_falls_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the counts are real")
    with pytest.raises(RuntimeError, match="cuda"):
        make_stream_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_stream_mesh() == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    assert make_stream_mesh(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="3 GPUs"):
        make_stream_mesh(3)


def test_shard_streams_places_per_stream_and_replicates_once():
    tree = [(torch.arange(12.).view(4, 3), None), {"a": torch.ones(4, 2)}]
    per = shard_streams(_cpu(2), tree)
    assert len(per) == 4
    for s, t in enumerate(per):
        assert torch.equal(t[0][0], tree[0][0][s]) and t[0][1] is None
        assert torch.equal(t[1]["a"], torch.ones(2))
    reps = shard_streams(_cpu(3), tree, batched=False)
    assert len(reps) == 3 and reps[0] is reps[1] is reps[2]
    # a leaf already on its device is not copied
    assert reps[0][0][0] is tree[0][0]


# ------------------------------- run_clip ------------------------------------


@pytest.mark.parametrize("d", [8, 1])
def test_multistream_matches_the_reference_and_per_stream_scans(nets, d):
    """8 streams at D = 8 (one wave) and 1 (D = 2's four waves:
    test_waves_match_single_stream): each stream's
    outputs and final caches equal the reference runner's and the port's
    own single-stream scan, stats (T, S)."""
    jnet, jparams, tnet, tparams = nets
    clips = _clips(8, 4, n_sprites=2)
    jr = JRunner(jnet, jparams, n_streams=8, mesh=j_mesh(d))
    tr = MultiStreamRunner(tnet, tparams, n_streams=8, mesh=_cpu(d))
    assert tr.n_waves == jr.n_waves == 8 // d
    jys, jst = jr.run_clip(jnp.asarray(clips))
    tys, tst = tr.run_clip(clips)
    assert tuple(tys.shape) == tuple(jys.shape)[:-1] + (5,) or \
        tuple(tys.shape) == tuple(jys.shape)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys)[..., :5],
                               atol=TOL)
    _same_stats(tst, jst)
    assert tuple(tst[0]["computed_tiles"].shape) == (4, 8)
    _check_states(tr, jr)
    for s in range(8):
        ys, _, _ = scan_video(tnet, tparams, torch.from_numpy(clips[s]))
        assert torch.equal(tys[s], ys), s


@pytest.mark.parametrize("d", [4, 1])
def test_deployment_knobs_match_the_reference(nets, d):
    """thresholds, the uint8 argmax out_map, and mean or dropped stats,
    on a mesh and at D = 1."""
    jnet, jparams, tnet, tparams = nets
    n = num_cb_layers(tnet.specs)
    taus = [0.02] * n
    clips = _clips(4, 3, base=300)
    jr = JRunner(jnet, jparams, n_streams=4, mesh=j_mesh(d),
                 thresholds=jnp.asarray(taus, jnp.float32), out_map=_j_u8,
                 collect_stats="mean")
    tr = MultiStreamRunner(tnet, tparams, n_streams=4, mesh=_cpu(d),
                           thresholds=taus, out_map=_u8,
                           collect_stats="mean")
    jys, jst = jr.run_clip(jnp.asarray(clips))
    tys, tst = tr.run_clip(clips)
    assert tys.dtype == torch.uint8 and tuple(tys.shape) == (4, 3, 16, 24)
    np.testing.assert_array_equal(tys.numpy(), np.asarray(jys))
    assert tuple(tst[0]["computed_tiles"].shape) == (4,)
    _same_stats(tst, jst, exact=False)
    for s in range(4):
        ys, _, st = scan_video(tnet, tparams, torch.from_numpy(clips[s]),
                               thresholds=taus, out_map=_u8,
                               collect_stats="mean")
        assert torch.equal(tys[s], ys)
        assert float(tst[0]["computed_tiles"][s]) == \
            float(st[0]["computed_tiles"])
    tr0 = MultiStreamRunner(tnet, tparams, n_streams=4, mesh=_cpu(d),
                            thresholds=taus, out_map=_u8,
                            collect_stats=False)
    ys0, st0 = tr0.run_clip(clips)
    assert st0 == [] and torch.equal(ys0, tys)
    with pytest.raises(ValueError, match="collect_stats"):
        MultiStreamRunner(tnet, tparams, 4, mesh=_cpu(d),
                          collect_stats="sum")


def test_refresh_start_is_each_streams_chunk_start_refresh(nets):
    _, _, tnet, tparams = nets
    clips = _clips(2, 3, base=40)
    tr = MultiStreamRunner(tnet, tparams, n_streams=2, mesh=_cpu(1))
    tr.run_clip(clips)
    ys, st = tr.run_clip(clips, refresh_start=True)
    for s in range(2):
        state = tnet.init_state()
        scan_video(tnet, tparams, torch.from_numpy(clips[s]), state)
        ref, _, rst = scan_video(tnet, tparams, torch.from_numpy(clips[s]),
                                 state, refresh_start=True)
        assert torch.equal(ys[s], ref)
        assert torch.equal(st[0]["computed_tiles"][:, s],
                           rst[0]["computed_tiles"])


def test_waves_match_single_stream():
    """S > devices: one stream per device per wave (2 waves of 2), the
    reference's single-conv net at 16x24 with 8x8 tiles."""
    def one_conv(conv, pool):
        return [conv(features=8, kernel=(3, 3), threshold=0.03)]
    jnet, jparams, tnet, tparams = _nets(16, 24, 8, specs=one_conv)
    clips = _clips(4, 3, 16, 24, base=300, n_sprites=1, sprite_size=5)
    jr = JRunner(jnet, jparams, n_streams=4, mesh=j_mesh(2))
    tr = MultiStreamRunner(tnet, tparams, n_streams=4, mesh=_cpu(2))
    assert tr.n_waves == jr.n_waves == 2
    tys, _ = tr.run_clip(clips)
    jys, _ = jr.run_clip(jnp.asarray(clips))
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=TOL)
    for s in range(4):
        ys, _, _ = scan_video(tnet, tparams, torch.from_numpy(clips[s]))
        assert torch.equal(tys[s], ys)


def test_kernel_path_matches_the_reference_pallas_path():
    """The port's "cuda" backend (its kernels' plain versions on the CPU)
    against the reference's Pallas kernels in interpret mode, 4 streams
    over 4 devices, 8x8 tiles (the port's kernels take nothing finer)."""
    jnet, jparams, tnet, tparams = _nets(32, 48, 8, "pallas", seed=9)
    clips = _clips(4, 3, base=200, n_sprites=1, sprite_size=5)
    jr = JRunner(jnet, jparams, n_streams=4, mesh=j_mesh(4))
    tr = MultiStreamRunner(tnet, tparams, n_streams=4, mesh=_cpu(4))
    jys, jst = jr.run_clip(jnp.asarray(clips))
    tys, tst = tr.run_clip(clips)
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys)[..., :5],
                               atol=TOL)
    _same_stats(tst, jst)
    _check_states(tr, jr)


def test_uneven_streams_rejected(nets):
    jnet, jparams, tnet, tparams = nets
    with pytest.raises(ValueError):
        JRunner(jnet, jparams, n_streams=3, mesh=j_mesh(8))
    with pytest.raises(ValueError, match="divide"):
        MultiStreamRunner(tnet, tparams, n_streams=3, mesh=_cpu(8))


# ---------------------------- gather_outputs ---------------------------------


def test_no_gather_matches_gathered(nets):
    """gather_outputs=False: one entry per stream at D = 1; at D > 1 one
    list of D per-stream entries per wave, where the reference returns one
    (D, ...) array per wave (a tensor cannot span devices): stacked, each
    wave's list equals the reference's wave array."""
    jnet, jparams, tnet, tparams = nets
    clips = _clips(8, 4, base=200, n_sprites=2)
    g = MultiStreamRunner(tnet, tparams, n_streams=8, mesh=_cpu(4))
    ng = MultiStreamRunner(tnet, tparams, n_streams=8, mesh=_cpu(4),
                           gather_outputs=False)
    jng = JRunner(jnet, jparams, n_streams=8, mesh=j_mesh(4),
                  gather_outputs=False)
    ys, st = g.run_clip(clips)
    ys_l, st_l = ng.run_clip(clips)
    jys_l, jst_l = jng.run_clip(jnp.asarray(clips))
    assert isinstance(ys_l, list) and len(ys_l) == len(jys_l) == 2
    for w in range(2):
        assert isinstance(ys_l[w], list) and len(ys_l[w]) == 4
        np.testing.assert_allclose(torch.stack(ys_l[w]).numpy(),
                                   np.asarray(jys_l[w])[..., :5], atol=TOL)
        assert len(st_l[w]) == 4
        np.testing.assert_array_equal(
            torch.stack([s[0]["changed_tiles"] for s in st_l[w]], 1).numpy(),
            np.asarray(jst_l[w][0]["changed_tiles"]))
    assert torch.equal(ys, torch.stack([y for w in ys_l for y in w]))
    ng1 = MultiStreamRunner(tnet, tparams, n_streams=2, mesh=_cpu(1),
                            gather_outputs=False)
    ys1, st1 = ng1.run_clip(clips[:2])
    assert isinstance(ys1, list) and len(ys1) == 2 and len(st1) == 2
    for s in range(2):
        assert torch.equal(ys1[s], ys[s])
    ys_s, _ = ng1.step(clips[:2, 0])
    assert isinstance(ys_s, list) and len(ys_s) == 2


# --------------------------------- step --------------------------------------


@pytest.mark.parametrize("d", [8, 1])
def test_step_interface_and_state_isolation(nets, d):
    """Cold start computes every tile on every stream; the same frames
    again change nothing; reset restores the cold start; each step equals
    the reference's and the stream run alone; streams share no cache."""
    jnet, jparams, tnet, tparams = nets
    jr = JRunner(jnet, jparams, n_streams=8, mesh=j_mesh(d))
    tr = MultiStreamRunner(tnet, tparams, n_streams=8, mesh=_cpu(d))
    f0 = np.stack([SpriteVideo(SpriteVideoConfig(
        height=32, width=48, seed=s)).frame() for s in range(8)])
    y1, stats = tr.step(f0)
    jy1, jstats = jr.step(jnp.asarray(f0))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1)[..., :5],
                               atol=TOL)
    _same_stats(stats, jstats)
    ct = stats[0]["computed_tiles"]
    assert tuple(ct.shape) == (8,) and stats[0]["overflow"].dtype == \
        torch.bool
    assert bool((ct == stats[0]["n_tiles"].max()).all())
    y2, stats = tr.step(f0)
    assert bool((stats[0]["changed_tiles"] == 0).all())
    assert torch.equal(y1, y2)
    ptrs = [s.in_cache.data_ptr() for st in tr.states for s in st if s]
    assert len(set(ptrs)) == len(ptrs)
    # a stream run alone on the same frames
    alone = tnet.init_state()
    ya, _, _ = scan_video(tnet, tparams, torch.from_numpy(f0[3:4]), alone)
    assert torch.equal(y1[3], ya[0])
    for a, b in zip(tr.states[3], alone):
        if a is not None:
            assert torch.equal(a.in_cache, b.in_cache)
    kept = [s.in_cache.data_ptr() for st in tr.states for s in st if s]
    tr.reset()
    assert kept == [s.in_cache.data_ptr() for st in tr.states for s in st
                    if s]
    _, stats = tr.step(f0)
    assert bool((stats[0]["computed_tiles"]
                 == stats[0]["n_tiles"].max()).all())


# ------------------------------ the DAG net ----------------------------------


def test_pose_graph_dag_through_the_runner():
    """The concat DAG (pose_graph w8, 64x128, 8x8 tiles) through the
    runner over two devices: run_clip and step equal each stream's own
    scan_video, outputs and name-keyed stats (T, S) exact, the stats in
    topological order. (The DAG's scan_video is held against the
    reference's in test_torch_graph.py; the reference's plain backend
    bounds its lists by capacity and falls back to dense, which the
    port's kernel path does not, so its counters are not this path's.)"""
    h, w = 64, 128
    nodes, out = pose_graph(width=8)
    tnet = tgraph.convert_graph_flagship(
        nodes, (h, w, 3), PipelineConfig(tile=TileConfig(8, 8, 0.5),
                                         device="cpu"), output=out)
    tparams = tgraph.init_graph_params(nodes, (h, w, 3), 2, "cpu")
    clips = _clips(2, 3, h, w, base=7)
    tr = MultiStreamRunner(tnet, tparams, n_streams=2, mesh=_cpu(2))
    tys, tst = tr.run_clip(clips[:, :2])
    ys1, st1 = tr.step(clips[:, 2])
    assert list(tst) == [n.name for n in tnet.nodes]
    assert tuple(tys.shape) == (2, 2, 8, 16, 56)
    for s in range(2):
        ys, _, st = scan_video(tnet, tparams, torch.from_numpy(clips[s]))
        assert torch.equal(tys[s], ys[:2]) and torch.equal(ys1[s], ys[2])
        for name, counters in st.items():
            for k, v in counters.items():
                assert torch.equal(tst[name][k][:, s], v[:2]), (name, k)
                assert torch.equal(st1[name][k][s], v[2]), (name, k)


def test_dryrun_sub_runs_on_the_cpu(capsys):
    """The JAX package's dry run's sizes and tiles: 32x64, 4x4 tiles on
    the plain stem's and the DAG's sub-runs (whose pools leave 4x8
    maps), 8x8 on the kernel path's."""
    shapes = dryrun_multistream(2, device="cpu")
    assert shapes == {"plain_stem": (2, 8, 16, 8),
                      "kernel_path": (2, 2, 8, 16, 8),
                      "pose_graph": (2, 2, 4, 8, 56)}
    assert "3 sub-runs" in capsys.readouterr().out
