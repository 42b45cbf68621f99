"""The OpenPose DAG's computed tiles with the SHIPPED weights and taus,
the port against the reference, node by node and frame by frame.

``pose_graph``'s FLOP reduction is its per-node computed tiles priced by
``metrics.effective_flops_view``, which does not depend on the hardware.
Both packages load ``ckpts/pose_graph_w64.npz`` and its tau file through
their ``zoo.load`` and stream the same clip of
``scripts/bench_pose_graph.py``'s video (a refresh prolog on the first
chunk, as at the shipped cadence of 8), each on its CPU backend (the
reference's ``jnp``, the port's ``"torch"``), float32, at full capacity so
that, as on the kernel paths, no layer falls back to a dense recompute.
The counts must be equal. ``computed_tiles`` is the flow; run it by hand
at a larger size, e.g. ``computed_tiles(360, 640, 12, 8, seed)``.
"""

import dataclasses

import numpy as np
import pytest
import torch


def computed_tiles(H, W, T, chunks, seed):
    """{node: per-frame computed tiles} of the reference and of the port,
    and the two FLOP reductions, over ``chunks`` chunks of T frames."""
    import jax
    import jax.numpy as jnp
    from cbinfer_tpu import zoo as jzoo
    from cbinfer_tpu.config import TileConfig as JTile
    from cbinfer_tpu.metrics import effective_flops_view as j_eff
    from cbinfer_tpu.netview import NetView as JView
    from cbinfer_tpu.runner import scan_video as j_scan
    from cbinfer_tpu.video import (SpriteVideo, SpriteVideoConfig,
                                   workload_video_kwargs)

    from cbinfer_tpu_torch import zoo
    from cbinfer_tpu_torch.benchmark import concat_stats
    from cbinfer_tpu_torch.config import TileConfig
    from cbinfer_tpu_torch.metrics import effective_flops_view
    from cbinfer_tpu_torch.netview import NetView
    from cbinfer_tpu_torch.runner import scan_video

    shape = (H, W, 3)
    jcfg = dataclasses.replace(jzoo.default_pipeline_config(),
                               tile=JTile(8, 8, 1.0))
    assert jcfg.backend == "jnp" and jcfg.compute_dtype == "float32"
    jwl = jzoo.load("pose_graph", shape, jcfg)
    cfg = dataclasses.replace(zoo.default_pipeline_config("cpu"),
                              backend="torch", tile=TileConfig(8, 8, 1.0))
    wl = zoo.load("pose_graph", shape, cfg)
    for w in (jwl, wl):
        assert w.weights == "trained(npz)" and w.tau_source == "tuned"
    assert list(wl.taus) == pytest.approx(list(jwl.taus))
    video = SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=3, sprite_size=32, speed=4.0,
        noise_std=0.002, distinct_classes=True, seed=seed,
        **workload_video_kwargs("pose_graph")))
    clips = [video.clip(T) for _ in range(chunks)]

    tv = jnp.asarray(jwl.taus, jnp.float32)
    runs = {r: jax.jit(lambda p, fs, st, r=r: j_scan(
        jwl.net, p, fs, state=st, thresholds=tv, refresh_start=r)[1:])
            for r in (True, False)}
    st = jwl.net.init_state()
    jstats = []
    for i, c in enumerate(clips):
        st, s = runs[i == 0](jwl.params, jnp.asarray(c), st)
        jstats.append(jax.tree.map(np.asarray, s))
    state = wl.net.init_state()
    tstats = []
    with torch.no_grad():
        for i, c in enumerate(clips):
            _, state, s = scan_video(wl.net, wl.params, torch.from_numpy(c),
                                     state, thresholds=wl.taus,
                                     refresh_start=i == 0)
            tstats.append(s)
    jcat, tcat = concat_stats(jstats), concat_stats(tstats)
    want = {n: np.asarray(d["computed_tiles"]) for n, d in jcat.items()
            if d}
    got = {n: np.asarray(d["computed_tiles"]) for n, d in tcat.items()
           if d}
    j_red = j_eff(JView.from_nodes(jwl.specs, shape), jcat, 8, 8)
    t_red = effective_flops_view(NetView.from_nodes(wl.specs, shape), tcat,
                                 8, 8)
    return want, got, j_red["flop_reduction"], t_red["flop_reduction"]


def test_pose_graph_computed_tiles_equal_the_reference_with_shipped_weights():
    want, got, j_red, t_red = computed_tiles(64, 128, 4, 3, seed=17788)
    assert set(got) == set(want) and len(want) == 28
    for node in want:
        np.testing.assert_array_equal(got[node], want[node], err_msg=node)
    assert t_red == pytest.approx(j_red, rel=1e-6)
    # not vacuous: past the refresh frame some nodes skip tiles
    assert any(int(v[1:].min()) < int(v[0]) for v in got.values())
