"""The port's workload zoo against the JAX package's: ``zoo.load`` of the
sequential scene workloads gives the same specs ("pallas" read as "cuda"),
taus, refresh cadence, provenance and weights; every workload's video
profile and clip, the ``"hard"`` palette's too, is byte-identical. The pose,
seg and pose_graph workloads are held in ``test_torch_pose.py``,
``test_torch_seg.py`` and ``test_torch_graph.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from cbinfer_tpu import video as jvideo
from cbinfer_tpu import zoo as jzoo
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile

from cbinfer_tpu_torch import video as tvideo
from cbinfer_tpu_torch import zoo
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig

SHAPE = (64, 128, 3)


def _loads(name, **kw):
    jw = jzoo.load(name, SHAPE, JCfg(tile=JTile(8, 8, 0.375),
                                     backend="pallas", interpret=True), **kw)
    tw = zoo.load(name, SHAPE, PipelineConfig(tile=TileConfig(8, 8, 0.375),
                                              device="cpu"), **kw)
    return jw, tw


@pytest.mark.parametrize("name", ["scene", "scene_hard"])
def test_load_matches_reference(name):
    jw, tw = _loads(name)
    jspecs = [dataclasses.asdict(s) for s in jw.net.specs]
    for d in jspecs:
        if d.get("backend") == "pallas":
            d["backend"] = "cuda"
    assert [dataclasses.asdict(s) for s in tw.net.specs] == jspecs
    assert tw.net.specs[0].backend == "patch_stem"
    assert tw.net.in_shape == jw.net.in_shape == SHAPE
    assert tw.taus == jw.taus and len(tw.taus) == 6
    assert tw.refresh_every == jw.refresh_every == 32
    for f in ("name", "kind", "metric", "weights", "tau_source",
              "policy_source", "warnings", "upsample_scale", "fuse_detect"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert tw.weights == "trained(npz)" and tw.tau_source == "tuned"
    for tp, jp in zip(tw.params, jw.params):
        if jp is None:
            assert tp is None
            continue
        np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
        np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
        assert tp[0].dtype == torch.float32 and tp[0].device.type == "cpu"


def test_load_flat_tau_and_registry():
    jw, tw = _loads("scene", tau=0.07)
    assert tw.taus == jw.taus == [0.07] * 6
    assert tw.tau_source == jw.tau_source == "fixed(0.07)"
    assert tw.refresh_every is None and jw.refresh_every is None
    assert zoo.names() == jzoo.names()
    for n in zoo.names():
        te, je = zoo.REGISTRY[n], jzoo.REGISTRY[n]
        assert (te.kind, te.width, te.metric, te.npz, te.tau_json,
                te.policy_json, te.model_kwargs) == (
            je.kind, je.width, je.metric, je.npz, je.tau_json,
            je.policy_json, je.model_kwargs)
    with pytest.raises(KeyError):
        zoo.load("nope")


def test_default_config_is_the_card_flagship():
    cfg = zoo.default_pipeline_config()
    assert (cfg.backend, cfg.device, cfg.compute_dtype, cfg.cache_dtype) == (
        "cuda", "cuda", "bfloat16", "bfloat16")
    assert (cfg.tile.tile_h, cfg.tile.tile_w, cfg.tile.capacity_fraction) == (
        8, 8, 0.375)
    assert cfg.tile.capacity(3600) == JTile(8, 8, 0.375).capacity(3600) == 1350
    for frac, n in [(1.0, 7), (0.25, 4), (0.001, 10), (0.5, 9)]:
        assert TileConfig(8, 8, frac).capacity(n) == JTile(8, 8, frac) \
            .capacity(n)


@pytest.mark.parametrize("name,t,h,w", [
    ("scene", 32, 720, 1280),    # matches REFRESH_scene.json
    ("scene", 12, 720, 1280),    # another chunk size
    ("scene", 32, 360, 640),     # another resolution
    ("scene_hard", 32, 720, 1280),  # no such file
])
def test_load_refresh_cadence_matches_reference(name, t, h, w):
    assert zoo.load_refresh_cadence(name, t, h, w) \
        == jzoo.load_refresh_cadence(name, t, h, w)
    assert zoo.load_refresh_cadence(name, t, h, w, default=5) \
        == jzoo.load_refresh_cadence(name, t, h, w, default=5)


@pytest.mark.parametrize("name", ["scene", "scene_hard", "pose_hard", "seg",
                                  "seg_hard", "pose_graph"])
def test_workload_clip_is_byte_identical(name):
    """"pose_hard" and "seg_hard" have no entry of their own: the
    "<base>_hard" rule gives the base profile on the hard palette, in both
    packages (seg's is on it already)."""
    kw = tvideo.workload_video_kwargs(name)
    assert kw == jvideo.workload_video_kwargs(name)
    if name in ("pose_hard", "seg_hard"):
        assert kw == {**tvideo.workload_video_kwargs(name[:-5]),
                      "palette": "hard"}
    if name.startswith("seg"):
        assert kw == {**tvideo.GRADED_DYNAMICS, "palette": "hard"}
    if name == "pose_graph":
        assert kw == tvideo.GRADED_DYNAMICS
    cfg = dict(height=48, width=64, n_sprites=3, sprite_size=10, speed=3.0,
               noise_std=0.002, seed=4,
               distinct_classes=name.startswith("pose"), **kw)
    want = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**cfg))
    got = tvideo.SpriteVideo(tvideo.SpriteVideoConfig(**cfg))
    wf, wl = want.clip_with_labels(4)
    gf, gl = got.clip_with_labels(4)
    assert gf.tobytes() == wf.tobytes() and gl.tobytes() == wl.tobytes()
    np.testing.assert_array_equal(tvideo.CLASS_PALETTE_HARD,
                                  jvideo.CLASS_PALETTE_HARD)
    # every workload of the zoo has a profile, as in the reference
    for n in zoo.names():
        assert tvideo.workload_video_kwargs(n) \
            == jvideo.workload_video_kwargs(n)
    with pytest.raises(KeyError):
        tvideo.workload_video_kwargs("nope")
    with pytest.raises(ValueError, match="palette"):
        tvideo.SpriteVideo(tvideo.SpriteVideoConfig(palette="soft"))
