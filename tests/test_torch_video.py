"""The port's camera pan and ``two_frame_pair`` against the JAX package's
``video``, and the single change-gated conv of BASELINE.json configs[0] on
that pair against the reference layer (its Pallas path in interpret mode).

Frames are byte-identical for the same config and seed; the layer's stats
and changed-tile mask are exact, its output within float32 reassociation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import layers as jlayers
from cbinfer_tpu import video as jvideo
from cbinfer_tpu.config import ConvSpec as JConvSpec
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile

from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch import video
from cbinfer_tpu_torch.config import ConvSpec, PipelineConfig, TileConfig


@pytest.mark.parametrize("pan,extra", [
    ((1.0, 2.0), {}),                                  # pan_slow
    ((4.0, 8.0), {}),                                  # pan_fast
    ((0.5, -1.5), {"noise_std": 0.002}),               # rounding, negative
    ((2.0, 3.0), {**video.GRADED_DYNAMICS, "palette": "hard"}),
    ((0.0, 0.0), {}),                                  # no pan
])
def test_pan_frames_are_byte_identical(pan, extra):
    kw = dict(height=40, width=72, n_sprites=4, sprite_size=10, speed=4.0,
              seed=7, pan=pan, **extra)
    ref = jvideo.SpriteVideo(jvideo.SpriteVideoConfig(**kw))
    port = video.SpriteVideo(video.SpriteVideoConfig(**kw))
    fr, lr = ref.clip_with_labels(12)
    fp, lp = port.clip_with_labels(12)
    assert fp.dtype == fr.dtype and fp.tobytes() == fr.tobytes()
    np.testing.assert_array_equal(lp, lr)
    if pan != (0.0, 0.0):
        # the background really scrolls: most pixels change every frame
        assert (np.abs(fp[1] - fp[0]).max(-1) > 1e-6).mean() > 0.5


def test_pan_default_is_a_static_camera():
    cfg = video.SpriteVideoConfig(height=24, width=32, seed=3)
    assert cfg.pan == (0.0, 0.0)
    v = video.SpriteVideo(cfg)
    a = v.frame()
    v.step()
    b = v.frame()
    assert (np.abs(b - a).max(-1) > 0).mean() < 0.5


@pytest.mark.parametrize("kw", [
    {}, {"h": 32, "w": 48, "moved_pixels": 64, "seed": 0},
    {"h": 24, "w": 32, "moved_pixels": 36}, {"h": 16, "w": 16, "c": 1,
                                             "moved_pixels": 1, "seed": 5}])
def test_two_frame_pair_is_byte_identical(kw):
    f0, f1 = video.two_frame_pair(**kw)
    g0, g1 = jvideo.two_frame_pair(**kw)
    assert f0.tobytes() == g0.tobytes() and f1.tobytes() == g1.tobytes()
    assert f0.dtype == np.float32 and f1.shape == g1.shape
    changed = np.abs(f1 - f0).max(-1) > 0
    assert 0 < changed.sum() <= max(1, kw.get("moved_pixels", 64))


@pytest.mark.parametrize("tau", [0.0, 0.01, 0.3])
def test_config0_single_change_gated_conv(tau):
    """configs[0]: one change-gated 3x3 conv on the two-frame pair. The
    cold first frame computes every tile; the second only the tiles the
    moved square reaches. Stats and mask exact, outputs within 1e-5."""
    H, W, cout = 32, 48, 8
    f0, f1 = video.two_frame_pair(h=H, w=W, moved_pixels=64, seed=0)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 3, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    kw = dict(features=cout, threshold=tau)
    jspec, tspec = JConvSpec(**kw), ConvSpec(**kw)
    jcfg = JCfg(tile=JTile(8, 8), backend="pallas", interpret=True)
    tcfg = PipelineConfig(tile=TileConfig(8, 8), device="cpu")
    jst = jlayers.cb_layer_init(jspec, (H, W, 3), jcfg)
    tst = tlayers.cb_layer_init(tspec, (H, W, 3), tcfg)
    computed = []
    for f in (f0, f1):
        jy, jst, jstats, jhint = jlayers.cb_conv_apply(
            (jnp.asarray(w), jnp.asarray(b)), jst, jnp.asarray(f), jspec,
            jcfg)
        ty, tst, tstats, thint = tlayers.cb_conv_apply(
            (torch.from_numpy(w), torch.from_numpy(b)), tst,
            torch.from_numpy(f), tspec, tcfg)
        assert set(tstats) == set(jstats)
        for k in jstats:
            assert int(tstats[k]) == int(np.asarray(jstats[k])), k
        np.testing.assert_array_equal(thint.mask.numpy(),
                                      np.asarray(jhint.mask))
        np.testing.assert_allclose(ty.crop().numpy(), np.asarray(jy.crop()),
                                   atol=1e-5)
        computed.append(int(tstats["computed_tiles"]))
    n_tiles = int(tstats["n_tiles"])
    assert computed[0] == n_tiles
    if tau < 0.3:
        assert 0 < computed[1] < n_tiles // 3
