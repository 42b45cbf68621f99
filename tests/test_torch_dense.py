"""The port's dense baseline path and weight loading against the JAX
package's, on the CPU in float32, with the trained scene weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbinfer_tpu import checkpoint as jckpt
from cbinfer_tpu import network as jnet
from cbinfer_tpu.config import ConvSpec as JConvSpec
from cbinfer_tpu.config import PoolSpec as JPoolSpec
from cbinfer_tpu.config import UpsampleSpec as JUpsampleSpec
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.video import SpriteVideo as JSpriteVideo
from cbinfer_tpu.video import SpriteVideoConfig as JSpriteVideoConfig

from cbinfer_tpu_torch import network as tnet
from cbinfer_tpu_torch.checkpoint import load_npz_params, params_from_numpy
from cbinfer_tpu_torch.config import ConvSpec, PoolSpec, UpsampleSpec
from cbinfer_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "ckpts", "scene_w128.npz")


def _trained(h, w):
    jspecs = j_get_model("scene", num_classes=8, width=128)
    jparams = jckpt.load_npz_params(
        NPZ, jnet.init_params(jspecs, (h, w, 3), jax.random.PRNGKey(0)))
    specs = get_model("scene", num_classes=8, width=128)
    like = tnet.init_params(specs, (h, w, 3), device="cpu")
    return jspecs, jparams, specs, load_npz_params(NPZ, like, specs)


def test_trained_dense_apply_matches_reference():
    h, w = 64, 128
    jspecs, jparams, specs, params = _trained(h, w)
    for (jw, jb), p in zip([q for q in jparams if q is not None],
                           [q for q in params if q is not None]):
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(jw))
        np.testing.assert_array_equal(p[1].numpy(), np.asarray(jb))
    frames = JSpriteVideo(JSpriteVideoConfig(
        height=h, width=w, n_sprites=3, sprite_size=16, noise_std=0.002,
        seed=4)).clip(2)
    for f in frames:
        want = np.asarray(jnet.dense_apply(jspecs, jparams, jnp.asarray(f)))
        got = tnet.dense_apply(specs, params, torch.from_numpy(f)).numpy()
        assert got.shape == want.shape == (h // 4, w // 4, 8)
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_npz_loader_raises_on_shape_mismatch():
    specs = get_model("scene", num_classes=8, width=64)
    like = tnet.init_params(specs, (64, 128, 3), device="cpu")
    with pytest.raises(ValueError, match="w0 shape"):
        load_npz_params(NPZ, like, specs)


def test_params_from_numpy_carries_jax_init():
    jspecs = j_get_model("scene", width=16)
    jparams = jnet.init_params(jspecs, (64, 128, 3), jax.random.PRNGKey(1))
    specs = get_model("scene", width=16)
    params = params_from_numpy(
        specs, [None if p is None else (np.asarray(p[0]), np.asarray(p[1]))
                for p in jparams], device="cpu", dtype=torch.bfloat16)
    for jp, p in zip(jparams, params):
        assert (jp is None) == (p is None)
        if p is not None:
            assert p[0].dtype == torch.bfloat16 and p[1].dtype == torch.float32
            np.testing.assert_array_equal(
                p[0].float().numpy(),
                np.asarray(jp[0].astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("spec,jspec,shape", [
    (ConvSpec(features=16), JConvSpec(features=16), (20, 24, 3)),    # im2col
    (ConvSpec(features=16), JConvSpec(features=16), (20, 24, 8)),
    (ConvSpec(features=8, stride=2), JConvSpec(features=8, stride=2),
     (21, 24, 8)),
    (ConvSpec(features=8, padding="VALID", activation=None),
     JConvSpec(features=8, padding="VALID", activation=None), (20, 24, 8)),
    (ConvSpec(features=8, kernel=1, activation=None),
     JConvSpec(features=8, kernel=1, activation=None), (20, 24, 16)),
])
def test_dense_conv_matches_reference(spec, jspec, shape):
    rng = np.random.default_rng(2)
    cin = shape[2]
    kh, kw = spec.kernel
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((kh, kw, cin, spec.features)) * 0.3).astype(
        np.float32)
    b = rng.standard_normal((spec.features,)).astype(np.float32)
    want = np.asarray(jnet.dense_conv(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), jspec))
    got = tnet.dense_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), spec).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if spec.kernel == (1, 1):
        pw = tnet.pointwise_dot_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), spec).numpy()
        np.testing.assert_allclose(pw, want, atol=1e-5)


def test_dense_pool_and_flops_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 26, 4)).astype(np.float32)
    want = np.asarray(jnet.dense_pool(jnp.asarray(x), JPoolSpec()))
    got = tnet.dense_pool(torch.from_numpy(x), PoolSpec()).numpy()
    np.testing.assert_array_equal(got, want)
    for shape in [(64, 128, 3), (720, 1280, 3)]:
        assert tnet.dense_flops(get_model("scene", width=128), shape) == \
            jnet.dense_flops(j_get_model("scene", width=128), shape)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("window,stride", [(2, 1), (2, 2), (3, 1), (3, 2)])
@pytest.mark.parametrize("H,W", [(9, 13), (10, 14)])
def test_same_max_pool_equals_reference(H, W, window, stride, dtype):
    """SAME max pooling on odd and even maps: XLA pads the odd pixel of an
    even total at the end, -inf everywhere. The max of the inputs is one
    of them, so the values are equal exactly, bf16 too."""
    rng = np.random.default_rng(H * 100 + window * 10 + stride)
    x = rng.standard_normal((H, W, 5)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    kw = dict(window=(window, window), stride=(stride, stride),
              padding="SAME")
    want = jnet.dense_pool(jx, JPoolSpec(**kw))
    got = tnet.dense_pool(tx, PoolSpec(**kw))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("scale", [(2, 2), (4, 4)])
@pytest.mark.parametrize("H,W", [(5, 7), (8, 6)])
def test_bilinear_upsample_matches_reference(H, W, scale):
    """Bilinear upsampling against ``jax.image.resize``. The weights are the
    same dyadic fractions in both (1/4, 3/4 at scale 2; 1/8 .. 7/8 at 4),
    but the reference sums rows, then columns, each as a matrix product,
    and PyTorch takes the four taps in one pass: the f32 roundings differ
    by a few ulps (2^-24 each) of the inputs in reach, hence 1e-6 relative
    to the input's scale. (Relative to each output it cannot hold: where
    the taps cancel, a few ulps of the inputs are many of the result.) The
    border rows and columns copy the edge pixel in both."""
    rng = np.random.default_rng(H * W + scale[0])
    x = rng.standard_normal((H, W, 3)).astype(np.float32)
    want = np.asarray(jnet.upsample(jnp.asarray(x),
                                    JUpsampleSpec(scale=scale,
                                                  method="bilinear")))
    got = tnet.upsample(torch.from_numpy(x),
                        UpsampleSpec(scale=scale, method="bilinear")).numpy()
    assert got.shape == (H * scale[0], W * scale[1], 3)
    tol = dict(rtol=1e-6, atol=1e-6 * float(np.abs(x).max()))
    np.testing.assert_allclose(got, want, **tol)
    sh, sw = scale[0] // 2, scale[1] // 2
    np.testing.assert_allclose(got[:sh, :sw], np.broadcast_to(
        x[:1, :1], (sh, sw, 3)), **tol)
    np.testing.assert_allclose(got[-sh:, -sw:], np.broadcast_to(
        x[-1:, -1:], (sh, sw, 3)), **tol)
    nearest = tnet.upsample(torch.from_numpy(x), UpsampleSpec(scale=scale))
    np.testing.assert_array_equal(nearest.numpy(), np.asarray(jnet.upsample(
        jnp.asarray(x), JUpsampleSpec(scale=scale))))
