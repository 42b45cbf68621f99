"""The torch-module importer of the port (``convert.specs_from_torch``,
``convert.import_torch_state_dict``) against the JAX package's on the same
modules: equal specs, equal params (HWIO weights, BatchNorm folded in
float64 as the reference folds it), the port's dense output equal to
``module(x)`` within 1e-5 in float32, and the same rejections with the
same messages."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu.config import ConvSpec as JConvSpec
from cbinfer_tpu.config import PoolSpec as JPoolSpec

from cbinfer_tpu_torch import network
from cbinfer_tpu_torch.config import (ConvSpec, PipelineConfig, PoolSpec,
                                      TileConfig)
from cbinfer_tpu_torch.convert import (convert, import_torch_state_dict,
                                       specs_from_torch)

CPU = PipelineConfig(device="cpu")


def _plain():
    return nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(),
                         nn.MaxPool2d(2), nn.Conv2d(8, 5, 1))


def _nested():
    return nn.Sequential(
        nn.Conv2d(3, 16, 3, padding=1), nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Sequential(
            nn.Conv2d(16, 32, 3, padding=2, dilation=2), nn.ReLU(),
            nn.Conv2d(32, 32, 3, stride=2, padding=1), nn.ReLU(),
        ),
        nn.Dropout(0.5),
        nn.Conv2d(32, 8, 1),
        nn.Upsample(scale_factor=2, mode="nearest"),
    )


def _strided():
    return nn.Sequential(
        nn.Conv2d(3, 8, 3, stride=2, padding=1), nn.ReLU(),
        nn.Conv2d(8, 8, 5, stride=2, padding=2), nn.ReLU(),
    )


def _batchnorm():
    model = nn.Sequential(
        nn.Conv2d(3, 16, 3, padding=1, bias=False),
        nn.BatchNorm2d(16), nn.ReLU(),
        nn.MaxPool2d(2),
        nn.Conv2d(16, 8, 3, padding=1),
        nn.BatchNorm2d(8), nn.ReLU(),
        nn.Conv2d(8, 8, 1),
        nn.BatchNorm2d(8, affine=False),
        nn.Flatten(),
    )
    model.train()
    with torch.no_grad():
        for _ in range(3):  # non-trivial running stats
            model(torch.randn(2, 3, 16, 16))
        model[1].weight += 0.3 * torch.randn_like(model[1].weight)
        model[1].bias += 0.2 * torch.randn_like(model[1].bias)
    return model


MODULES = {
    "plain": (_plain, (16, 16, 3)),
    "nested": (_nested, (32, 32, 3)),
    "strided": (_strided, (30, 46, 3)),   # odd sizes
    "batchnorm": (_batchnorm, (16, 16, 3)),
}


def _module(name):
    torch.manual_seed(7)
    return MODULES[name][0]().eval()


def _torch_forward(model, x):
    with torch.no_grad():
        y = model(torch.from_numpy(x.transpose(2, 0, 1)[None]))
    return y[0].numpy().transpose(1, 2, 0)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_specs_and_params_equal_the_reference(name):
    model = _module(name)
    jspecs, jparams = jconvert.specs_from_torch(model)
    specs, params = specs_from_torch(model, device="cpu")
    assert [type(s).__name__ for s in specs] == \
        [type(s).__name__ for s in jspecs]
    for s, js in zip(specs, jspecs):
        assert dataclasses.asdict(s) == dataclasses.asdict(js)
    for p, jp in zip(params, jparams):
        if jp is None:
            assert p is None
            continue
        assert p[0].dtype == torch.float32
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(jp[0]))
        if jp[1] is None:
            assert p[1] is None
        else:
            np.testing.assert_array_equal(p[1].numpy(), np.asarray(jp[1]))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_dense_output_equals_the_module(name):
    model = _module(name)
    shape = MODULES[name][1]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    specs, params = specs_from_torch(model, device="cpu")
    y = network.dense_apply(specs, params, torch.from_numpy(x), CPU)
    # a trailing Flatten is a no-op of the specs: compare before it
    yt = _torch_forward(model[:-1] if name == "batchnorm" else model, x)
    assert tuple(y.shape) == yt.shape
    np.testing.assert_allclose(y.numpy(), yt, atol=1e-5, rtol=0)


def test_state_dict_import_and_cb_net_at_tau_zero():
    """Hand-written specs take the module's weights; the converted CB net
    at tau = 0 gives the module's output too."""
    model = _module("plain")
    specs = [ConvSpec(features=8, threshold=0.0), PoolSpec(threshold=0.0),
             ConvSpec(features=5, kernel=(1, 1), activation=None,
                      threshold=0.0)]
    jspecs = [JConvSpec(features=8, threshold=0.0), JPoolSpec(threshold=0.0),
              JConvSpec(features=5, kernel=(1, 1), activation=None,
                        threshold=0.0)]
    params = import_torch_state_dict(specs, model.state_dict(),
                                     device="cpu")
    jparams = jconvert.import_torch_state_dict(jspecs, model.state_dict())
    for p, jp in zip(params, jparams):
        if jp is not None:
            np.testing.assert_array_equal(p[0].numpy(), np.asarray(jp[0]))
            np.testing.assert_array_equal(p[1].numpy(), np.asarray(jp[1]))
    assert tuple(params[0][0].shape) == (3, 3, 3, 8)
    x = np.random.default_rng(5).random((16, 16, 3)).astype(np.float32)
    yt = _torch_forward(model, x)
    net = convert(specs, (16, 16, 3),
                  PipelineConfig(tile=TileConfig(8, 8), device="cpu"))
    y, _, _ = net.apply(params, net.init_state(), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), yt, atol=1e-5, rtol=0)


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    raise AssertionError("expected an exception")


@pytest.mark.parametrize("case", [
    "sigmoid", "grouped", "standalone_relu", "bn_first", "mid_flatten",
    "shape_mismatch"])
def test_same_rejections_as_the_reference(case):
    mods = {
        "sigmoid": lambda: nn.Sequential(nn.Conv2d(3, 4, 3, padding=1),
                                         nn.Sigmoid()),
        "grouped": lambda: nn.Sequential(
            nn.Conv2d(4, 4, 3, padding=1, groups=4)),
        "standalone_relu": lambda: nn.Sequential(nn.ReLU(),
                                                 nn.Conv2d(3, 4, 3)),
        "bn_first": lambda: nn.Sequential(nn.BatchNorm2d(3),
                                          nn.Conv2d(3, 4, 3)),
        "mid_flatten": lambda: nn.Sequential(
            nn.Conv2d(3, 4, 3, padding=1), nn.Flatten(),
            nn.Conv2d(4, 4, 3, padding=1)),
    }
    if case == "shape_mismatch":
        sd = nn.Sequential(nn.Conv2d(3, 8, 5, padding=2)).state_dict()
        got = _raises(lambda: import_torch_state_dict(
            [ConvSpec(features=8)], sd, device="cpu"))
        want = _raises(lambda: jconvert.import_torch_state_dict(
            [JConvSpec(features=8)], sd))
        assert got[0] is want[0] is ValueError
        assert "does not match" in got[1]
        return
    model = mods[case]()
    got = _raises(lambda: specs_from_torch(model, device="cpu"))
    want = _raises(lambda: jconvert.specs_from_torch(model))
    assert got == want


def test_importer_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        specs_from_torch(_module("plain"))
