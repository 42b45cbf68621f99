"""The port's IR, geometry and flagship conversion against the JAX
package's: every TileGeometry field of every scene layer, the converted
specs field for field ("pallas" read as "cuda"), the stem policy, and the
config JSON round trip."""

import dataclasses

import pytest

from cbinfer_tpu import convert as jconvert
from cbinfer_tpu import layers as jlayers
from cbinfer_tpu.config import PipelineConfig as JCfg
from cbinfer_tpu.config import TileConfig as JTile
from cbinfer_tpu.models import get_model as j_get_model
from cbinfer_tpu.network import out_shapes as j_out_shapes

from cbinfer_tpu_torch import config as tconfig
from cbinfer_tpu_torch import layers as tlayers
from cbinfer_tpu_torch.config import PipelineConfig, TileConfig
from cbinfer_tpu_torch.convert import convert_flagship, flagship_layers
from cbinfer_tpu_torch.models import get_model
from cbinfer_tpu_torch.network import out_shapes

SHAPES = [(64, 128, 3), (720, 1280, 3)]
STEM = {0: "dense_cached"}


def _nets(in_shape, width=128, model="scene"):
    jcfg = JCfg(tile=JTile(8, 8, 0.375), backend="pallas", interpret=True)
    tcfg = PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu")
    jnet = jconvert.convert_flagship(
        j_get_model(model, width=width), in_shape, jcfg,
        extra_overrides=STEM)
    tnet = convert_flagship(get_model(model, width=width), in_shape, tcfg,
                            extra_overrides=STEM)
    return jnet, tnet


def _as_dicts(specs, pallas_to_cuda=False):
    out = []
    for s in specs:
        d = dataclasses.asdict(s)
        if pallas_to_cuda and d.get("backend") == "pallas":
            d["backend"] = "cuda"
        out.append(d)
    return out


@pytest.mark.parametrize("in_shape", SHAPES)
def test_tile_geometry_matches_every_layer(in_shape):
    """At full width (w128) the JAX package's 128-lane padding is the
    identity, so every field must agree, storage margins included."""
    jnet, tnet = _nets(in_shape)
    jshapes = [in_shape] + j_out_shapes(jnet.specs, in_shape)
    tshapes = [in_shape] + out_shapes(tnet.specs, in_shape)
    assert [tuple(s) for s in tshapes] == [tuple(s) for s in jshapes]
    for i, (js, ts) in enumerate(zip(jnet.specs, tnet.specs)):
        jcfg = jlayers._layer_cfg(js, jnet.cfg)
        h, w, c = jshapes[i]
        cpad = c if js.backend == "dense_cached" else jlayers.lane_pad(
            c, jcfg)
        jg = jlayers._geometry(js, (h, w, cpad), jcfg)
        tg = tlayers._geometry(ts, tshapes[i], tlayers._layer_cfg(ts, tnet.cfg))
        assert dataclasses.asdict(tg) == dataclasses.asdict(jg), i


@pytest.mark.parametrize("in_shape", SHAPES)
@pytest.mark.parametrize("width", [16, 128])
def test_flagship_specs_match(in_shape, width):
    jnet, tnet = _nets(in_shape, width)
    assert _as_dicts(tnet.specs) == _as_dicts(jnet.specs, True)
    # the slice's path: dense_cached stem, forward-hint pools with elided
    # input caches, kernel convs, dense 1x1 classifier
    kinds = [(s.kind, s.backend, getattr(s, "elide_in_cache", None),
              s.use_cb) for s in tnet.specs]
    assert kinds == [("conv", "dense_cached", None, True),
                     ("pool", None, True, True), ("conv", None, None, True),
                     ("pool", None, True, True), ("conv", None, None, True),
                     ("conv", None, None, True), ("conv", None, None, False)]


def test_flagship_thresholds_bind_like_reference():
    taus = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]
    jcfg = JCfg(tile=JTile(8, 8), backend="pallas", interpret=True)
    jnet = jconvert.convert_flagship(j_get_model("scene", width=16),
                                     (64, 128, 3), jcfg, thresholds=taus,
                                     extra_overrides=STEM)
    tnet = convert_flagship(get_model("scene", width=16), (64, 128, 3),
                            PipelineConfig(device="cpu"), thresholds=taus,
                            extra_overrides=STEM)
    assert _as_dicts(tnet.specs) == _as_dicts(jnet.specs, True)


def test_flagship_raises_where_reference_picks_patch_stem():
    """Named for what it guarded before the sparse stem was ported: the
    port now selects ``patch_stem`` exactly where the reference does, and
    the converted specs are the reference's."""
    specs = get_model("scene", width=16)
    jspecs = j_get_model("scene", width=16)
    cfg = PipelineConfig(device="cpu")
    jcfg = JCfg(backend="pallas")
    for in_shape, want in [((720, 1280, 3), {0: "patch_stem"}),
                           ((64, 128, 3), {0: "patch_stem"}),
                           ((64, 120, 3), {0: "dense_cached"}),   # W % 32
                           ((60, 128, 3), {0: "dense_cached"}),   # H % 8
                           ((64, 128, 4), {0: "dense_cached"}),   # cin > 3
                           ((64, 128, 256), {})]:                 # wide stem
        over, dense = flagship_layers(specs, in_shape, cfg)
        j_over, j_dense = jconvert.flagship_layers(jspecs, in_shape, jcfg)
        assert (over, dense) == (j_over, j_dense) == (want, [6]), in_shape
    # a pipeline that is not on the kernel backend keeps dense_cached
    assert flagship_layers(specs, (720, 1280, 3), PipelineConfig(
        backend="dense_cached", device="cpu"))[0] == {0: "dense_cached"}
    assert flagship_layers(specs)[0] == {0: "dense_cached"}
    for in_shape in SHAPES:
        for width in (16, 128):
            jnet = jconvert.convert_flagship(
                j_get_model("scene", width=width), in_shape,
                JCfg(tile=JTile(8, 8, 0.375), backend="pallas",
                     interpret=True))
            tnet = convert_flagship(
                get_model("scene", width=width), in_shape,
                PipelineConfig(tile=TileConfig(8, 8, 0.375), device="cpu"))
            assert _as_dicts(tnet.specs) == _as_dicts(jnet.specs, True)
            assert tnet.specs[0].backend == "patch_stem"
            # the stem's caches: (8, 32) kernel tiles on the same storage
            # the dense_cached stem uses
            g = tlayers._geometry(tnet.specs[0], in_shape, tlayers._layer_cfg(
                tnet.specs[0], tnet.cfg))
            assert (g.th, g.tw, g.n_tiles) == (
                8, 32, (in_shape[0] // 8) * (in_shape[1] // 32))


def test_config_json_round_trip():
    cfg = PipelineConfig(tile=TileConfig(8, 8, 0.375),
                         compute_dtype="bfloat16", cache_dtype="bfloat16",
                         device="cpu")
    assert tconfig.from_json(tconfig.to_json(cfg)) == cfg
    specs = get_model("scene", width=32)
    assert tconfig.from_json(tconfig.to_json(specs)) == specs
    assert PipelineConfig().backend == "cuda"
    assert PipelineConfig().device == "cuda"
