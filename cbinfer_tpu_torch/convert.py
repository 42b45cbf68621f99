"""Network converter: dense spec chain -> change-based network (PyTorch
port of the sequential part of ``cbinfer_tpu.convert``).

``CBNet`` holds the specs and config; its state is a list of per-layer
``CBLayerState`` updated IN PLACE by ``apply`` and ``apply_refresh`` (the
JAX package threads a donated pytree instead). Params are the port's
``(w, b)`` tensors, HWIO weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import layers as L
from . import network
from .config import ConvSpec, PipelineConfig, PoolSpec, UpsampleSpec
from .netview import NetView, hint_reaches
from .ops import flat4 as flat4_ops


def dense_conv_on_feature(x, p, spec: ConvSpec, compute_dtype):
    """Dense conv of a layer output that may be a padded Feature. A
    pointwise conv runs straight on the padded storage and crops its small
    output (cropping commutes with a 1x1 window) unless the storage has
    pad channels; everything else crops first."""
    w, b = p
    if (isinstance(x, L.Feature) and x.data.shape[-1] == x.c
            and spec.kernel == (1, 1)
            and spec.stride == (1, 1) and spec.dilation == (1, 1)):
        y = network.pointwise_dot_conv(x.data, w, b, spec, compute_dtype)
        return y[:x.h, :x.w]
    x = x.crop() if isinstance(x, L.Feature) else x
    return network.dense_conv(x, w, b, spec, compute_dtype)


def _as_array(v):
    return v.crop() if isinstance(v, L.Feature) else v


def _output(v):
    """A network's output: a copy when it would be a view of a cache that
    the next frame updates in place."""
    return v.crop().clone() if isinstance(v, L.Feature) else v


@dataclasses.dataclass(frozen=True)
class CBNet:
    """A converted change-based network.

    Usage:
        net = convert_flagship(specs, in_shape, cfg)
        state = net.init_state()
        for frame in video:
            y, state, stats = net.apply(params, state, frame)
    """

    specs: Tuple[Any, ...]
    in_shape: Tuple[int, int, int]
    cfg: PipelineConfig

    def init_state(self) -> List[Optional[L.CBLayerState]]:
        states: List[Optional[L.CBLayerState]] = []
        shape = self.in_shape
        for spec, out_shape in zip(self.specs,
                                   network.out_shapes(self.specs,
                                                      self.in_shape)):
            is_cb = isinstance(spec, (ConvSpec, PoolSpec)) and spec.use_cb
            states.append(L.cb_layer_init(spec, shape, self.cfg) if is_cb
                          else None)
            shape = out_shape
        return states

    def _taus(self, thresholds):
        if thresholds is None:
            return None
        taus = [float(t) for t in thresholds]
        if len(taus) != num_cb_layers(self.specs):
            raise ValueError(f"got {len(taus)} thresholds for "
                             f"{num_cb_layers(self.specs)} CB layers")
        return taus

    def apply(self, params: Sequence, state: List, x: torch.Tensor,
              thresholds: Optional[Sequence[float]] = None
              ) -> Tuple[torch.Tensor, List, List[Dict[str, Any]]]:
        """One frame through the CB network; ``state`` is updated in place
        and returned. ``thresholds``: optional host-side tau per CB layer
        overriding the specs' (floats: the kernels take tau by value, so
        no device read is needed). Returns (y, state, stats)."""
        taus = self._taus(thresholds)
        dtype = network.torch_dtype(self.cfg.compute_dtype)
        stats: List[Dict[str, Any]] = []
        cb_i = 0
        hint = None  # dirty hint chained between CB layers
        for k, (spec, p, st) in enumerate(zip(self.specs, params, state)):
            tau = None
            if (taus is not None and isinstance(spec, (ConvSpec, PoolSpec))
                    and spec.use_cb):
                tau = taus[cb_i]
                cb_i += 1
            if isinstance(spec, ConvSpec) and spec.use_cb:
                fuse_ctx = None
                if spec.fuse_next_detect and k + 1 < len(self.specs):
                    # hand the producer its consumer's cache and tau (cb_i
                    # already points at the consumer's slot); the fused
                    # kernel updates that cache in place and the consumer's
                    # detect is then served by hint.predetect
                    s2 = self.specs[k + 1]
                    if (isinstance(s2, ConvSpec) and s2.use_cb
                            and not s2.forward_hint
                            and state[k + 1] is not None):
                        fuse_ctx = L.FuseCtx(
                            spec=s2, in_cache=state[k + 1].in_cache,
                            tau=taus[cb_i] if taus is not None else None)
                x, st, s, hint = L.cb_conv_apply(p, st, x, spec, self.cfg,
                                                 tau, hint, fuse_ctx=fuse_ctx)
            elif isinstance(spec, ConvSpec):
                x = dense_conv_on_feature(x, p, spec, dtype)
                s, hint = {}, None
            elif isinstance(spec, PoolSpec) and spec.use_cb:
                x, st, s, hint = L.cb_pool_apply(st, x, spec, self.cfg, tau,
                                                 hint)
            elif isinstance(spec, PoolSpec):
                x = network.dense_pool(_as_array(x), spec)
                s, hint = {}, None
            elif isinstance(spec, UpsampleSpec):
                x = network.upsample(_as_array(x), spec)
                s, hint = {}, None
            else:
                raise TypeError(spec)
            stats.append(s)
        return _output(x), state, stats

    def apply_dense(self, params: Sequence, x: torch.Tensor) -> torch.Tensor:
        return network.dense_apply(self.specs, params, x, self.cfg)

    def apply_refresh(self, params: Sequence, state: List, x: torch.Tensor,
                      thresholds: Optional[Sequence[float]] = None):
        """Full-refresh frame: accept everything and recompute everything
        with the dense ops. Same signature and results structure as
        ``apply``; ``thresholds`` is ignored (a refresh is tau = -inf)."""
        del thresholds
        dtype = network.torch_dtype(self.cfg.compute_dtype)
        stats: List[Dict[str, Any]] = []
        for spec, p, st in zip(self.specs, params, state):
            if isinstance(spec, ConvSpec) and spec.use_cb:
                x, st, s, _ = L.cb_conv_refresh(p, st, x, spec, self.cfg)
            elif isinstance(spec, ConvSpec):
                x = dense_conv_on_feature(x, p, spec, dtype)
                s = {}
            elif isinstance(spec, PoolSpec) and spec.use_cb:
                x, st, s, _ = L.cb_pool_refresh(st, x, spec, self.cfg)
            elif isinstance(spec, PoolSpec):
                x = network.dense_pool(_as_array(x), spec)
                s = {}
            elif isinstance(spec, UpsampleSpec):
                x = network.upsample(_as_array(x), spec)
                s = {}
            else:
                raise TypeError(spec)
            stats.append(s)
        return _output(x), state, stats


def convert(specs: Sequence, in_shape: Tuple[int, int, int],
            cfg: Optional[PipelineConfig] = None,
            thresholds: Optional[Sequence[float]] = None,
            dense_layers: Sequence[int] = (),
            backend_overrides: Optional[Dict[int, str]] = None) -> CBNet:
    """Bind per-layer thresholds, dense layers and backend overrides to a
    dense layer-spec chain."""
    cfg = cfg or PipelineConfig()
    if thresholds is not None:
        n_cb = num_cb_layers(specs)
        if len(thresholds) != n_cb:
            raise ValueError(
                f"got {len(thresholds)} thresholds for {n_cb} CB layers")
    new_specs = []
    ti = 0
    for i, spec in enumerate(specs):
        if isinstance(spec, (ConvSpec, PoolSpec)):
            changes: Dict[str, Any] = {}
            if thresholds is not None and spec.use_cb:
                changes["threshold"] = float(thresholds[ti])
                ti += 1
            if i in dense_layers:
                changes["use_cb"] = False
            if backend_overrides and i in backend_overrides:
                changes["backend"] = backend_overrides[i]
            spec = dataclasses.replace(spec, **changes) if changes else spec
        new_specs.append(spec)
    return CBNet(specs=tuple(new_specs), in_shape=tuple(in_shape), cfg=cfg)


def num_cb_layers(specs: Sequence) -> int:
    return sum(1 for s in specs
               if isinstance(s, (ConvSpec, PoolSpec)) and s.use_cb)


def flagship_layers(specs: Sequence,
                    in_shape: Optional[Tuple[int, int, int]] = None,
                    cfg: Optional[PipelineConfig] = None):
    """(backend_overrides, dense_layers) of the shipped configuration, by
    the JAX package's gate with ``"pallas"`` read as ``"cuda"``: a small-
    cin stem runs ``patch_stem`` (the sparse stem kernels) where the flat4
    gate holds, otherwise ``dense_cached``; a trailing 1x1 classifier runs
    dense."""
    small_stem = in_shape is None or in_shape[2] < 128
    overrides: Dict[int, str] = {}
    if isinstance(specs[0], ConvSpec) and small_stem:
        s0 = specs[0]
        if (cfg is not None and cfg.backend == "cuda"
                and in_shape is not None
                and flat4_ops.supports(in_shape, s0.kernel, s0.stride,
                                       s0.dilation, s0.padding,
                                       s0.activation)):
            overrides = {0: "patch_stem"}
        else:
            overrides = {0: "dense_cached"}
    dense = []
    i = len(specs) - 1
    while i > 0 and isinstance(specs[i], UpsampleSpec):
        i -= 1
    if i > 0 and isinstance(specs[i], ConvSpec) \
            and specs[i].kernel == (1, 1):
        dense.append(i)
    return overrides, dense


def convert_flagship(specs: Sequence, in_shape: Tuple[int, int, int],
                     cfg: Optional[PipelineConfig] = None,
                     thresholds: Optional[Sequence[float]] = None,
                     extra_overrides: Optional[Dict[int, str]] = None,
                     fuse_detect: bool = False) -> CBNet:
    """Convert with the shipped layer policy (see flagship_layers), then
    run aligned pools hint-forwarded, eliding the input cache where the
    fused pool gate provably holds and the producer always hints.
    ``extra_overrides`` layers per-index backend choices on top (the extra
    wins). Its special value ``"forward_hint"`` sets the spec's
    mask-forwarding mode instead of a backend: the layer skips detection
    and recomputes its producer's hint region unconditionally (a
    value-exact superset; its tau slot stays in the vector, unused).
    ``fuse_detect=True`` additionally marks every plain ``"cuda"`` CB conv
    whose next layer is a detecting CB conv for the fused conv + consumer
    detect kernel (``ConvSpec.fuse_next_detect``): bit-identical either
    way, so tuned taus stay valid.
    """
    cfg = cfg or PipelineConfig()
    overrides, dense = flagship_layers(specs, in_shape, cfg)
    if extra_overrides:
        bad = [k for k in extra_overrides if not 0 <= k < len(specs)]
        if bad:
            raise ValueError(f"extra_overrides: layer index(es) {bad} out "
                             f"of range for {len(specs)} specs")
        fwd = [k for k, v in extra_overrides.items() if v == "forward_hint"]
        overrides = {**overrides, **{k: v for k, v in extra_overrides.items()
                                     if v != "forward_hint"}}
        specs = tuple(dataclasses.replace(s, forward_hint=True)
                      if i in fwd else s for i, s in enumerate(specs))
    net = convert(specs, in_shape, cfg, dense_layers=dense,
                  backend_overrides=overrides)
    shapes = [tuple(in_shape)] + network.out_shapes(net.specs, in_shape)
    view = NetView.from_specs(net.specs, in_shape, cfg)
    new_specs = []
    for i, s in enumerate(net.specs):
        if isinstance(s, PoolSpec) and s.use_cb and s.window == s.stride:
            s = dataclasses.replace(s, forward_hint=True)
            lcfg = L._layer_cfg(s, cfg)
            g = L._geometry(s, shapes[i], lcfg)
            if L.fused_pool_gate(s, g, lcfg) and hint_reaches(view, i):
                s = dataclasses.replace(s, elide_in_cache=True)
        new_specs.append(s)
    for i in range(len(new_specs) - 1 if fuse_detect else 0):
        if L.fuse_next_gate(new_specs[i], new_specs[i + 1], shapes[i], cfg):
            new_specs[i] = dataclasses.replace(new_specs[i],
                                               fuse_next_detect=True)
    net = dataclasses.replace(net, specs=tuple(new_specs))
    if thresholds is not None:
        net = convert(net.specs, in_shape, cfg, thresholds=thresholds)
    return net
