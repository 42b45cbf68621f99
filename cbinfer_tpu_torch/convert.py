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
from .ops import detect as detect_ops
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
        return detect_ops.tau_list(thresholds, num_cb_layers(self.specs))

    def apply(self, params: Sequence, state: List, x: torch.Tensor,
              thresholds: Optional[Sequence[float]] = None
              ) -> Tuple[torch.Tensor, List, List[Dict[str, Any]]]:
        """One frame through the CB network; ``state`` is updated in place
        and returned. ``thresholds``: optional tau per CB layer overriding
        the specs', host numbers or a float32 vector on the layers' device
        (the kernels read tau from device memory at run time, so a captured
        graph takes new values written into that vector). Returns (y,
        state, stats)."""
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


# ------------------------- torch module auto-walker -------------------------


def specs_from_torch(module: torch.nn.Module, fuse_relu: bool = True,
                     device="cuda", dtype=torch.float32):
    """Walk a sequentially executing ``nn.Module`` tree and return (specs,
    params): the CBinfer converter's own workflow (walk a pretrained
    ``nn.Sequential`` and swap its modules), with no hand-written specs.

    Supported leaves: ``Conv2d`` (groups=1; zero padding -> VALID,
    symmetric half padding of an odd stride-1 kernel -> SAME, anything else
    explicit ``(ph, pw)``), ``ReLU`` (fused into the preceding conv),
    ``BatchNorm2d`` (folded into the preceding conv at inference
    semantics: w' = w * g / sqrt(var + eps), b' = (b - mean) * g /
    sqrt(var + eps) + beta, in float64), ``MaxPool2d`` (padding 0,
    dilation 1), ``Upsample`` (nearest or bilinear, integer scale) and
    no-ops (``Identity``, ``Dropout*``, a ``Flatten`` at the tail).
    Containers are recursed in child order, which is right exactly when
    the module runs its children in sequence. Anything else raises with
    its qualified name.

    ``params`` is in the port's layout (``import_torch_state_dict``): HWIO
    weights in ``dtype`` and float32 biases, on ``device``."""
    import numpy as np
    import torch.nn as nn

    def pair(v):
        return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))

    specs: List = []
    prefixes: List[str] = []
    bn_folds: List = []  # (spec index, bn qualified name, eps)
    flatten_at: List[str] = []  # a Flatten is only a no-op at the TAIL

    def leaf(name: str, m):
        if flatten_at and not isinstance(
                m, (nn.Identity, nn.Dropout, nn.Dropout2d, nn.Flatten)):
            raise TypeError(
                f"{name}: spatial module after Flatten "
                f"({flatten_at[0]}) — Flatten is only supported as a "
                "trailing no-op (the layer IR is spatial throughout)")
        if isinstance(m, nn.Conv2d):
            if m.groups != 1:
                raise ValueError(f"{name}: grouped conv unsupported")
            kh, kw = pair(m.kernel_size)
            dh, dw = pair(m.dilation)
            sh, sw = pair(m.stride)
            if m.padding == "same":
                padding = "SAME"
            elif m.padding == "valid":
                padding = "VALID"
            else:
                ph, pw = pair(m.padding)
                if (ph, pw) == (0, 0):
                    padding = "VALID"
                elif ((ph, pw) == (dh * (kh - 1) // 2, dw * (kw - 1) // 2)
                      and kh % 2 and kw % 2 and (sh, sw) == (1, 1)):
                    padding = "SAME"  # stride 1: symmetric == SAME
                else:
                    # torch's symmetric placement differs from SAME under
                    # stride > 1: keep it explicit
                    padding = (ph, pw)
            specs.append(ConvSpec(
                features=m.out_channels, kernel=(kh, kw), stride=(sh, sw),
                dilation=(dh, dw), padding=padding, activation=None,
                use_bias=m.bias is not None))
            prefixes.append(name)
        elif isinstance(m, nn.BatchNorm2d):
            if not (specs and isinstance(specs[-1], ConvSpec)
                    and specs[-1].activation is None):
                raise ValueError(f"{name}: BatchNorm2d without a preceding "
                                 "(activation-free) conv to fold into")
            if m.running_mean is None or m.running_var is None:
                raise ValueError(f"{name}: track_running_stats=False — no "
                                 "stats to fold at inference")
            # the folded bias (b - mean) * scale + beta is nonzero even for
            # a bias-free conv, so the spec grows a bias
            if not specs[-1].use_bias:
                specs[-1] = dataclasses.replace(specs[-1], use_bias=True)
            bn_folds.append((len(specs) - 1, name, float(m.eps)))
        elif isinstance(m, nn.ReLU):
            if (fuse_relu and specs and isinstance(specs[-1], ConvSpec)
                    and specs[-1].activation is None):
                specs[-1] = dataclasses.replace(specs[-1],
                                                activation="relu")
            else:
                raise ValueError(f"{name}: standalone ReLU (no preceding "
                                 "conv to fuse into)")
        elif isinstance(m, nn.MaxPool2d):
            if pair(m.padding) != (0, 0) or pair(m.dilation) != (1, 1) \
                    or m.ceil_mode:
                raise ValueError(f"{name}: only padding=0, dilation=1, "
                                 "ceil_mode=False MaxPool2d supported")
            window = pair(m.kernel_size)
            specs.append(PoolSpec(
                window=window,
                stride=pair(m.stride) if m.stride is not None else window,
                padding="VALID"))
        elif isinstance(m, nn.Upsample):
            if m.mode not in ("nearest", "bilinear"):
                raise ValueError(f"{name}: Upsample mode {m.mode}")
            if m.scale_factor is None:
                raise ValueError(f"{name}: Upsample needs scale_factor")
            sf = m.scale_factor
            sh, sw = (sf, sf) if not isinstance(sf, (tuple, list)) else sf
            if int(sh) != sh or int(sw) != sw:
                raise ValueError(f"{name}: non-integer scale {sf}")
            specs.append(UpsampleSpec(scale=(int(sh), int(sw)),
                                      method=m.mode))
        elif isinstance(m, nn.Flatten):
            flatten_at.append(name)
        elif isinstance(m, (nn.Identity, nn.Dropout, nn.Dropout2d)):
            pass  # inference no-ops
        else:
            raise TypeError(f"{name}: unsupported module {type(m).__name__}")

    def walk(prefix: str, m):
        kids = list(m.named_children())
        if not kids:
            leaf(prefix or type(m).__name__, m)
            return
        for kname, k in kids:
            walk(f"{prefix}.{kname}" if prefix else kname, k)

    walk("", module)
    sd = module.state_dict()
    params_np = _state_dict_params(specs, sd, prefixes)
    for si, bn, eps in bn_folds:
        mean = _to_np(sd[f"{bn}.running_mean"]).astype(np.float64)
        var = _to_np(sd[f"{bn}.running_var"]).astype(np.float64)
        # affine=False stores no weight or bias: gamma 1, beta 0
        g = (_to_np(sd[f"{bn}.weight"]).astype(np.float64)
             if f"{bn}.weight" in sd else np.ones_like(mean))
        beta = (_to_np(sd[f"{bn}.bias"]).astype(np.float64)
                if f"{bn}.bias" in sd else np.zeros_like(mean))
        scale = g / np.sqrt(var + eps)
        w, b = params_np[si]
        b0 = np.zeros_like(mean) if b is None else b.astype(np.float64)
        params_np[si] = ((w.astype(np.float64) * scale).astype(w.dtype),
                         ((b0 - mean) * scale + beta).astype(np.float32))
    from .checkpoint import params_from_numpy
    return specs, params_from_numpy(specs, params_np, device, dtype)


def _to_np(t):
    import numpy as np
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t)


def _state_dict_params(specs: Sequence, state_dict: Dict[str, Any],
                       conv_prefixes: Optional[Sequence[str]]) -> List:
    """numpy HWIO ``(w, b)`` per conv of ``specs`` out of a torch
    ``state_dict`` (OIHW weights), ``None`` elsewhere."""
    if conv_prefixes is None:
        conv_prefixes = [k[:-len(".weight")] for k in state_dict
                         if k.endswith(".weight")
                         and _to_np(state_dict[k]).ndim == 4]
    params: List = []
    it = iter(conv_prefixes)
    for spec in specs:
        if not isinstance(spec, ConvSpec):
            params.append(None)
            continue
        prefix = next(it)
        w = _to_np(state_dict[f"{prefix}.weight"])  # OIHW
        if w.shape[2:] != tuple(spec.kernel) or w.shape[0] != spec.features:
            raise ValueError(f"{prefix}: torch weight {w.shape} does not "
                             f"match spec {spec}")
        b_key = f"{prefix}.bias"
        b = (_to_np(state_dict[b_key])
             if spec.use_bias and b_key in state_dict else None)
        params.append((w.transpose(2, 3, 1, 0), b))  # OIHW -> HWIO
    return params


def import_torch_state_dict(specs: Sequence, state_dict: Dict[str, Any],
                            conv_prefixes: Optional[Sequence[str]] = None,
                            device="cuda", dtype=torch.float32) -> List:
    """Map a torch ``state_dict`` (OIHW conv weights) onto the spec chain.

    Conv layers take weight/bias pairs in the order they appear in
    ``state_dict``, or by ``conv_prefixes`` (e.g. ``["features.0",
    "features.3"]``). Returns the port's params aligned with ``specs``:
    HWIO weights in ``dtype``, float32 biases, on ``device``."""
    from .checkpoint import params_from_numpy
    return params_from_numpy(
        specs, _state_dict_params(specs, state_dict, conv_prefixes),
        device, dtype)
