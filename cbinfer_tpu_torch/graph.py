"""DAG networks with concatenation (PyTorch port of ``cbinfer_tpu.graph``).

OpenPose is not sequential: each refinement stage reads the backbone
features concatenated with the previous stage's two branch outputs (arXiv
1808.05488 §VI). A ``GraphNode`` names its predecessors; ``ConcatSpec``
merges along channels. CB layers behave exactly as in ``layers.py`` (the
topology is plumbing), and dirty hints merge at a concat: the OR of the
input hints, on the same 8x8 grid, or none if an input has none.

A node's spec is any sequential LayerSpec or a ``ConcatSpec``; the nodes
are in topological order (a node reads only earlier nodes or "input").
As ``CBNet``, a ``CBGraphNet`` updates its state, a dict of per-node
``CBLayerState`` (``None`` for a node without caches), in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import layers as L
from . import network
from .config import ConvSpec, PipelineConfig, PoolSpec, UpsampleSpec
from .convert import _as_array, _output, dense_conv_on_feature
from .netview import NetView, hint_reaches
from .ops import detect as detect_ops
from .ops import flat4 as flat4_ops
from .ops.geometry import conv_out_size, pad_dim


@dataclasses.dataclass(frozen=True)
class ConcatSpec:
    kind: str = "concat"


@dataclasses.dataclass(frozen=True)
class GraphNode:
    name: str
    spec: Any                       # LayerSpec | ConcatSpec
    inputs: Tuple[str, ...] = ("input",)

    def __post_init__(self):
        object.__setattr__(self, "inputs", tuple(self.inputs))


def node_out_shapes(nodes: Sequence[GraphNode],
                    in_shape: Tuple[int, int, int]
                    ) -> Dict[str, Tuple[int, int, int]]:
    """Logical (H, W, C) of every node's output, and of "input"."""
    shapes: Dict[str, Tuple[int, int, int]] = {"input": tuple(in_shape)}
    for n in nodes:
        ins = [shapes[i] for i in n.inputs]
        if isinstance(n.spec, ConcatSpec):
            h, w = ins[0][:2]
            assert all(s[:2] == (h, w) for s in ins), (n.name, ins)
            shapes[n.name] = (h, w, sum(s[2] for s in ins))
        elif isinstance(n.spec, ConvSpec):
            h, w, _ = ins[0]
            shapes[n.name] = (
                conv_out_size(h, n.spec.kernel[0], n.spec.stride[0],
                              n.spec.dilation[0], pad_dim(n.spec.padding, 0)),
                conv_out_size(w, n.spec.kernel[1], n.spec.stride[1],
                              n.spec.dilation[1], pad_dim(n.spec.padding, 1)),
                n.spec.features)
        elif isinstance(n.spec, PoolSpec):
            h, w, c = ins[0]
            shapes[n.name] = (
                conv_out_size(h, n.spec.window[0], n.spec.stride[0], 1,
                              pad_dim(n.spec.padding, 0)),
                conv_out_size(w, n.spec.window[1], n.spec.stride[1], 1,
                              pad_dim(n.spec.padding, 1)), c)
        elif isinstance(n.spec, UpsampleSpec):
            h, w, c = ins[0]
            shapes[n.name] = (h * n.spec.scale[0], w * n.spec.scale[1], c)
        else:
            raise TypeError(n.spec)
    return shapes


def init_graph_params(nodes: Sequence[GraphNode],
                      in_shape: Tuple[int, int, int], seed: int = 0,
                      device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """He-normal conv weights (numpy generator from ``seed``), zero
    biases, by conv node name. The values differ from the JAX package's
    ``init_graph_params`` (another generator); carry those across with
    ``checkpoint.graph_params_from_numpy`` when parity is needed."""
    dev = network.resolve_device(device)
    rng = np.random.default_rng(seed)
    shapes = node_out_shapes(nodes, in_shape)
    params: Dict[str, Any] = {}
    for n in nodes:
        if isinstance(n.spec, ConvSpec):
            cin = shapes[n.inputs[0]][2]
            kh, kw = n.spec.kernel
            w = (rng.standard_normal((kh, kw, cin, n.spec.features))
                 * math.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)
            b = (torch.zeros((n.spec.features,), dtype=torch.float32,
                             device=dev) if n.spec.use_bias else None)
            params[n.name] = (torch.from_numpy(w).to(dev, dtype), b)
    return params


def _is_cb(spec) -> bool:
    return isinstance(spec, (ConvSpec, PoolSpec)) and spec.use_cb


@dataclasses.dataclass(frozen=True)
class CBGraphNet:
    """Change-based DAG network; the same contract as ``convert.CBNet``,
    with name-keyed params, state and stats."""

    nodes: Tuple[GraphNode, ...]
    in_shape: Tuple[int, int, int]
    cfg: PipelineConfig
    output: str  # name of the output node

    def init_state(self) -> Dict[str, Optional[L.CBLayerState]]:
        shapes = node_out_shapes(self.nodes, self.in_shape)
        return {n.name: (L.cb_layer_init(n.spec, shapes[n.inputs[0]],
                                         self.cfg) if _is_cb(n.spec)
                         else None)
                for n in self.nodes}

    def fused_consumer_map(self) -> Dict[str, str]:
        """producer node -> the consumer whose detect its fused kernel runs
        (``ConvSpec.fuse_next_detect`` on a DAG): the FIRST CB conv in
        topological order that reads only the producer and detects. The
        converter gates on the same rule. Every other reader of the
        producer's hint gets the predetect stripped: it holds one layer's
        cache."""
        out: Dict[str, str] = {}
        for n in self.nodes:
            if not (isinstance(n.spec, ConvSpec)
                    and getattr(n.spec, "fuse_next_detect", False)):
                continue
            for c in self.nodes:
                if (c.inputs == (n.name,) and isinstance(c.spec, ConvSpec)
                        and c.spec.use_cb and not c.spec.forward_hint):
                    out[n.name] = c.name
                    break
        return out

    def _cb_indices(self) -> Dict[str, int]:
        """CB node -> its slot in the threshold vector."""
        ix, i = {}, 0
        for n in self.nodes:
            if _is_cb(n.spec):
                ix[n.name] = i
                i += 1
        return ix

    def num_cb_layers(self) -> int:
        return sum(1 for n in self.nodes if _is_cb(n.spec))

    def _taus(self, thresholds):
        if thresholds is None:
            return None
        return detect_ops.tau_list(thresholds, self.num_cb_layers())

    def apply(self, params: Dict[str, Any], state: Dict[str, Any],
              x: torch.Tensor, thresholds: Optional[Sequence[float]] = None):
        """One frame through the CB graph; ``state`` is updated in place
        and returned. ``thresholds``: optional tau per CB node, in
        topological order, host numbers or a float32 vector on the nodes'
        device (see ``CBNet.apply``). Returns (y, state, stats by node
        name)."""
        taus = self._taus(thresholds)
        dtype = network.torch_dtype(self.cfg.compute_dtype)
        vals: Dict[str, Any] = {"input": x}
        hints: Dict[str, Optional[L.DirtyHint]] = {"input": None}
        stats: Dict[str, Dict[str, Any]] = {}
        fused_map = self.fused_consumer_map()
        cb_ix = self._cb_indices()
        by_name = {n.name: n for n in self.nodes}
        for n in self.nodes:
            xin = vals[n.inputs[0]]
            hint = hints[n.inputs[0]]
            if (hint is not None and hint.predetect is not None
                    and fused_map.get(n.inputs[0]) != n.name):
                # not the consumer the producer's fused kernel served: the
                # predetect belongs to another layer's cache
                hint = hint._replace(predetect=None)
            tau = taus[cb_ix[n.name]] if (taus is not None
                                          and _is_cb(n.spec)) else None
            if isinstance(n.spec, ConcatSpec):
                vals[n.name] = torch.cat(
                    [_as_array(vals[i]) for i in n.inputs], dim=-1)
                in_hints = [hints[i] for i in n.inputs]
                if any(h is None for h in in_hints):
                    hints[n.name] = None
                else:
                    m = in_hints[0].mask
                    for h in in_hints[1:]:
                        m = m | h.mask
                    hints[n.name] = L.DirtyHint(mask=m)
                stats[n.name] = {}
            elif isinstance(n.spec, ConvSpec) and n.spec.use_cb:
                fuse_ctx = None
                cons = fused_map.get(n.name)
                if cons is not None and state.get(cons) is not None:
                    fuse_ctx = L.FuseCtx(
                        spec=by_name[cons].spec,
                        in_cache=state[cons].in_cache,
                        tau=taus[cb_ix[cons]] if taus is not None else None)
                y, _, s, h = L.cb_conv_apply(
                    params[n.name], state[n.name], xin, n.spec, self.cfg,
                    tau, hint, fuse_ctx=fuse_ctx)
                vals[n.name], hints[n.name], stats[n.name] = y, h, s
            elif isinstance(n.spec, ConvSpec):
                vals[n.name] = dense_conv_on_feature(xin, params[n.name],
                                                     n.spec, dtype)
                hints[n.name], stats[n.name] = None, {}
            elif isinstance(n.spec, PoolSpec) and n.spec.use_cb:
                y, _, s, h = L.cb_pool_apply(state[n.name], xin, n.spec,
                                             self.cfg, tau, hint)
                vals[n.name], hints[n.name], stats[n.name] = y, h, s
            elif isinstance(n.spec, PoolSpec):
                vals[n.name] = network.dense_pool(_as_array(xin), n.spec)
                hints[n.name], stats[n.name] = None, {}
            elif isinstance(n.spec, UpsampleSpec):
                vals[n.name] = network.upsample(_as_array(xin), n.spec)
                hints[n.name], stats[n.name] = None, {}
            else:
                raise TypeError(n.spec)
        return _output(vals[self.output]), state, stats

    def apply_refresh(self, params: Dict[str, Any], state: Dict[str, Any],
                      x: torch.Tensor,
                      thresholds: Optional[Sequence[float]] = None):
        """Full-refresh frame: accept everything and recompute everything
        with the dense ops. Same signature and results structure as
        ``apply``, so the runner's refresh policies work on a DAG as on a
        sequential net; ``thresholds`` is ignored (a refresh is
        tau = -inf)."""
        del thresholds
        dtype = network.torch_dtype(self.cfg.compute_dtype)
        vals: Dict[str, Any] = {"input": x}
        stats: Dict[str, Dict[str, Any]] = {}
        for n in self.nodes:
            xin = vals[n.inputs[0]]
            s: Dict[str, Any] = {}
            if isinstance(n.spec, ConcatSpec):
                y = torch.cat([_as_array(vals[i]) for i in n.inputs], dim=-1)
            elif isinstance(n.spec, ConvSpec) and n.spec.use_cb:
                y, _, s, _ = L.cb_conv_refresh(params[n.name], state[n.name],
                                               xin, n.spec, self.cfg)
            elif isinstance(n.spec, ConvSpec):
                y = dense_conv_on_feature(xin, params[n.name], n.spec, dtype)
            elif isinstance(n.spec, PoolSpec) and n.spec.use_cb:
                y, _, s, _ = L.cb_pool_refresh(state[n.name], xin, n.spec,
                                               self.cfg)
            elif isinstance(n.spec, PoolSpec):
                y = network.dense_pool(_as_array(xin), n.spec)
            elif isinstance(n.spec, UpsampleSpec):
                y = network.upsample(_as_array(xin), n.spec)
            else:
                raise TypeError(n.spec)
            vals[n.name], stats[n.name] = y, s
        return _output(vals[self.output]), state, stats

    def apply_dense(self, params: Dict[str, Any],
                    x: torch.Tensor) -> torch.Tensor:
        """The dense baseline: every node recomputed, in the compute
        dtype."""
        dtype = network.torch_dtype(self.cfg.compute_dtype)
        vals: Dict[str, torch.Tensor] = {"input": x}
        for n in self.nodes:
            xin = vals[n.inputs[0]]
            if isinstance(n.spec, ConcatSpec):
                vals[n.name] = torch.cat([vals[i] for i in n.inputs], dim=-1)
            elif isinstance(n.spec, ConvSpec):
                w, b = params[n.name]
                vals[n.name] = network.dense_conv(xin, w, b, n.spec, dtype)
            elif isinstance(n.spec, PoolSpec):
                vals[n.name] = network.dense_pool(xin, n.spec)
            elif isinstance(n.spec, UpsampleSpec):
                vals[n.name] = network.upsample(xin, n.spec)
            else:
                raise TypeError(n.spec)
        return vals[self.output]


def convert_graph_flagship(nodes: Sequence[GraphNode], in_shape, cfg=None,
                           output: Optional[str] = None,
                           thresholds: Optional[Sequence[float]] = None,
                           extra_overrides: Optional[Dict[str, str]] = None,
                           fuse_detect: bool = False) -> CBGraphNet:
    """Convert a DAG with the shipped layer policy, the graph twin of
    ``convert.convert_flagship``, by the JAX package's rules with
    ``"pallas"`` read as ``"cuda"``:

    * a small-cin stem node (reading "input" with cin < 128) runs
      ``patch_stem`` where the flat4 gate holds on a ``"cuda"`` pipeline,
      else ``dense_cached``;
    * a 1x1 conv none of whose descendants is a CB layer runs dense
      (decided in reverse topological order, so a chain of head 1x1s
      cascades while 1x1s that feed later CB stages stay CB);
    * aligned pools (window == stride) forward the hint.

    ``extra_overrides`` maps node NAME -> backend (or ``"forward_hint"``)
    on top of the policy; an unknown name raises. Then the input cache of
    a forward-hint pool is elided where the fused pool gate holds and the
    producer side always hints (``netview.hint_reaches``, which follows
    concat merges), and with ``fuse_detect`` a ``"cuda"`` CB conv is marked
    ``fuse_next_detect`` when its first only-this-input detecting CB conv
    reader passes the static fuse gate (``CBGraphNet.fused_consumer_map``'s
    rule). ``thresholds`` is sized by the converted graph's CB layers."""
    cfg = cfg or PipelineConfig()
    nodes = list(nodes)
    view = NetView.from_nodes(nodes, in_shape, cfg)
    cb_capable = [r.is_cb for r in view.rows]
    for i in reversed(range(len(nodes))):
        n, row = nodes[i], view.rows[i]
        if not cb_capable[i]:
            continue
        spec = n.spec
        if isinstance(spec, ConvSpec) and "input" in n.inputs \
                and row.in_shape[2] < 128:
            stem_backend = (
                "patch_stem"
                if (cfg.backend == "cuda"
                    and flat4_ops.supports(row.in_shape, spec.kernel,
                                           spec.stride, spec.dilation,
                                           spec.padding, spec.activation))
                else "dense_cached")
            spec = dataclasses.replace(spec, backend=stem_backend)
        elif isinstance(spec, ConvSpec) and spec.kernel == (1, 1) \
                and not any(cb_capable[j] for j in view.descendants(i)):
            spec = dataclasses.replace(spec, use_cb=False)
            cb_capable[i] = False
        elif isinstance(spec, PoolSpec) and spec.window == spec.stride:
            spec = dataclasses.replace(spec, forward_hint=True)
        if spec is not n.spec:
            nodes[i] = dataclasses.replace(n, spec=spec)
    if extra_overrides:
        by_name = {n.name: i for i, n in enumerate(nodes)}
        for name, backend in extra_overrides.items():
            if name not in by_name:
                raise ValueError(
                    f"extra_overrides: unknown node {name!r} (a stale "
                    f"policy file of an older topology?); nodes: "
                    f"{sorted(by_name)}")
            i = by_name[name]
            new_spec = (
                dataclasses.replace(nodes[i].spec, forward_hint=True)
                if backend == "forward_hint"
                else dataclasses.replace(nodes[i].spec, backend=backend))
            nodes[i] = dataclasses.replace(nodes[i], spec=new_spec)
    # elision is decided on the FINAL specs (a backend override on a pool
    # vetoes it), with a fresh view so the hint analysis follows concat
    # merges as CBGraphNet.apply does
    view2 = NetView.from_nodes(nodes, in_shape, cfg)
    for i, n in enumerate(nodes):
        spec = n.spec
        if not (isinstance(spec, PoolSpec) and spec.use_cb
                and spec.forward_hint):
            continue
        lcfg = L._layer_cfg(spec, cfg)
        g = L._geometry(spec, view2.rows[i].in_shape, lcfg)
        if L.fused_pool_gate(spec, g, lcfg) and hint_reaches(view2, i):
            nodes[i] = dataclasses.replace(
                n, spec=dataclasses.replace(spec, elide_in_cache=True))
    for i, n in enumerate(nodes if fuse_detect else ()):
        cons = next((c for c in nodes
                     if c.inputs == (n.name,) and isinstance(c.spec, ConvSpec)
                     and c.spec.use_cb and not c.spec.forward_hint), None)
        if cons is not None and L.fuse_next_gate(
                n.spec, cons.spec, view2.rows[i].in_shape, cfg):
            nodes[i] = dataclasses.replace(
                n, spec=dataclasses.replace(n.spec, fuse_next_detect=True))
    return convert_graph(nodes, in_shape, cfg, output=output,
                         thresholds=thresholds)


def convert_graph(nodes: Sequence[GraphNode], in_shape, cfg=None,
                  output: Optional[str] = None,
                  thresholds: Optional[Sequence[float]] = None
                  ) -> CBGraphNet:
    """Bind per-CB-node thresholds (topological order) to a DAG."""
    cfg = cfg or PipelineConfig()
    nodes = tuple(nodes)
    if thresholds is not None:
        new_nodes = []
        ti = 0
        for n in nodes:
            if _is_cb(n.spec):
                if ti >= len(thresholds):
                    raise ValueError(f"{len(thresholds)} thresholds for "
                                     "more CB layers")
                n = dataclasses.replace(
                    n, spec=dataclasses.replace(
                        n.spec, threshold=float(thresholds[ti])))
                ti += 1
            new_nodes.append(n)
        if ti != len(thresholds):
            raise ValueError(f"{len(thresholds)} thresholds for {ti} layers")
        nodes = tuple(new_nodes)
    return CBGraphNet(nodes=nodes, in_shape=tuple(in_shape), cfg=cfg,
                      output=output or nodes[-1].name)
