"""Uniform layer-table view over sequential (``CBNet``) and DAG
(``CBGraphNet``) networks (port of ``cbinfer_tpu.netview``).

The two net types keep their stats in different containers (a list by
layer index, a dict by node name) and propagate shapes by different rules;
``NetView`` flattens both into one ordered row table, so that the compute
accounting (``metrics.effective_flops_view``, ``effective_cost_view``), the
tuner's gain units and the converters' hint analysis (``hint_reaches``)
are written once against it.

Row order is execution order, which is also the order of the CB-threshold
vector both net types consume, so ``view.cb_rows()`` lines up with a tau
vector by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from .config import ConvSpec, PoolSpec


@dataclasses.dataclass(frozen=True)
class LayerRow:
    key: Any                         # stats key: layer index or node name
    spec: Any                        # LayerSpec | ConcatSpec
    in_shape: Tuple[int, int, int]   # logical input (H, W, C)
    out_shape: Tuple[int, int, int]  # logical output (H, W, C)
    producers: Tuple[int, ...]       # rows feeding this row (the network
                                     # input contributes no entry)

    @property
    def is_cb(self) -> bool:
        return isinstance(self.spec, (ConvSpec, PoolSpec)) and self.spec.use_cb

    @property
    def dense_flops(self) -> int:
        """Full-frame MAC*2 of this row (0 for anything but a conv)."""
        if not isinstance(self.spec, ConvSpec):
            return 0
        kh, kw = self.spec.kernel
        oh, ow, _ = self.out_shape
        return 2 * oh * ow * kh * kw * self.in_shape[2] * self.spec.features


@dataclasses.dataclass(frozen=True)
class NetView:
    rows: Tuple[LayerRow, ...]
    in_shape: Tuple[int, int, int]
    cfg: Any  # PipelineConfig, or None when built from bare specs

    @staticmethod
    def from_specs(specs: Sequence, in_shape, cfg=None) -> "NetView":
        from .network import out_shapes
        shapes = [tuple(in_shape)] + [tuple(s)
                                      for s in out_shapes(specs, in_shape)]
        rows = tuple(
            LayerRow(key=i, spec=spec, in_shape=shapes[i],
                     out_shape=shapes[i + 1],
                     producers=(i - 1,) if i > 0 else ())
            for i, spec in enumerate(specs))
        return NetView(rows=rows, in_shape=tuple(in_shape), cfg=cfg)

    @staticmethod
    def from_nodes(nodes: Sequence, in_shape, cfg=None) -> "NetView":
        from .graph import node_out_shapes
        shapes = node_out_shapes(nodes, in_shape)
        index = {"input": None}
        rows: List[LayerRow] = []
        for i, n in enumerate(nodes):
            index[n.name] = i
            rows.append(LayerRow(
                key=n.name, spec=n.spec, in_shape=tuple(shapes[n.inputs[0]]),
                out_shape=tuple(shapes[n.name]),
                producers=tuple(index[p] for p in n.inputs
                                if index[p] is not None)))
        return NetView(rows=tuple(rows), in_shape=tuple(in_shape), cfg=cfg)

    @staticmethod
    def of(net) -> "NetView":
        """Build from a CBNet or a CBGraphNet."""
        if hasattr(net, "nodes"):
            return NetView.from_nodes(net.nodes, net.in_shape, net.cfg)
        return NetView.from_specs(net.specs, net.in_shape, net.cfg)

    def stats_of(self, stats, row: LayerRow):
        """The row's counters out of a scan's stats (a list for a CBNet, a
        dict by node name for a CBGraphNet)."""
        return stats[row.key]

    def cb_rows(self) -> List[LayerRow]:
        """CB layers in execution (= threshold-vector) order."""
        return [r for r in self.rows if r.is_cb]

    def consumers(self, i: int) -> List[int]:
        return [j for j, r in enumerate(self.rows) if i in r.producers]

    def descendants(self, i: int) -> List[int]:
        """Every row downstream of row i (a walk of the consumer
        relation)."""
        seen, stack = set(), [i]
        while stack:
            for j in self.consumers(stack.pop()):
                if j not in seen:
                    seen.add(j)
                    stack.append(j)
        return sorted(seen)

    def downstream_conv_flops(self, i: int) -> float:
        """Dense FLOPs of every conv downstream of row i: the tuner's gain
        unit for a ``dense_cached`` layer, whose tau sizes the hint that
        gates all downstream recompute, not its own conv."""
        return float(sum(self.rows[j].dense_flops
                         for j in self.descendants(i)))

    def next_conv_flops(self, i: int) -> float:
        """Dense FLOPs of the nearest conv consumer(s) of row i: the
        tuner's gain unit for a pool, whose tau gates the convs that read
        its output. The walk stops at the first conv on each branch."""
        total, stack, seen = 0.0, list(self.consumers(i)), set()
        while stack:
            j = stack.pop()
            if j in seen:
                continue
            seen.add(j)
            if isinstance(self.rows[j].spec, ConvSpec):
                total += self.rows[j].dense_flops
            else:
                stack.extend(self.consumers(j))
        return total

    def producer_row(self, i: int) -> Optional[LayerRow]:
        """The producer of row i's primary input, if any."""
        ps = self.rows[i].producers
        return self.rows[ps[0]] if ps else None


def hint_reaches(view: NetView, ri: int) -> bool:
    """True iff row ri's producers always hand it a dirty hint: every
    producer is a CB layer, followed through concat rows (a
    ``CBGraphNet`` merges hints at a concat and drops the merged hint if
    any input lacks one). A row with no producer reads the network input,
    which carries no hint."""
    from .graph import ConcatSpec
    row = view.rows[ri]
    if not row.producers:
        return False
    for p in row.producers:
        prow = view.rows[p]
        if prow.is_cb:
            continue
        if isinstance(prow.spec, ConcatSpec):
            if not hint_reaches(view, p):
                return False
            continue
        return False  # a dense layer or an upsample clears the hint
    return True
