"""Per-layer threshold auto-tuner (port of ``cbinfer_tpu.tuner``).

Per-layer sensitivity sweeps of the end metric on a calibration set (one
layer's tau varied, the others held at a base value), a measured
ratio-greedy selection of one tau per layer under an accuracy budget, and
the accuracy/compute Pareto curve as the budget varies; ``stress_validate``
then checks candidate vectors on fresh clips at the deployment point.

The taus are runtime values, as in the JAX package's jitted scan: the
kernels read them from a float32 device vector, so one captured CUDA
graph per clip shape serves the whole sweep (``_make_runner``): the
first scan of a shape runs eagerly and captures, every later one resets
the clip's state in place, writes the candidate's taus and replays, under
``torch.cuda.set_sync_debug_mode("error")``. On the CPU every scan is the
eager ``runner.scan_video``. The metric is computed on the device when a
``device_metric_fn`` is given, and an evaluation fetches the metrics and
the packed stats of its clips once each.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import layers as L
from .config import ConvSpec, PoolSpec
from .metrics import _np, effective_cost_view, effective_flops_view
from .netview import NetView, hint_reaches
from .network import resolve_device
from .runner import (_addresses, _Graphs, _tensors, pack_stats, scan_video,
                     unpack_stats, write_taus)


@dataclasses.dataclass
class TuneResult:
    thresholds: List[float]            # selected tau per CB layer
    metric: float                      # combined metric at selection
    flop_reduction: float              # effective-FLOP reduction at selection
    sensitivity: Dict[int, List]       # layer -> [(tau, metric), ...]
    pareto: List[Dict]                 # [{budget, metric, flop_reduction,
                                       #   cost_reduction, thresholds}, ...]
    flop_frac: Dict[int, List] = dataclasses.field(default_factory=dict)
                                       # layer -> changed-tile fraction per
                                       # tau_grid entry (sensitivity sweep)
    evaluations: int = 0               # calibration-set evaluations made

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


@dataclasses.dataclass
class StressResult:
    """Outcome of deployment-point threshold validation (stress_validate)."""
    thresholds: List[float]            # the vector that should ship
    source: str                        # candidate name it came from
    passed: bool                       # worst-clip degradation <= budget
    rows: List[Dict]                   # per-candidate measured degradation

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On the card, any host sync inside raises: a scan only enqueues."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _make_runner(net, params, refresh_every=None):
    """(frames, taus) -> (outputs, stacked stats), ``scan_video`` from a
    fresh state with ``refresh_every``. Each clip shape keeps one state, a
    pristine copy of it and a float32 tau vector; every scan first writes
    the copy into the state (new state tensors would be other addresses,
    and a graph bound to them) and its taus into the vector
    (``write_taus``), which the kernels read at run time. On the card the
    first scan of a shape runs eagerly, outside the sync check (kernel
    builds, weight packing, device constants), and captures a CUDA graph
    of the loop; every later scan of that shape, whatever its taus,
    replays that graph under the sync check. On the CPU every scan is the
    eager loop."""
    graphs = _Graphs(4)
    states: Dict[tuple, tuple] = {}

    def run(frames, taus):
        key = (tuple(frames.shape), frames.dtype, frames.device)
        first = key not in states
        if first:
            state = net.init_state()
            states[key] = (state, [t.clone() for t in _tensors(state)],
                           torch.empty(len(taus), dtype=torch.float32,
                                       device=frames.device))
        state, pristine, tv = states[key]
        with (contextlib.nullcontext() if first
              else _no_host_sync(frames.device)):
            for t, t0 in zip(_tensors(state), pristine):
                t.copy_(t0)
            write_taus(tv, taus)

            def fn(fs):
                ys, _, stats = scan_video(net, params, fs, state,
                                          thresholds=tv,
                                          refresh_every=refresh_every)
                return ys, stats
            return graphs.run(key + (_addresses(params, state),), fn,
                              frames)

    run.graphs, run.states = graphs, states
    return run


def _make_device_runner(run, device_metric_fn, skip_frames,
                        with_labels=False):
    """``run`` (a ``_make_runner``) with the metric computed on the device:
    (frames, taus, dense_ys[, labels]) -> (metric, stats), the metric a 0-d
    tensor not fetched here, so an evaluation never copies the outputs to
    the host."""

    def drun(frames, taus, dense_ys, labels=None):
        ys, stats = run(frames, taus)
        with _no_host_sync(frames.device):
            if with_labels:
                m = device_metric_fn(ys[skip_frames:], dense_ys[skip_frames:],
                                     labels[skip_frames:])
            else:
                m = device_metric_fn(ys[skip_frames:], dense_ys[skip_frames:])
        return m, stats

    return drun


def _host_stats(stats_list, skip_frames: int):
    """Each clip's stacked stats -> the same containers of numpy arrays,
    each clip's cold-start frames dropped: one device-to-host copy for all
    of them (``pack_stats``), not one per counter."""
    packed = [pack_stats(s) for s in stats_list]
    rows = iter(unpack_stats(torch.cat(packed)) if packed else [])
    out = []
    for stats in stats_list:
        def one(s):
            if not s:
                return {}
            r = next(rows)
            return {k: (np.asarray(r[k])[skip_frames:].astype(bool)
                        if k == "overflow"
                        else np.asarray(r[k])[skip_frames:]) for k in s}
        out.append({k: one(s) for k, s in stats.items()}
                   if isinstance(stats, dict) else [one(s) for s in stats])
    return out


def _cat_stats(stats_list):
    """Clips' stats (same containers) -> one, the frames concatenated."""
    if len(stats_list) == 1:
        return stats_list[0]

    def cat(*ss):
        return ({k: np.concatenate([np.atleast_1d(s[k]) for s in ss])
                 for k in ss[0]} if ss[0] else {})
    first = stats_list[0]
    if isinstance(first, dict):
        return {k: cat(*[s[k] for s in stats_list]) for k in first}
    return [cat(*ss) for ss in zip(*stats_list)]


def _stage(clips, labels, device):
    """(T, H, W, C) or (S, T, H, W, C) frames (numpy or torch) -> a list of
    (T, H, W, C) device tensors, and the labels likewise (or Nones)."""
    clips = torch.as_tensor(clips)
    clips = clips[None] if clips.ndim == 4 else clips
    staged = [c.to(device) for c in clips]
    if labels is None:
        return staged, [None] * len(staged)
    labels = torch.as_tensor(labels)
    labels = labels[None] if labels.ndim == clips.ndim - 2 else labels
    if tuple(labels.shape[:2]) != tuple(clips.shape[:2]):
        raise ValueError(f"labels {tuple(labels.shape)} for clips "
                         f"{tuple(clips.shape)}")
    return staged, [lab.to(device) for lab in labels]


def stress_validate(net, params, candidates: Dict[str, Sequence],
                    clips, metric_fn: Optional[Callable] = None,
                    labels=None, budget: float = 0.005,
                    skip_frames: int = 1,
                    refresh_every: Optional[int] = None,
                    device_metric_fn: Optional[Callable] = None,
                    verbose: bool = False) -> StressResult:
    """Validate candidate tau vectors at the DEPLOYMENT operating point.

    ``tune`` calibrates where sweeping is affordable, on its calibration
    seeds; a selected vector can be fragile elsewhere. This measures every
    candidate on fresh-seed clips at the deployment resolution and returns
    the first (in ``candidates`` order) whose WORST-clip degradation fits
    ``budget``: order them best first (tuned vector, then flat fallbacks,
    descending tau). If none passes, the least-degrading one is returned
    with ``passed=False``.

    Args:
      net, params: the converted network at the deployment shape.
      candidates: ordered {name: tau vector}, one tau per CB layer.
      clips: (S, T, H, W, C) or (T, H, W, C) frames, moved to the device
        whole, or a list of (T, H, W, C) clips kept on the host and staged
        one at a time (the clip-major loop below holds one clip and its
        dense reference on the device at once).
      metric_fn / device_metric_fn / labels / skip_frames / refresh_every:
        ``tune``'s conventions; degradation = 1 - metric, per clip.
      budget: the largest allowed worst-clip degradation.
    """
    device = resolve_device(net.cfg.device)
    if isinstance(clips, (list, tuple)):
        labs = list(labels) if labels is not None else [None] * len(clips)
    else:
        clips, labs = _stage(clips, labels, device)
    if labels is not None and len(labs) != len(clips):
        raise ValueError(f"{len(labs)} label sets for {len(clips)} clips")
    view = NetView.of(net)
    n_layers = len(view.cb_rows())
    for nm, tv in candidates.items():
        if len(tv) != n_layers:
            raise ValueError(f"candidate {nm!r}: {len(tv)} taus for "
                             f"{n_layers} CB layers")

    run = _make_runner(net, params, refresh_every)
    if device_metric_fn is not None:
        drun = _make_device_runner(run, device_metric_fn, skip_frames,
                                   with_labels=labels is not None)

    degs_by_cand: Dict[str, List[float]] = {nm: [] for nm in candidates}
    for f, lab in zip(clips, labs):
        f = torch.as_tensor(f).to(device)
        lab_d = None if lab is None else torch.as_tensor(lab).to(device)
        d = run(f, [-1.0] * n_layers)[0]
        if device_metric_fn is not None:
            ms = [drun(f, tv, d, lab_d)[0] if lab_d is not None
                  else drun(f, tv, d)[0] for tv in candidates.values()]
            got = torch.stack(ms).double().cpu().numpy()
            for nm, m in zip(candidates, got):
                degs_by_cand[nm].append(1.0 - float(m))
        else:
            d_np = _np(d)[skip_frames:]
            for nm, tv in candidates.items():
                cb = _np(run(f, tv)[0])[skip_frames:]
                m = (metric_fn(cb, d_np, _np(lab)[skip_frames:])
                     if lab is not None else metric_fn(cb, d_np))
                degs_by_cand[nm].append(1.0 - float(m))
        del f, d, lab_d

    rows, chosen = [], None
    for name, tv in candidates.items():
        degs = degs_by_cand[name]
        row = {"name": name, "thresholds": [float(t) for t in tv],
               "per_clip_degradation": [round(d, 6) for d in degs],
               "worst_degradation": round(max(degs), 6),
               "mean_degradation": round(float(np.mean(degs)), 6)}
        rows.append(row)
        if verbose:
            print(f"stress {name}: worst={row['worst_degradation']:.5f} "
                  f"mean={row['mean_degradation']:.5f}")
        if chosen is None and max(degs) <= budget + 1e-9:
            chosen = row
    passed = chosen is not None
    if chosen is None:
        chosen = min(rows, key=lambda r: r["worst_degradation"])
    return StressResult(thresholds=chosen["thresholds"],
                        source=chosen["name"], passed=passed, rows=rows)


def _tau_is_dead(view: NetView, ri: int) -> bool:
    """True iff row ``ri``'s tau is never read at deployment: a forward-
    hint conv whose producer always hints, or a forward-hint pool whose
    fused-kernel gate (``layers.fused_pool_gate``, the one
    ``cb_pool_apply`` checks) holds on the runtime's own geometry and
    whose producer always hints. Any unmet condition means the layer
    re-detects and its tau is live. The plain versions on the CPU follow
    the same gates, so the answer does not depend on the device."""
    spec = view.rows[ri].spec
    if isinstance(spec, ConvSpec) and spec.forward_hint:
        return hint_reaches(view, ri)
    if not (isinstance(spec, PoolSpec) and spec.forward_hint):
        return False
    lcfg = L._layer_cfg(spec, view.cfg)
    in_h, in_w, in_c = view.rows[ri].in_shape
    cin = L.cache_channels(spec, in_c, lcfg)[0]
    g = L._geometry(spec, (in_h, in_w, cin), lcfg)
    if not L.fused_pool_gate(spec, g, lcfg):
        return False
    return hint_reaches(view, ri)


def tune(net, params, calib_frames, metric_fn: Callable,
         tau_grid: Sequence[float] = (0.01, 0.02, 0.04, 0.08, 0.16, 0.32),
         budgets: Sequence[float] = (0.001, 0.002, 0.005, 0.01, 0.02),
         budget: float = 0.005, base_tau: float = 0.0,
         skip_frames: int = 1, refresh_every: Optional[int] = None,
         device_metric_fn: Optional[Callable] = None,
         labels=None, verbose: bool = False) -> TuneResult:
    """Tune per-layer thresholds against a calibration set.

    Args:
      net, params: the converted CB network (``CBNet`` or ``CBGraphNet``).
      calib_frames: (T, H, W, C) clip or (S, T, H, W, C) set of clips,
        numpy or torch; the metric is averaged over the clips.
      metric_fn: (cb_outputs, dense_outputs[, labels]) -> float on numpy
        arrays, 1 = no degradation (e.g. ``partial(miou, num_classes=K)``,
        ``pck``, or a ground-truth composite); gets ``labels`` iff given.
      device_metric_fn: the same on device tensors, returning a 0-d
        tensor (``metrics.miou_device``, ``pck_device``, ...): when given,
        the outputs never leave the card.
      labels: ground truth at the model's OUTPUT resolution, (T, H', W')
        or (S, T, H', W') (any trailing dims), matching the clips.
      tau_grid: per-layer sweep grid (ascending).
      budgets: budget values for the Pareto curve.
      budget: the operating budget (largest allowed metric drop).
      base_tau: tau of the layers not swept during the sensitivity sweep.
      skip_frames: leading frames of each clip left out of the metric and
        the counters (the cold start is exact by construction).
      refresh_every: the periodic full refresh to calibrate under
        (``runner.scan_video``): tune with the deployment's drift horizon.

    Returns a TuneResult with the selected thresholds and the Pareto
    samples. The dense reference is the CB run at tau = -1 (every pixel
    changes, every tile is recomputed), through the same runner.
    """
    device = resolve_device(net.cfg.device)
    clips, labs = _stage(calib_frames, labels, device)
    labels_given = labels is not None
    view = NetView.of(net)
    cb_rows = [i for i, r in enumerate(view.rows) if r.is_cb]
    n_layers = len(cb_rows)
    run = _make_runner(net, params, refresh_every)
    dense_outs = [run(f, [-1.0] * n_layers)[0] for f in clips]
    evaluations = 0

    if device_metric_fn is not None:
        drun = _make_device_runner(run, device_metric_fn, skip_frames,
                                   with_labels=labels_given)

        def eval_taus(taus: np.ndarray):
            nonlocal evaluations
            evaluations += 1
            ms, sts = [], []
            for f, d, lab in zip(clips, dense_outs, labs):
                m, stats = drun(f, taus, d, lab) if labels_given \
                    else drun(f, taus, d)
                ms.append(m)
                sts.append(stats)
            # one fetch of the clips' metrics, one of their counters
            ms = torch.stack(ms).double().cpu().numpy()
            return float(np.mean(ms)), _cat_stats(
                _host_stats(sts, skip_frames))
    else:
        dense_np = [_np(d)[skip_frames:] for d in dense_outs]

        def eval_taus(taus: np.ndarray):
            nonlocal evaluations
            evaluations += 1
            ms, sts = [], []
            for f, d, lab in zip(clips, dense_np, labs):
                ys, stats = run(f, taus)
                cb = _np(ys)[skip_frames:]
                ms.append(float(
                    metric_fn(cb, d, _np(lab)[skip_frames:])
                    if labels_given else metric_fn(cb, d)))
                sts.append(stats)
            return float(np.mean(ms)), _cat_stats(
                _host_stats(sts, skip_frames))

    # a forward-hint layer whose hint always arrives never reads its tau:
    # sweeping it would spend |grid| evaluations on a knob that does
    # nothing, and the greedy could spend budget on it
    tau_dead = [_tau_is_dead(view, ri) for ri in cb_rows]

    # ---- per-layer sensitivity (metric + changed-tile fraction) ----
    sensitivity: Dict[int, List] = {}
    flop_frac: Dict[int, List] = {}
    base_eval = None  # evaluated only if a dead layer needs its flat curve

    def get_base_eval():
        nonlocal base_eval
        if base_eval is None:
            base_eval = eval_taus(np.full((n_layers,), base_tau, np.float32))
        return base_eval

    def changed_fraction(stats, l):
        s = view.stats_of(stats, view.rows[cb_rows[l]])
        nt = float(np.max(s["n_tiles"]))
        # changed_tiles, not computed_tiles: for a dense_cached layer the
        # compute never shrinks but its mask is the hint that gates every
        # downstream detect; for the other layers the two coincide
        return float(np.mean(s["changed_tiles"].astype(np.float64))) \
            / max(nt, 1.0)

    for l in range(n_layers):
        if tau_dead[l]:
            m0, stats0 = get_base_eval()
            sensitivity[l] = [(float(t), m0) for t in tau_grid]
            flop_frac[l] = [changed_fraction(stats0, l)] * len(tau_grid)
            if verbose:
                print(f"layer {l}: tau dead (forward-hint), sweep skipped")
            continue
        curve, fracs = [], []
        for tau in tau_grid:
            taus = np.full((n_layers,), base_tau, np.float32)
            taus[l] = tau
            m, stats = eval_taus(taus)
            fracs.append(changed_fraction(stats, l))
            curve.append((float(tau), m))
            if verbose:
                print(f"layer {l} tau={tau:.3g}: metric={m:.4f} "
                      f"frac={fracs[-1]:.3f}")
        sensitivity[l] = curve
        flop_frac[l] = fracs

    # dense FLOPs gated by layer l's tau, the greedy's gain units: a CB
    # conv's own; a dense_cached layer's every downstream conv (its tau
    # sizes the hint of all of them); a pool's half of its consumer convs'
    layer_gain_flops = []
    for l in range(n_layers):
        ri = cb_rows[l]
        row = view.rows[ri]
        if str(getattr(row.spec, "backend", None) or "") \
                .startswith("dense_cached"):
            own = view.downstream_conv_flops(ri)
        elif row.dense_flops > 0:
            own = float(row.dense_flops)
        else:
            own = 0.5 * view.next_conv_flops(ri)
        layer_gain_flops.append(own)

    # ---- budgeted selection: a measured ratio-greedy over the budget ----
    # Layer taus are partial substitutes and the curves are not monotone,
    # so every accepted move is measured on the combined network: propose
    # per layer the grid tau of the largest projected gain, plus uniform
    # moves; evaluate each; accept the best measured cost gain per metric
    # drop that fits the budget; repeat until none fits.
    th, tw = net.cfg.tile.tile_h, net.cfg.tile.tile_w

    def ef_of(stats) -> float:
        return effective_cost_view(view, stats, th, tw)["cost_reduction"]

    def flops_of(stats) -> float:
        return effective_flops_view(view, stats, th, tw)["flop_reduction"]

    def candidates_for(pos):
        out = []
        for l in range(n_layers):
            prev_frac = flop_frac[l][pos[l]] if pos[l] >= 0 else 1.0
            best_j, best_gain = None, 0.0
            for j in range(pos[l] + 1, len(tau_grid)):
                gain = max(0.0, prev_frac - flop_frac[l][j]) \
                    * layer_gain_flops[l]
                if gain > best_gain:
                    best_j, best_gain = j, gain
            if best_j is not None:
                out.append((l, best_j))
        for j in range(len(tau_grid)):
            if any(p < j for p in pos):
                out.append(("ALL", j))
        return out

    def taus_of(pos):
        taus = np.full((n_layers,), base_tau, np.float32)
        for l in range(n_layers):
            if pos[l] >= 0:
                taus[l] = tau_grid[pos[l]]
        return taus

    pareto = []
    pos = [-1] * n_layers
    m_cur, stats_cur = eval_taus(taus_of(pos))
    ef_cur = ef_of(stats_cur)
    seen: Dict = {}
    for b in sorted(set(list(budgets) + [budget])):
        # warm-start each budget from the previous (smaller) solution
        while True:
            best = None
            for l, j in candidates_for(pos):
                trial = ([max(p, j) for p in pos] if l == "ALL"
                         else pos[:l] + [j] + pos[l + 1:])
                key = tuple(trial)
                if key not in seen:
                    seen[key] = eval_taus(taus_of(trial))
                m, stats = seen[key]
                if 1.0 - m > b + 1e-9:
                    continue
                gain = ef_of(stats) - ef_cur
                if gain <= 1e-6:
                    continue
                drop = max(1e-9, (1.0 - m) - (1.0 - m_cur))
                ratio = gain / drop
                if best is None or ratio > best[0]:
                    best = (ratio, l, j, m, stats)
            if best is None:
                break
            _, l, j, m_cur, stats_cur = best
            if l == "ALL":
                pos = [max(p, j) for p in pos]
            else:
                pos[l] = j
            ef_cur = ef_of(stats_cur)
            if verbose:
                print(f"  accept layer {l} tau={tau_grid[j]:.3g}: "
                      f"metric={m_cur:.4f} cost={ef_cur:.2f}x")
        pareto.append({
            "budget": float(b),
            "metric": m_cur,
            "flop_reduction": flops_of(stats_cur),
            "cost_reduction": ef_cur,
            "thresholds": [float(t) for t in taus_of(pos)],
        })
        if verbose:
            print(f"budget {b}: metric={m_cur:.4f} "
                  f"flops={pareto[-1]['flop_reduction']:.2f}x "
                  f"cost={ef_cur:.2f}x")

    chosen = min(pareto, key=lambda p: abs(p["budget"] - budget))
    return TuneResult(
        thresholds=chosen["thresholds"],
        metric=chosen["metric"],
        flop_reduction=chosen["flop_reduction"],
        sensitivity=sensitivity,
        pareto=pareto,
        flop_frac=flop_frac,
        evaluations=evaluations,
    )
