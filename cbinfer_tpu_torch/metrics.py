"""Accuracy and compute accounting (port of ``cbinfer_tpu.metrics``).

The host metrics (numpy) are the oracles: mIoU of argmax maps against the
dense network's or against ground truth, pixel accuracy, PCK of heatmap
argmaxes against the dense network's or against ground-truth keypoints.
The device metrics are their torch twins on the tensor's own device, each
a 0-d tensor with no host sync inside, so an evaluation loop (the
threshold tuner) fetches one scalar instead of the output maps. Compute
accounting: the effective-FLOP reduction from the per-layer computed-tile
counters, the roofline-aware cost that also prices detect traffic, the
change-rate histogram and the analytic drift bound, of sequential and DAG
nets alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ConvSpec
from .netview import NetView

# Machine balance: the card's achieved dense bf16 GEMM rate over its
# achieved device-to-device copy rate, in FLOPs per byte, which prices a
# byte of detect traffic in FLOP-equivalents. Measured by chip_smoke.py's
# "balance" phase on an NVIDIA H100 80GB HBM3 at 700 W: 801.2 TFLOP/s
# (torch.matmul, 8192^3 bf16) over 3.029 TB/s (a 1 GiB copy, read and
# write counted). The data sheet's peaks give 295; the JAX package's 240
# is a TPU v5e's.
MACHINE_BALANCE = 264.5


# ------------------------------- accuracy -----------------------------------


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _miou_of_ids(pred: np.ndarray, ref: np.ndarray, num_classes: int
                 ) -> float:
    ious = []
    for c in range(num_classes):
        inter = np.sum((pred == c) & (ref == c))
        union = np.sum((pred == c) | (ref == c))
        if union > 0:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 1.0


def miou(pred_logits, ref_logits, num_classes: int) -> float:
    """Mean IoU of argmax maps, CB against dense, of (..., H, W, C) logits.
    A class absent from both maps is skipped; none present gives 1.0."""
    pred = np.argmax(_np(pred_logits), axis=-1).reshape(-1)
    ref = np.argmax(_np(ref_logits), axis=-1).reshape(-1)
    return _miou_of_ids(pred, ref, num_classes)


def miou_labels(pred_logits, labels, num_classes: int) -> float:
    """Mean IoU of argmax maps against GROUND-TRUTH class ids: the
    degradation pillar is ``miou_labels(dense) - miou_labels(cb)``.
    ``pred_logits`` may also be an already argmaxed class map of the same
    rank as ``labels``."""
    pred_logits, labels = _np(pred_logits), _np(labels)
    if pred_logits.ndim == labels.ndim:
        pred = pred_logits.reshape(-1)
    else:
        pred = np.argmax(pred_logits, axis=-1).reshape(-1)
    return _miou_of_ids(pred, labels.reshape(-1), num_classes)


def pixel_accuracy(pred_logits, ref_logits) -> float:
    pred = np.argmax(_np(pred_logits), axis=-1)
    ref = np.argmax(_np(ref_logits), axis=-1)
    return float(np.mean(pred == ref))


def keypoints_from_heatmaps(heatmaps) -> np.ndarray:
    """(H, W, K) heatmaps -> (K, 2) [row, col] argmax keypoints."""
    heatmaps = _np(heatmaps)
    H, W, K = heatmaps.shape
    flat = heatmaps.reshape(H * W, K).argmax(axis=0)
    return np.stack([flat // W, flat % W], axis=-1)


def pck(pred_heatmaps, ref_heatmaps, alpha: float = 0.05) -> float:
    """PCK of CB keypoints against dense keypoints: a keypoint is correct
    within alpha * max(H, W) of the dense one. (H, W, K) or (T, H, W, K)."""
    pred_heatmaps, ref_heatmaps = _np(pred_heatmaps), _np(ref_heatmaps)
    if pred_heatmaps.ndim == 4:
        if len(pred_heatmaps) != len(ref_heatmaps):
            raise ValueError(
                f"frame-count mismatch: {len(pred_heatmaps)} vs "
                f"{len(ref_heatmaps)} (zip would silently truncate)")
        vals = [pck(p, r, alpha) for p, r in zip(pred_heatmaps, ref_heatmaps)]
        return float(np.mean(vals))
    H, W, _ = pred_heatmaps.shape
    thresh = alpha * max(H, W)
    kp_p = keypoints_from_heatmaps(pred_heatmaps)
    kp_r = keypoints_from_heatmaps(ref_heatmaps)
    dist = np.linalg.norm((kp_p - kp_r).astype(np.float64), axis=-1)
    return float(np.mean(dist <= thresh))


def iu_counts(pred_ids: torch.Tensor, ref_ids: torch.Tensor,
              num_classes: int):
    """Per-class (intersection, union) pixel counts of two class-id maps of
    the same shape, as int64 tensors on their device (partial sums for
    chunked mIoU; reduce with ``merge_iu``)."""
    c = torch.arange(num_classes, device=pred_ids.device)
    pc = pred_ids.reshape(-1).long()[None, :] == c[:, None]
    rc = ref_ids.reshape(-1).long()[None, :] == c[:, None]
    return (pc & rc).sum(dim=1), (pc | rc).sum(dim=1)


def merge_iu(inter, union) -> float:
    """Accumulated per-class counts -> mIoU (union == 0 classes skipped; no
    class present -> 1.0)."""
    inter = np.asarray(inter, np.float64)
    union = np.asarray(union, np.float64)
    present = union > 0
    if not np.any(present):
        return 1.0
    return float(np.mean(inter[present] / union[present]))


def pck_gt(pred, kps, valid, stride: int, alpha: float = 0.05,
           num_keypoints: int = 18) -> float:
    """PCK against GROUND-TRUTH keypoints (host numpy).

    pred: (..., H, W, C) model output with layout [paf | heat]: the heat
    channels are the LAST ``num_keypoints``. kps: (..., num_keypoints, 2)
    full-resolution [y, x]; valid: (..., num_keypoints) bool. A keypoint is
    correct iff its channel's argmax on the stride-s output grid lies within
    alpha * max(H, W) grid pixels of the ground truth. Mean over the valid
    keypoints (none valid: 1.0)."""
    pred = _np(pred)
    H, W, C = pred.shape[-3:]
    heat = pred[..., C - num_keypoints:].reshape((-1, H * W, num_keypoints))
    return pck_gt_from_argmax(heat.argmax(axis=1), (H, W), kps, valid,
                              stride, alpha, num_keypoints)


def heat_argmax(pred: torch.Tensor, num_keypoints: int = 18) -> torch.Tensor:
    """(H, W, C) output -> (num_keypoints,) flat argmax of each heat
    channel, on the tensor's device: what ``pck_gt`` needs of a frame, so a
    streaming loop can keep 18 integers instead of the whole map."""
    H, W, C = pred.shape
    return pred[..., C - num_keypoints:].reshape(H * W, num_keypoints) \
        .argmax(dim=0)


def pck_gt_from_argmax(flat, hw: Tuple[int, int], kps, valid, stride: int,
                       alpha: float = 0.05, num_keypoints: int = 18) -> float:
    """``pck_gt`` from the flat per-channel argmaxes (..., num_keypoints) of
    maps of shape ``hw`` (see ``heat_argmax``)."""
    H, W = hw
    flat = _np(flat).reshape((-1, num_keypoints))
    py, px = flat // W, flat % W
    gt = np.asarray(kps, np.float64).reshape((-1, num_keypoints, 2)) / stride
    dist = np.hypot(py - gt[..., 0], px - gt[..., 1])
    ok = dist <= alpha * max(H, W)
    v = np.asarray(valid, bool).reshape((-1, num_keypoints))
    return float(ok[v].mean()) if v.any() else 1.0


# ------------------------------ device metrics -------------------------------
# Twins of the host oracles above, each a 0-d tensor on the inputs' device
# computed without a host sync. torch.argmax, like np.argmax, returns the
# FIRST maximum, so the ties that bf16 logits make often break alike.


def _iu_device(pred_ids, ref_ids, num_classes: int, dtype):
    """Per-class (intersection, union) counts in ``dtype``: the one
    implementation behind the device twins below."""
    inter, union = iu_counts(pred_ids, ref_ids, num_classes)
    return inter.to(dtype), union.to(dtype)


def _miou_from_iu(inter, union):
    """Per-class counts -> mIoU with the host oracles' edge rules: union ==
    0 classes are skipped, and no class present gives 1.0."""
    present = union > 0
    iou = torch.where(present, inter / union.clamp(min=1.0),
                      torch.zeros_like(inter))
    n = present.sum()
    return torch.where(n > 0, iou.sum() / n.clamp(min=1), 1.0)


def miou_device(pred_logits, ref_logits, num_classes: int):
    """Device ``miou`` of argmax maps (CB against dense)."""
    inter, union = _iu_device(pred_logits.argmax(-1), ref_logits.argmax(-1),
                              num_classes, torch.float32)
    return _miou_from_iu(inter, union)


def miou_iu_device(pred_logits, ref_logits, num_classes: int):
    """Per-class (intersection, union) int32 counts of argmax maps: partial
    sums for chunked mIoU, reduced on the host by ``merge_iu``."""
    return _iu_device(pred_logits.argmax(-1), ref_logits.argmax(-1),
                      num_classes, torch.int32)


def miou_labels_device(pred_logits, labels, num_classes: int):
    """Device ``miou_labels``: ground-truth mIoU as one device scalar."""
    inter, union = _iu_device(pred_logits.argmax(-1), labels, num_classes,
                              torch.float32)
    return _miou_from_iu(inter, union)


def miou_labels_iu_device(pred_logits, labels, num_classes: int):
    """Per-class int32 counts against ground truth (chunked
    ``miou_labels``)."""
    return _iu_device(pred_logits.argmax(-1), labels, num_classes,
                      torch.int32)


def iu_maps_device(pred_labels, ref_labels, num_classes: int):
    """Per-class int32 counts of two already argmaxed class maps (uint8 or
    int), for loops that stack class maps instead of logits."""
    return _iu_device(pred_labels, ref_labels, num_classes, torch.int32)


def pck_device(pred_heatmaps, ref_heatmaps, alpha: float = 0.05):
    """Device ``pck`` against dense keypoints, of (..., H, W, K) maps."""
    H, W, K = pred_heatmaps.shape[-3:]
    p = pred_heatmaps.reshape(-1, H * W, K).argmax(1)
    r = ref_heatmaps.reshape(-1, H * W, K).argmax(1)
    d2 = (p // W - r // W) ** 2 + (p % W - r % W) ** 2
    ok = d2.float().sqrt() <= alpha * max(H, W)
    return ok.float().mean()


def pck_gt_device(pred, packed_kps, stride: int, alpha: float = 0.05,
                  num_keypoints: int = 18):
    """Device ``pck_gt``. ``packed_kps``: (..., num_keypoints, 3) rows of
    [y, x, valid], the keypoints and their mask in one labels tensor. No
    valid keypoint gives the host twin's vacuous 1.0."""
    H, W, C = pred.shape[-3:]
    heat = pred[..., C - num_keypoints:].reshape(-1, H * W, num_keypoints)
    flat = heat.argmax(1)
    py, px = flat // W, flat % W
    pk = packed_kps.reshape(-1, num_keypoints, 3).float()
    gt = pk[..., :2] / stride
    v = pk[..., 2] > 0.5
    dist = ((py - gt[..., 0]) ** 2 + (px - gt[..., 1]) ** 2).sqrt()
    ok = (dist <= alpha * max(H, W)).float()
    nv = v.sum()
    return torch.where(nv > 0, (ok * v).sum() / nv.clamp(min=1), 1.0)


# --------------------------- compute accounting ------------------------------


def _row_flops_per_tile(row, tile_h: int, tile_w: int) -> int:
    if not isinstance(row.spec, ConvSpec):
        return 0
    kh, kw = row.spec.kernel
    return 2 * tile_h * tile_w * kh * kw * row.in_shape[2] \
        * row.spec.features


def layer_flops_per_tile(specs: Sequence, in_shape, tile_h: int, tile_w: int
                         ) -> List[int]:
    """MAC*2 per recomputed tile for each layer (0 for non-conv layers)."""
    return [_row_flops_per_tile(r, tile_h, tile_w)
            for r in NetView.from_specs(specs, in_shape).rows]


def effective_flops_view(view, stats, tile_h: int, tile_w: int
                         ) -> Dict[str, float]:
    """Dense FLOPs per frame, the mean effective FLOPs (computed tiles x
    FLOPs per tile) and their ratio, the ``flop_reduction`` pillar, over a
    ``netview.NetView`` of a CBNet or a CBGraphNet (stats a list or a
    name-keyed dict). Takes per-frame stacks or means of the counters."""
    dense_total = 0
    eff_total = 0.0
    frames = None
    for row in view.rows:
        s = view.stats_of(stats, row)
        ft = _row_flops_per_tile(row, tile_h, tile_w)
        if not s or ft == 0:
            continue
        computed = _np(s["computed_tiles"]).astype(np.float64)
        n_tiles = float(np.max(_np(s["n_tiles"])))
        frames = computed.shape[0] if computed.ndim else 1
        dense_total += ft * n_tiles
        eff_total += float(np.mean(computed)) * ft
    return {
        "dense_flops_per_frame": float(dense_total),
        "effective_flops_per_frame": float(eff_total),
        "flop_reduction": float(dense_total / max(eff_total, 1.0)),
        "frames": frames,
    }


def effective_flops(stats: List[Dict], specs: Sequence, in_shape,
                    tile_h: int, tile_w: int) -> Dict[str, float]:
    """The sequential-specs wrapper of ``effective_flops_view``."""
    return effective_flops_view(NetView.from_specs(specs, in_shape), stats,
                                tile_h, tile_w)


def _detect_channels(row, cfg) -> int:
    """The channel width a row's detect reads and writes: the input
    storage the runtime allocates (``layers.cache_channels``)."""
    from . import layers as L
    return L.cache_channels(row.spec, row.in_shape[2], cfg)[0]


def effective_cost_view(view, stats, tile_h: int, tile_w: int,
                        balance: Optional[float] = None,
                        cache_bytes: int = 2) -> Dict[str, float]:
    """Roofline-aware cost: FLOPs plus detect TRAFFIC, over a NetView.

    ``effective_flops`` prices only MACs; detection is bandwidth-bound (it
    reads the input and the cache and writes the cache over every visited
    8x8 hint tile), so a threshold that recomputes little but detects
    widely looks cheap in FLOPs and is not. Each visited tile is charged
    its bytes times ``balance`` (FLOPs per byte; ``MACHINE_BALANCE``, read
    at call time, when None), which turns traffic into FLOP-equivalents at
    the roofline. The threshold tuner selects by this cost; the
    ``flop_reduction`` pillar stays pure FLOPs.

    With ``view.cfg`` set, a row's traffic is priced at the channel width
    its input storage really has (``layers.cache_channels``: the logical
    width in the port, where the JAX package prices its 128-lane padding);
    without one, at the logical width."""
    from .layers import HINT_TILE
    if balance is None:
        balance = MACHINE_BALANCE
    cfg = view.cfg
    dense_total = 0.0
    eff_total = 0.0
    for row in view.rows:
        s = view.stats_of(stats, row)
        if not s:
            continue
        ft = _row_flops_per_tile(row, tile_h, tile_w)
        n_tiles = float(np.max(_np(s["n_tiles"])))
        computed = float(np.mean(_np(s["computed_tiles"])
                                 .astype(np.float64)))
        dense_total += ft * n_tiles
        eff_total += computed * ft
        cin = (row.in_shape[2] if cfg is None
               else _detect_channels(row, cfg))
        det = float(np.mean(_np(s["detect_tiles"]).astype(np.float64)))
        eff_total += (det * 3 * HINT_TILE * HINT_TILE * cin
                      * cache_bytes * balance)
    return {
        "dense_flops_per_frame": float(dense_total),
        "effective_cost_per_frame": float(eff_total),
        "cost_reduction": float(dense_total / max(eff_total, 1.0)),
    }


def effective_cost(stats: List[Dict], specs: Sequence, in_shape,
                   tile_h: int, tile_w: int, balance: Optional[float] = None,
                   cache_bytes: int = 2, cfg=None) -> Dict[str, float]:
    """The sequential-specs wrapper of ``effective_cost_view``."""
    return effective_cost_view(NetView.from_specs(specs, in_shape, cfg),
                               stats, tile_h, tile_w, balance, cache_bytes)


def change_rate_histogram(stats: List[Dict]) -> List[Dict[str, float]]:
    """Per-layer mean and max changed-tile fraction over the clip, and the
    share of frames that overflowed."""
    out = []
    for i, s in enumerate(stats):
        if not s:
            out.append({})
            continue
        computed = _np(s["computed_tiles"]).astype(np.float64)
        n = float(np.max(_np(s["n_tiles"])))
        out.append({
            "layer": i,
            "mean_fraction": float(np.mean(computed) / n),
            "max_fraction": float(np.max(computed) / n),
            "overflow_rate": float(np.mean(_np(s["overflow"]))),
        })
    return out


def drift_bound(specs: Sequence, params, thresholds) -> float:
    """Analytic worst-case steady-state output drift of the CB network
    against its dense twin, in per-channel max-abs units.

    A CB layer's accepted input drifts at most its tau on top of what its
    producer already carries; a conv multiplies the error by the max over
    outputs of its kernel's L1 norm (ReLU and max-pool are 1-Lipschitz in
    the max norm, nearest upsampling is exact):

        e_out = gain_l * (e_in + tau_l)   [conv]
        e_out = e_in + tau_l              [pool]

    Loose (it aligns every sign) but sound. Dense layers (use_cb=False)
    contribute their gain only. ``params`` in the port's layout: HWIO
    weights (any dtype and device), one ``(w, b)`` per conv."""
    from .config import PoolSpec, UpsampleSpec

    taus = [float(t) for t in np.asarray(_np(thresholds),
                                         dtype=np.float64).ravel()]
    ti = 0
    e = 0.0

    def next_tau():
        nonlocal ti
        if ti >= len(taus):
            raise ValueError(
                f"{len(taus)} thresholds for >{ti} CB layers")
        t = max(0.0, taus[ti])
        ti += 1
        return t

    for spec, p in zip(specs, params):
        if isinstance(spec, ConvSpec):
            w = _np(p[0]).astype(np.float64)  # (kh, kw, cin, cout)
            gain = float(np.abs(w).sum(axis=(0, 1, 2)).max())
            tau = next_tau() if spec.use_cb else 0.0
            e = gain * (e + tau)
        elif isinstance(spec, PoolSpec):
            e = e + (next_tau() if spec.use_cb else 0.0)
        elif isinstance(spec, UpsampleSpec):
            pass
        else:
            raise ValueError(f"drift_bound: unsupported spec {spec}")
    if ti != len(taus):
        raise ValueError(f"{len(taus)} thresholds for {ti} CB layers")
    return float(e)
