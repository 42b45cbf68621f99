"""Accuracy and compute accounting (port of the parts of
``cbinfer_tpu.metrics`` the scene and pose paths report): per-class
intersection / union counts of class maps and their merge into mIoU, PCK of
heatmap argmaxes against ground-truth keypoints, and the effective-FLOP
reduction from the per-layer computed-tile counters, of sequential and DAG
nets alike."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .config import ConvSpec
from .netview import NetView


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


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


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
        if not s or not isinstance(row.spec, ConvSpec):
            continue
        kh, kw = row.spec.kernel
        ft = 2 * tile_h * tile_w * kh * kw * row.in_shape[2] \
            * row.spec.features
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
