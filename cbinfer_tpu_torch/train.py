"""In-repo weight training on synthetic video (PyTorch port of
``cbinfer_tpu.train``, ``cbinfer_tpu/train.py``).

The networks are trained on the sprite videos' free ground truth: class
labels (``video.SpriteVideo.label``) for scene labelling and segmentation,
keypoint heatmaps and limb fields (``video.pose_targets``) for pose. Trained
weights give the networks real decision margins, which is what makes the
accuracy-against-threshold trade-off meaningful.

Training runs the DENSE path (``network.dense_apply`` for a spec chain,
``CBGraphNet.apply_dense`` for the DAG) with cuDNN convolutions and
autograd: the change-based path is inference-only, as in the reference.
Where the reference ``jax.vmap``s the forward over the batch's frames, a
(B, H, W, C) batch goes through the dense ops at once (each conv one
NCHW convolution of N = B); ``forward(params, x)`` below is such a
batched forward.
Params are float32 tensors on the device in the reference's layout, a list
of ``(w HWIO, b)`` / ``None`` for a spec chain and a dict by node name for
the DAG, so ``checkpoint.save_npz_params`` / ``save_npz_graph_params``
write what ``checkpoint.load_npz_params`` and ``zoo.load`` read.

The optimiser is ``torch.optim.Adam`` with optax's defaults (betas 0.9,
0.999, eps 1e-8 outside the square root: the same update formula as
``optax.adam``), the pose learning rate ``optax.cosine_decay_schedule``'s
(``cosine_decay``). Every numpy generator makes the reference's draws in
the reference's order, so the data and the batches are the reference's
byte for byte. The initial weights come from the port's ``init_params``
(another generator than the reference's ``jax.random``).

``losses``: pass a list to get each step's loss appended, as a 0-dim
tensor on the device (no host sync per step).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfig
from .graph import convert_graph, init_graph_params, node_out_shapes
from .metrics import pck_gt
from .network import dense_apply, init_params, out_shapes, resolve_device
from .video import (NUM_KEYPOINTS, NUM_PAFS, SpriteVideo, SpriteVideoConfig,
                    pose_targets)


def _label_at_stride(labels: torch.Tensor, stride: int) -> torch.Tensor:
    """``cbinfer_tpu/train.py:28``."""
    return labels[:, ::stride, ::stride]


def cosine_decay(steps: int) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, steps)`` (alpha 0) as a factor of
    ``lr``: the factor of update ``count`` (0 for the first), for
    ``torch.optim.lr_scheduler.LambdaLR``, which evaluates it at 0 when it
    is built and at k after its k-th ``step()``: one ``step()`` after each
    optimiser step gives update k the factor at k, as optax's count
    does."""
    def factor(count: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    return factor


def _trainable(params) -> List[torch.Tensor]:
    """Leaf tensors of a params list or dict, float32, requiring grad (the
    reference optimises every non-None leaf)."""
    pairs = params.values() if isinstance(params, dict) else params
    leaves = []
    for p in pairs:
        if p is None:
            continue
        for t in p:
            if t is not None:
                leaves.append(t)
    for t in leaves:
        if t.dtype != torch.float32:
            raise ValueError(f"training needs float32 params, got {t.dtype}")
        t.requires_grad_(True)
    return leaves


def _detached(params):
    """The trained params without autograd: float32 tensors on the
    device, in the input's layout."""
    def one(p):
        return None if p is None else tuple(
            None if t is None else t.detach() for t in p)
    if isinstance(params, dict):
        return {k: one(p) for k, p in params.items()}
    return [one(p) for p in params]


def _batch_indices(rng, n: int, batch: int, steps: int, dev) -> torch.Tensor:
    """(steps, batch) frame indices on ``dev``: the reference's per-step
    draws ``rng.integers(0, n, batch)``, in order, uploaded once (a
    per-step upload of pageable memory would wait for the device every
    step)."""
    return torch.from_numpy(np.stack(
        [rng.integers(0, n, batch) for _ in range(steps)])).to(dev)


def seg_loss(forward, params, x: torch.Tensor, y: torch.Tensor):
    """(loss, logits) of a batch: ``F.cross_entropy`` over every output
    pixel against the labels at the output stride, the reference's
    ``optax.softmax_cross_entropy_with_integer_labels`` then the mean
    (``cbinfer_tpu/train.py:84-89``)."""
    logits = forward(params, x)
    return F.cross_entropy(logits.permute(0, 3, 1, 2), y), logits


def pose_loss(forward, params, x: torch.Tensor, y: torch.Tensor,
              heat_weight: float, pos_weight: float) -> torch.Tensor:
    """The positive-weighted MSE of ``cbinfer_tpu/train.py:222-229``: per
    entry weight ``1 + pos_weight * |target|``, heat channels also
    ``heat_weight``, the mean over every entry of the batch."""
    pred = forward(params, x)
    cw = torch.cat([torch.ones(NUM_PAFS, device=y.device),
                    torch.full((NUM_KEYPOINTS,), heat_weight,
                               device=y.device)])
    w = cw * (1.0 + pos_weight * y.abs())
    return (w * (pred - y) ** 2).mean()


def _seg_dataset(rng, H, W, seed, n_videos, palette="default",
                 video_kwargs=None):
    """(frames (N, H, W, 3), labels (N, H, W)) of ``train_segmentation``,
    8 frames of each of ``n_videos`` videos, drawing each video's sprite
    count from ``rng`` (``cbinfer_tpu/train.py:56-66``)."""
    vk = {"palette": palette, **(video_kwargs or {})}
    videos = [SpriteVideo(SpriteVideoConfig(
        height=H, width=W, n_sprites=3 + int(rng.integers(0, 3)),
        sprite_size=max(8, H // 10), speed=3.0, noise_std=0.002,
        seed=seed * 100 + i, **vk)) for i in range(n_videos)]
    data = [v.clip_with_labels(8) for v in videos]
    return (np.concatenate([d[0] for d in data]),
            np.concatenate([d[1] for d in data]))


def train_segmentation(specs: Sequence, in_shape: Tuple[int, int, int],
                       num_classes: int, steps: int = 300,
                       batch: int = 4, lr: float = 3e-3, seed: int = 0,
                       n_videos: int = 8, input_noise: float = 0.0,
                       palette: str = "default", verbose: bool = False,
                       video_kwargs: Optional[dict] = None, *,
                       device="cuda", losses: Optional[list] = None):
    """Train a spec-chain CNN to segment sprites on synthetic video
    (``cbinfer_tpu/train.py:32``).

    Returns (params, final_accuracy): the accuracy of the last step's
    batch, measured before its update, as in the reference. The output
    stride is inferred from the spec chain; labels are subsampled to match.
    ``input_noise``: uniform per-pixel train-time input perturbation
    amplitude (the reference's docstring says when it helps).
    The loss is ``seg_loss``.
    """
    dev = resolve_device(device)
    H, W, _ = in_shape
    oh, ow, oc = out_shapes(specs, in_shape)[-1]
    if oc != num_classes:
        raise ValueError(f"the chain ends in {oc} channels, not "
                         f"{num_classes} classes")
    stride = H // oh

    rng = np.random.default_rng(seed)
    frames, labels = _seg_dataset(rng, H, W, seed, n_videos, palette,
                                  video_kwargs)
    frames_d = torch.from_numpy(frames).to(dev)
    labels_d = torch.from_numpy(labels).to(dev, torch.int64)

    params = init_params(specs, in_shape, seed, device=dev)
    opt = torch.optim.Adam(_trainable(params), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    def forward(ps, f):
        return dense_apply(specs, ps, f)

    n = frames.shape[0]
    # with input noise the generator draws a batch's indices, then its
    # noise, step by step; without, every step's indices at once
    idx_all = (None if input_noise > 0
               else _batch_indices(rng, n, batch, steps, dev))
    acc = 0.0
    for it in range(steps):
        if idx_all is None:
            idx_d = torch.from_numpy(rng.integers(0, n, batch)).to(dev)
            x = frames_d[idx_d] + torch.from_numpy(rng.uniform(
                -input_noise, input_noise, (batch,) + frames.shape[1:]
            ).astype(np.float32)).to(dev)
        else:
            idx_d = idx_all[it]
            x = frames_d[idx_d]
        y = _label_at_stride(labels_d[idx_d], stride)
        loss, logits = seg_loss(forward, params, x, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
        if it == steps - 1:
            acc = float((logits.detach().argmax(-1) == y).float().mean())
        if verbose and it % 50 == 0:
            a = float((logits.detach().argmax(-1) == y).float().mean())
            print(f"step {it}: loss {float(loss.detach()):.4f} acc {a:.3f}",
                  flush=True)
    return _detached(params), acc


def train_pose(specs: Sequence, in_shape: Tuple[int, int, int],
               steps: int = 600, batch: int = 4, lr: float = 2e-3,
               seed: int = 0, n_videos: int = 16, frames_per_video: int = 8,
               heat_weight: float = 4.0, pos_weight: float = 30.0,
               verbose: bool = False,
               video_kwargs: Optional[dict] = None, *, device="cuda",
               losses: Optional[list] = None):
    """Train an OpenPose-style spec chain on synthetic sprite keypoints
    (``cbinfer_tpu/train.py:117``). Loss and schedule as
    ``_train_pose_common``. Returns (params, train_pck)."""
    dev = resolve_device(device)
    H, W, _ = in_shape
    oh, ow, oc = out_shapes(specs, in_shape)[-1]
    if oc != NUM_PAFS + NUM_KEYPOINTS:
        raise ValueError(f"the chain ends in {oc} channels, not "
                         f"{NUM_PAFS + NUM_KEYPOINTS} (paf | heat)")
    stride = H // oh
    return _train_pose_common(
        lambda ps, f: dense_apply(specs, ps, f),
        init_params(specs, in_shape, seed, device=dev),
        in_shape, stride, oh, ow, steps, batch, lr, seed, n_videos,
        frames_per_video, heat_weight, pos_weight, verbose, video_kwargs,
        dev, losses)


def train_pose_graph(nodes, output: str, in_shape: Tuple[int, int, int],
                     steps: int = 2000, batch: int = 4, lr: float = 2e-3,
                     seed: int = 0, n_videos: int = 24,
                     frames_per_video: int = 8, heat_weight: float = 4.0,
                     pos_weight: float = 30.0, verbose: bool = False,
                     video_kwargs: Optional[dict] = None, *, device="cuda",
                     losses: Optional[list] = None):
    """``train_pose`` for the concat DAG (``graph.CBGraphNet``,
    ``models.pose.pose_graph``; ``cbinfer_tpu/train.py:151``): the same
    supervision and loss, params the graph's name-keyed dict, the forward
    ``CBGraphNet.apply_dense`` of ``graph.convert_graph``. Returns
    (params_dict, train_pck)."""
    dev = resolve_device(device)
    H, W, _ = in_shape
    net = convert_graph(nodes, in_shape, PipelineConfig(device=str(dev)),
                        output=output)
    oh, ow, oc = node_out_shapes(nodes, in_shape)[output]
    if oc != NUM_PAFS + NUM_KEYPOINTS:
        raise ValueError(f"node {output!r} has {oc} channels, not "
                         f"{NUM_PAFS + NUM_KEYPOINTS} (paf | heat)")
    stride = H // oh
    params = init_graph_params(nodes, in_shape, seed, device=dev)
    return _train_pose_common(
        net.apply_dense, params, in_shape, stride, oh, ow, steps, batch, lr,
        seed, n_videos, frames_per_video, heat_weight, pos_weight, verbose,
        video_kwargs, dev, losses)


def _pose_dataset(H, W, oh, ow, stride, seed, n_videos, frames_per_video,
                  video_kwargs=None):
    """(frames, targets, kps, valids) from the sprite generator's free
    keypoint ground truth (``cbinfer_tpu/train.py:174``), byte for byte:
    multi-scale sprites (each video draws its own size from 16, 24, 32,
    48 px; sigma and limb width scale with it)."""
    rng = np.random.default_rng(seed)
    sprite_sizes = (16, 24, 32, 48)
    frames, targets, kp_list, valid_list = [], [], [], []
    for i in range(n_videos):
        sprite = int(sprite_sizes[i % len(sprite_sizes)])
        sigma = max(2.0, sprite / (2.0 * stride))     # output-grid pixels
        v = SpriteVideo(SpriteVideoConfig(
            height=H, width=W, n_sprites=3 + int(rng.integers(0, 4)),
            sprite_size=sprite, speed=3.0, noise_std=0.002,
            distinct_classes=True, seed=seed * 100 + i,
            **(video_kwargs or {})))
        fs, ks, vs = v.clip_with_keypoints(frames_per_video)
        frames.append(fs)
        kp_list.append(ks)
        valid_list.append(vs)
        targets.append(np.stack([
            pose_targets(k, m, oh, ow, stride, sigma,
                         limb_width=max(1.0, sprite / (3.0 * stride)))
            for k, m in zip(ks, vs)]))
    return (np.concatenate(frames), np.concatenate(targets),
            np.concatenate(kp_list), np.concatenate(valid_list))


def _train_pose_common(forward, params, in_shape, stride, oh, ow, steps,
                       batch, lr, seed, n_videos, frames_per_video,
                       heat_weight, pos_weight, verbose,
                       video_kwargs=None, device="cuda", losses=None):
    """Shared pose training loop (``cbinfer_tpu/train.py:206``) over a
    params list or dict: ``forward(params, x) -> (..., oh, ow, 56)`` of a
    frame or a batch; Adam under the cosine decay of ``cosine_decay``.
    The PCK is that of the first 16 frames of the data, as in the
    reference."""
    dev = resolve_device(device)
    H, W, _ = in_shape
    rng = np.random.default_rng(seed)
    frames, targets, kps, valids = _pose_dataset(
        H, W, oh, ow, stride, seed, n_videos, frames_per_video,
        video_kwargs)
    frames_d = torch.from_numpy(frames).to(dev)
    targets_d = torch.from_numpy(targets).to(dev)

    opt = torch.optim.Adam(_trainable(params), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))

    def eval_pck(k=16):
        with torch.no_grad():
            pred = forward(params, frames_d[:k]).cpu().numpy()
        return pck_gt(pred, kps[:k], valids[:k], stride)

    idx_all = _batch_indices(rng, frames.shape[0], batch, steps, dev)
    for it in range(steps):
        idx_d = idx_all[it]
        loss = pose_loss(forward, params, frames_d[idx_d], targets_d[idx_d],
                         heat_weight, pos_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if losses is not None:
            losses.append(loss.detach())
        if verbose and it % 100 == 0:
            print(f"step {it}: loss {float(loss.detach()):.5f} "
                  f"pck {eval_pck(8):.3f}", flush=True)
    return _detached(params), float(eval_pck())
