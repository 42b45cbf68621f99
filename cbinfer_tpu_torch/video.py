"""Synthetic static-camera video with labels (numpy copy of the parts of
``cbinfer_tpu.video`` the port's smoke run and tests need).

A fixed smooth near-gray background plus moving square sprites whose class
is their palette color. For the same config the frames and labels are
byte-identical to the JAX package's ``SpriteVideo`` (same generator, same
draw order), on the default and the ``"hard"`` palette, with or without the
graded-change dynamics (slow illumination drift, spatially smooth sensor
noise, sprite colour pulsation) of the pose profile, and with the sprites'
keypoint ground truth, and under a global camera pan (the background
scrolls, wrapping, under the sprites). ``two_frame_pair`` is the fixture of
the single change-gated conv; ``pose_targets`` the pose net's training
target (heatmaps and limb fields from the keypoint ground truth).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def _smooth_noise(rng: np.random.Generator, h: int, w: int, c: int,
                  octaves: int = 4) -> np.ndarray:
    """Multi-octave value noise: a plausible static camera background."""
    img = np.zeros((h, w, c), dtype=np.float32)
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        coarse = rng.standard_normal((gh, gw, c)).astype(np.float32)
        yi = np.linspace(0, gh - 1, h)
        xi = np.linspace(0, gw - 1, w)
        y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, gh - 1)
        x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, gw - 1)
        wy = (yi - y0)[:, None, None]; wx = (xi - x0)[None, :, None]
        up = ((coarse[y0][:, x0] * (1 - wy) * (1 - wx))
              + (coarse[y0][:, x1] * (1 - wy) * wx)
              + (coarse[y1][:, x0] * wy * (1 - wx))
              + (coarse[y1][:, x1] * wy * wx))
        img += up / (2 ** o)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


@dataclass
class SpriteVideoConfig:
    height: int = 72
    width: int = 128
    channels: int = 3
    n_sprites: int = 3
    sprite_size: int = 12          # square sprite edge, pixels
    speed: float = 2.0             # pixels / frame
    noise_std: float = 0.0         # per-pixel sensor noise
    seed: int = 0
    # Pose videos: sprite classes drawn WITHOUT replacement from classes
    # 1..POSE_CLASSES, so every (class, part) keypoint type has at most one
    # instance per frame and per-channel argmax PCK is well defined.
    distinct_classes: bool = False
    palette: str = "default"       # "default" | "hard" (CLASS_PALETTE_HARD)
    # Graded-change dynamics, each an idempotent function of the frame
    # index. light_drift: amplitude of a slow multiplicative illumination
    # oscillation whose phase varies smoothly across the frame, so tiles
    # cross any given tau at different frames. noise_smooth_std: per-frame
    # zero-mean noise correlated over noise_smooth_scale pixels.
    # color_drift: per-sprite colour pulsation, slower than motion, too
    # small to flip the class.
    light_drift: float = 0.0
    light_period: float = 192.0
    noise_smooth_std: float = 0.0
    noise_smooth_scale: int = 48
    color_drift: float = 0.0
    color_period: float = 96.0
    # Global camera pan, (dy, dx) pixels/frame: the background scrolls
    # (wrapping) under the sprites. The worst case of a change-based
    # system: every tile is dirty every frame, and the stem's capacity
    # overflow carries the frame (the change-rate sweep's pan points).
    pan: Tuple[float, float] = (0.0, 0.0)


# Pose supervision: parts per sprite are its centre and its top-left and
# bottom-right corners; keypoint type = (class - 1) * 3 + part for classes
# 1..POSE_CLASSES (18 types, the OpenPose heatmap count). Limbs per
# sprite: top-left -> centre, centre -> bottom-right, top-left ->
# bottom-right, 18 limbs in all, each a (dy, dx) pair of PAF channels: 36
# of the 38 OpenPose PAF channels (the last 2 train to zero). The model's
# output layout is [paf(38) | heat(18)].
POSE_CLASSES = 6
POSE_PARTS = 3
NUM_KEYPOINTS = POSE_CLASSES * POSE_PARTS
POSE_LIMB_PARTS = ((1, 0), (0, 2), (1, 2))
NUM_PAFS = 38


CLASS_PALETTE = np.array([
    [0.90, 0.10, 0.10],   # class 1: red
    [0.10, 0.85, 0.10],   # class 2: green
    [0.15, 0.20, 0.95],   # class 3: blue
    [0.92, 0.88, 0.12],   # class 4: yellow
    [0.88, 0.12, 0.88],   # class 5: magenta
    [0.10, 0.88, 0.88],   # class 6: cyan
    [0.95, 0.55, 0.10],   # class 7: orange
], dtype=np.float32)
# HARD variant: every class compressed toward mid-gray (max channel
# contrast ~0.14 against ~0.85), so tau-scale cache drift moves argmaxes.
CLASS_PALETTE_HARD = 0.5 + 0.16 * (CLASS_PALETTE - 0.5)
BG_CHROMA = 0.12  # background per-channel deviation around the gray


def _keyed_smooth_field(key, h: int, w: int, scale: int) -> np.ndarray:
    """(h, w, 1) zero-mean unit-std noise field correlated over ``scale``
    pixels, deterministic in ``key``: an idempotent per-timestep read."""
    rng = np.random.default_rng(key)
    gh = max(2, -(-h // scale) + 1)
    gw = max(2, -(-w // scale) + 1)
    coarse = rng.standard_normal((gh, gw, 1)).astype(np.float32)
    yi = np.linspace(0, gh - 1, h)
    xi = np.linspace(0, gw - 1, w)
    y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, gh - 1)
    x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, gw - 1)
    wy = (yi - y0)[:, None, None].astype(np.float32)
    wx = (xi - x0)[None, :, None].astype(np.float32)
    return ((coarse[y0][:, x0] * (1 - wy) * (1 - wx))
            + (coarse[y0][:, x1] * (1 - wy) * wx)
            + (coarse[y1][:, x0] * wy * (1 - wx))
            + (coarse[y1][:, x1] * wy * wx))


class SpriteVideo:
    """Static background + moving square sprites. O(1) memory per frame."""

    def __init__(self, cfg: SpriteVideoConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        lum = _smooth_noise(rng, cfg.height, cfg.width, 1)
        chroma = _smooth_noise(rng, cfg.height, cfg.width, cfg.channels)
        self.background = np.clip(
            0.12 + 0.76 * lum + BG_CHROMA * (chroma - 0.5),
            0.0, 1.0).astype(np.float32)
        if cfg.distinct_classes:
            if cfg.n_sprites > POSE_CLASSES:
                raise ValueError(f"distinct_classes needs n_sprites <= "
                                 f"{POSE_CLASSES}, got {cfg.n_sprites}")
            self.classes = (1 + rng.permutation(POSE_CLASSES)
                            [:cfg.n_sprites]).astype(np.int32)
        else:
            self.classes = 1 + rng.integers(0, len(CLASS_PALETTE),
                                            cfg.n_sprites).astype(np.int32)
        if cfg.palette not in ("default", "hard"):
            raise ValueError(f"unknown palette {cfg.palette!r}")
        pal = CLASS_PALETTE if cfg.palette == "default" else CLASS_PALETTE_HARD
        base = np.stack([np.resize(pal[c - 1], cfg.channels)
                         for c in self.classes]) if cfg.n_sprites \
            else np.zeros((0, cfg.channels), np.float32)
        jit_amp = 0.04 if cfg.palette == "default" else 0.01
        jitter = rng.uniform(-jit_amp, jit_amp,
                             (cfg.n_sprites, cfg.channels)).astype(np.float32)
        self.colors = np.clip(base + jitter, 0.0, 1.0).astype(np.float32)
        self.pos = rng.uniform(0, [cfg.height - cfg.sprite_size,
                                   cfg.width - cfg.sprite_size],
                               (cfg.n_sprites, 2)).astype(np.float32)
        ang = rng.uniform(0, 2 * np.pi, cfg.n_sprites)
        self.vel = (cfg.speed * np.stack([np.sin(ang), np.cos(ang)], -1)
                    ).astype(np.float32)
        # graded-change dynamics: precomputed fields, drawn after the
        # sprites so the plain distribution's draws are unchanged
        if cfg.light_drift > 0:
            # smooth phase field spanning one full cycle across the frame
            self._light_phase = (2.0 * np.pi * _smooth_noise(
                rng, cfg.height, cfg.width, 1)).astype(np.float32)
        if cfg.color_drift > 0 and cfg.n_sprites:
            d = rng.standard_normal((cfg.n_sprites, cfg.channels))
            self._cdrift_dir = (d / np.maximum(
                np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
            ).astype(np.float32)
            self._cdrift_phase = rng.uniform(
                0, 1, cfg.n_sprites).astype(np.float32)
            # per-sprite period jitter de-synchronizes the sprites
            self._cdrift_period = (cfg.color_period * rng.uniform(
                0.75, 1.25, cfg.n_sprites)).astype(np.float32)
        self.frame_index = 0

    def _sprite_colors_at(self, t: int) -> np.ndarray:
        """Per-sprite colors at timestep t (color_drift pulsation)."""
        cfg = self.cfg
        if cfg.color_drift <= 0 or not cfg.n_sprites:
            return self.colors
        s = np.sin(2.0 * np.pi * (t / self._cdrift_period
                                  + self._cdrift_phase))
        return np.clip(self.colors + cfg.color_drift
                       * s[:, None].astype(np.float32) * self._cdrift_dir,
                       0.0, 1.0).astype(np.float32)

    def frame(self) -> np.ndarray:
        cfg = self.cfg
        if tuple(cfg.pan) != (0.0, 0.0):
            # wrapping scroll of the background (idempotent in t)
            dy = int(round(self.frame_index * cfg.pan[0]))
            dx = int(round(self.frame_index * cfg.pan[1]))
            img = np.roll(self.background, (dy, dx), axis=(0, 1)).copy()
        else:
            img = self.background.copy()
        colors = self._sprite_colors_at(self.frame_index)
        for i in range(cfg.n_sprites):
            y, x = int(self.pos[i, 0]), int(self.pos[i, 1])
            img[y:y + cfg.sprite_size, x:x + cfg.sprite_size, :] = colors[i]
        if cfg.light_drift > 0:
            # the illumination multiplies background AND sprites
            gain = 1.0 + cfg.light_drift * np.sin(
                2.0 * np.pi * self.frame_index / cfg.light_period
                + self._light_phase)
            img *= gain.astype(np.float32)
        if cfg.noise_smooth_std > 0:
            img += _keyed_smooth_field(
                (cfg.seed + 2, self.frame_index), cfg.height, cfg.width,
                cfg.noise_smooth_scale) * cfg.noise_smooth_std
        if cfg.noise_std > 0:
            # keyed by (seed, timestep): frame() is an idempotent read
            nrng = np.random.default_rng((cfg.seed + 1, self.frame_index))
            img += nrng.normal(0.0, cfg.noise_std, img.shape
                               ).astype(np.float32)
        if (cfg.noise_std > 0 or cfg.light_drift > 0
                or cfg.noise_smooth_std > 0):
            np.clip(img, 0.0, 1.0, out=img)
        return img

    def step(self):
        cfg = self.cfg
        self.frame_index += 1
        self.pos += self.vel
        for d, lim in ((0, cfg.height - cfg.sprite_size),
                       (1, cfg.width - cfg.sprite_size)):
            low = self.pos[:, d] < 0
            high = self.pos[:, d] > lim
            self.vel[low | high, d] *= -1
            self.pos[low, d] *= -1
            self.pos[high, d] = 2 * lim - self.pos[high, d]

    def label(self) -> np.ndarray:
        """(H, W) int32 ground truth: 0 = background, sprite pixels carry
        the sprite's palette class."""
        cfg = self.cfg
        lab = np.zeros((cfg.height, cfg.width), np.int32)
        for i in range(cfg.n_sprites):
            y, x = int(self.pos[i, 0]), int(self.pos[i, 1])
            lab[y:y + cfg.sprite_size, x:x + cfg.sprite_size] = \
                int(self.classes[i])
        return lab

    def pose_keypoints(self):
        """((NUM_KEYPOINTS, 2) float32 [y, x] pixels, (NUM_KEYPOINTS,)
        bool). Keypoint type (c-1)*POSE_PARTS + p holds part p of the
        class-c sprite (0 = centre at y + s/2, 1 = top-left corner, 2 =
        bottom-right corner at y + s - 1, the last covered pixel). Types
        whose class is absent (or > POSE_CLASSES) are invalid."""
        cfg = self.cfg
        kps = np.zeros((NUM_KEYPOINTS, 2), np.float32)
        valid = np.zeros((NUM_KEYPOINTS,), bool)
        s = float(cfg.sprite_size)
        for i in range(cfg.n_sprites):
            c = int(self.classes[i])
            if c > POSE_CLASSES:
                continue
            y, x = float(int(self.pos[i, 0])), float(int(self.pos[i, 1]))
            parts = ((y + s / 2, x + s / 2), (y, x), (y + s - 1, x + s - 1))
            for p, (py, px) in enumerate(parts):
                k = (c - 1) * POSE_PARTS + p
                kps[k] = (py, px)
                valid[k] = True
        return kps, valid

    def clip(self, n: int) -> np.ndarray:
        """(n, H, W, C) float32 clip."""
        fs = []
        for _ in range(n):
            fs.append(self.frame())
            self.step()
        return np.stack(fs)

    def clip_with_labels(self, n: int):
        """((n, H, W, C) float32, (n, H, W) int32)."""
        fs, ls = [], []
        for _ in range(n):
            fs.append(self.frame())
            ls.append(self.label())
            self.step()
        return np.stack(fs), np.stack(ls)

    def clip_with_keypoints(self, n: int):
        """((n, H, W, C) float32, (n, NUM_KEYPOINTS, 2) float32,
        (n, NUM_KEYPOINTS) bool)."""
        fs, ks, vs = [], [], []
        for _ in range(n):
            fs.append(self.frame())
            k, v = self.pose_keypoints()
            ks.append(k)
            vs.append(v)
            self.step()
        return np.stack(fs), np.stack(ks), np.stack(vs)


def pose_targets(kps: np.ndarray, valid: np.ndarray, out_h: int, out_w: int,
                 stride: int, sigma: float, limb_width: float = 2.0
                 ) -> np.ndarray:
    """(out_h, out_w, NUM_PAFS + NUM_KEYPOINTS) float32 training target
    (a copy of ``cbinfer_tpu/video.py:386-431``, ``pose_targets``).

    Channel layout [paf(38) | heat(18)] (module comment above). ``kps`` are
    full-resolution [y, x] pixels; ``sigma``/``limb_width`` are in OUTPUT-
    GRID pixels. Heat channel k: a unit-height Gaussian at kps[k]/stride.
    PAF channels (2l, 2l+1): the limb's unit direction (dy, dx) on pixels
    within ``limb_width`` of the segment, as in OpenPose."""
    heat = np.zeros((out_h, out_w, NUM_KEYPOINTS), np.float32)
    paf = np.zeros((out_h, out_w, NUM_PAFS), np.float32)
    gy = np.arange(out_h, dtype=np.float32)[:, None]
    gx = np.arange(out_w, dtype=np.float32)[None, :]
    for k in range(NUM_KEYPOINTS):
        if not valid[k]:
            continue
        cy, cx = kps[k] / stride
        d2 = (gy - cy) ** 2 + (gx - cx) ** 2
        heat[:, :, k] = np.exp(-d2 / (2.0 * sigma * sigma))
    for c in range(POSE_CLASSES):
        for li, (pa, pb) in enumerate(POSE_LIMB_PARTS):
            ka, kb = c * POSE_PARTS + pa, c * POSE_PARTS + pb
            if not (valid[ka] and valid[kb]):
                continue
            l = c * len(POSE_LIMB_PARTS) + li
            ay, ax = kps[ka] / stride
            by, bx = kps[kb] / stride
            vy, vx = by - ay, bx - ax
            norm = float(np.hypot(vy, vx))
            if norm < 1e-6:
                continue
            uy, ux = vy / norm, vx / norm
            # distance of each grid point to the segment [a, b]
            t = ((gy - ay) * uy + (gx - ax) * ux)
            t = np.clip(t, 0.0, norm)
            dist = np.hypot(gy - (ay + t * uy), gx - (ax + t * ux))
            on = dist <= limb_width
            paf[:, :, 2 * l] += np.where(on, uy, 0.0)
            paf[:, :, 2 * l + 1] += np.where(on, ux, 0.0)
    return np.concatenate([paf, heat], axis=-1)


# Which distribution each workload is trained, tuned and evaluated on, so a
# tau vector calibrated on one is never run on video from another. Seg runs
# the graded dynamics on the hard palette; pose and pose_graph on the
# DEFAULT palette (keypoint-channel identity is keyed by class colour, which
# the hard palette's contrast cannot carry under the illumination drift).
GRADED_DYNAMICS = dict(light_drift=0.10, light_period=192.0,
                       noise_smooth_std=0.012, noise_smooth_scale=48,
                       color_drift=0.05, color_period=96.0)

_WORKLOAD_PROFILES = {
    "scene": {},
    "scene_hard": {"palette": "hard"},
    "seg": {**GRADED_DYNAMICS, "palette": "hard"},
    "pose": dict(GRADED_DYNAMICS),
    "pose_graph": dict(GRADED_DYNAMICS),
}


def workload_video_kwargs(name: str) -> dict:
    """SpriteVideoConfig kwargs of a workload's evaluation distribution:
    a registered profile, or "<base>_hard" for a base without its own entry
    (the base's profile on the hard palette). Merge them into
    SpriteVideoConfig(...) before per-call fields like height and seed;
    unknown names raise."""
    if name in _WORKLOAD_PROFILES:
        return dict(_WORKLOAD_PROFILES[name])
    if name.endswith("_hard") and name[:-5] in _WORKLOAD_PROFILES:
        return {**_WORKLOAD_PROFILES[name[:-5]], "palette": "hard"}
    raise KeyError(f"no video profile for workload {name!r} "
                   f"(have {sorted(_WORKLOAD_PROFILES)})")


def two_frame_pair(h: int = 24, w: int = 32, c: int = 3,
                   moved_pixels: int = 64, seed: int = 0):
    """Two frames that differ in one small square region: the fixture of
    the single change-gated conv layer (BASELINE.json configs[0])."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0, 1, (h, w, c)).astype(np.float32)
    f1 = f0.copy()
    size = max(1, int(np.sqrt(moved_pixels)))
    y = rng.integers(0, h - size)
    x = rng.integers(0, w - size)
    f1[y:y + size, x:x + size, :] = rng.uniform(0, 1, (size, size, c))
    return f0, f1
