"""Synthetic static-camera video with labels (numpy copy of the parts of
``cbinfer_tpu.video`` the port's smoke run and tests need).

A fixed smooth near-gray background plus moving square sprites whose class
is their palette color. For the same config the frames and labels are
byte-identical to the JAX package's ``SpriteVideo`` (same generator, same
draw order), on the default and the ``"hard"`` palette. The graded-change
dynamics, camera pan and pose supervision of the original are not copied.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    palette: str = "default"       # "default" | "hard" (CLASS_PALETTE_HARD)


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
        self.frame_index = 0

    def frame(self) -> np.ndarray:
        cfg = self.cfg
        img = self.background.copy()
        for i in range(cfg.n_sprites):
            y, x = int(self.pos[i, 0]), int(self.pos[i, 1])
            img[y:y + cfg.sprite_size, x:x + cfg.sprite_size, :] = \
                self.colors[i]
        if cfg.noise_std > 0:
            # keyed by (seed, timestep): frame() is an idempotent read
            nrng = np.random.default_rng((cfg.seed + 1, self.frame_index))
            img += nrng.normal(0.0, cfg.noise_std, img.shape
                               ).astype(np.float32)
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


# Which distribution each workload is trained, tuned and evaluated on, so a
# tau vector calibrated on one is never run on video from another. The
# graded-change profiles of seg and pose wait for those workloads.
_WORKLOAD_PROFILES = {
    "scene": {},
    "scene_hard": {"palette": "hard"},
}


def workload_video_kwargs(name: str) -> dict:
    """SpriteVideoConfig kwargs of a workload's evaluation distribution.
    Merge them into SpriteVideoConfig(...) before per-call fields like
    height and seed; unknown names raise."""
    if name in _WORKLOAD_PROFILES:
        return dict(_WORKLOAD_PROFILES[name])
    raise KeyError(f"no video profile for workload {name!r} "
                   f"(have {sorted(_WORKLOAD_PROFILES)})")
