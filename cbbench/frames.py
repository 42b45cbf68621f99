"""The benchmark's frames: synthetic static-camera video made on the card
from ``--seed``, as one ring of frames that the window replays.

A plain-torch copy of the sprite arithmetic of the program's synthetic
video (a smooth near-gray background, square sprites of palette colours
bouncing off the frame's edges, optional graded dynamics and a wrapping
camera pan), drawn with ``torch.Generator``s on the frames' device. It is
not bit-identical to the program's generator (another random source), and
nothing of the program is imported.

``--seed`` draws the sensor noise and the smooth noise fields and picks
one of the four mirror images of the whole clip (mirroring keeps the
8-pixel tile grid). The scene itself (background, sprites, their paths,
the illumination field) comes from the traffic file's ``scene_seed``
where it has one, so that every seed gives the same work: there the
change-based work differs from seed to seed only by what the noise moves
across a threshold. Without one, the seed draws the scene as well.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PALETTE = torch.tensor([
    [0.90, 0.10, 0.10], [0.10, 0.85, 0.10], [0.15, 0.20, 0.95],
    [0.92, 0.88, 0.12], [0.88, 0.12, 0.88], [0.10, 0.88, 0.88],
    [0.95, 0.55, 0.10]])
POSE_CLASSES = 6   # distinct classes: 1..6 (18 keypoints of 3 parts)
BG_CHROMA = 0.12
NOISE_STREAM = 0x5DEECE66D  # keeps the noise's draws apart from the scene's


def _upsample(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, C, gh, gw) -> (N, C, h, w), bilinear with the corners aligned
    (the program's ``linspace(0, g - 1, n)`` interpolation)."""
    return F.interpolate(coarse, size=(h, w), mode="bilinear",
                         align_corners=True)


def smooth_noise(gen, h: int, w: int, c: int, device, octaves: int = 4):
    """(c, h, w) multi-octave value noise scaled to [0, 1]."""
    img = torch.zeros((c, h, w), device=device)
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        coarse = torch.randn((1, c, gh, gw), generator=gen, device=device)
        img += _upsample(coarse, h, w)[0] / (2 ** o)
    img -= img.min()
    img /= img.max().clamp_min(1e-6)
    return img


def make_ring(video: dict, n_frames: int, seed: int, h: int, w: int,
              device, block: int = 32) -> torch.Tensor:
    """(n_frames, h, w, 3) float32 frames of ``video``'s parameters from
    ``seed``, on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)  # the scene
    gen.manual_seed(int(video.get("scene_seed", seed)) % (1 << 63))
    noise = torch.Generator(device=dev)  # the noise: always the run's seed
    noise.manual_seed((int(seed) ^ NOISE_STREAM) % (1 << 63))
    flips = [d for d, bit in ((1, 1), (2, 2)) if int(seed) & bit]

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    n, s = int(video["n_sprites"]), int(video["sprite_size"])
    lum = smooth_noise(gen, h, w, 1, dev)
    chroma = smooth_noise(gen, h, w, 3, dev)
    background = (0.12 + 0.76 * lum + BG_CHROMA * (chroma - 0.5)).clamp(0, 1)
    if video.get("distinct_classes"):
        classes = 1 + torch.randperm(POSE_CLASSES, generator=gen,
                                     device=dev)[:n]
    else:
        classes = 1 + (uniform(n) * len(PALETTE)).long().clamp(
            max=len(PALETTE) - 1)
    colors = (PALETTE.to(dev)[classes - 1]
              + (uniform(n, 3) * 2 - 1) * 0.04).clamp(0, 1)
    pos = uniform(n, 2) * torch.tensor([h - s, w - s], device=dev)
    ang = uniform(n) * (2 * math.pi)
    speed = float(video["speed"])
    vel = speed * torch.stack([torch.sin(ang), torch.cos(ang)], -1)
    light = float(video.get("light_drift", 0.0))
    if light > 0:
        phase = 2 * math.pi * smooth_noise(gen, h, w, 1, dev)
    cdrift = float(video.get("color_drift", 0.0))
    if cdrift > 0:
        d = torch.randn((n, 3), generator=gen, device=dev)
        cdir = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-6)
        cphase = uniform(n)
        cperiod = float(video["color_period"]) * (0.75 + 0.5 * uniform(n))
    # the sprites' paths: a few numbers, stepped on the host
    pos_h, vel_h = pos.cpu().tolist(), vel.cpu().tolist()
    paths = []
    for _ in range(n_frames):
        paths.append([(int(p[0]), int(p[1])) for p in pos_h])
        for p, v in zip(pos_h, vel_h):
            for a, lim in ((0, h - s), (1, w - s)):
                p[a] += v[a]
                if p[a] < 0:
                    v[a], p[a] = -v[a], -p[a]
                elif p[a] > lim:
                    v[a], p[a] = -v[a], 2 * lim - p[a]
    pan = [float(v) for v in video.get("pan", (0.0, 0.0))]
    nstd = float(video.get("noise_std", 0.0))
    sstd = float(video.get("noise_smooth_std", 0.0))
    scale = int(video.get("noise_smooth_scale", 48))
    ring = torch.empty((n_frames, h, w, 3), device=dev)
    for t0 in range(0, n_frames, block):
        t1 = min(n_frames, t0 + block)
        img = background.expand(t1 - t0, 3, h, w).clone()
        for t in range(t0, t1):
            if pan != [0.0, 0.0]:
                img[t - t0] = torch.roll(
                    background, (round(t * pan[0]), round(t * pan[1])),
                    dims=(1, 2))
            col = colors
            if cdrift > 0:
                sn = torch.sin(2 * math.pi * (t / cperiod + cphase))
                col = (colors + cdrift * sn[:, None] * cdir).clamp(0, 1)
            for i, (y, x) in enumerate(paths[t]):
                img[t - t0, :, y:y + s, x:x + s] = col[i][:, None, None]
        ts = torch.arange(t0, t1, device=dev, dtype=torch.float32)
        if light > 0:
            period = float(video["light_period"])
            img *= 1.0 + light * torch.sin(
                2 * math.pi * ts[:, None, None, None] / period + phase)
        if sstd > 0:
            gh, gw = max(2, -(-h // scale) + 1), max(2, -(-w // scale) + 1)
            coarse = torch.randn((t1 - t0, 1, gh, gw), generator=noise,
                                 device=dev)
            img += _upsample(coarse, h, w) * sstd
        if nstd > 0:
            img += torch.randn(img.shape, generator=noise, device=dev) * nstd
        if nstd > 0 or light > 0 or sstd > 0:
            img.clamp_(0, 1)
        if flips:  # (t, c, h, w): mirror rows (2) and/or columns (3)
            img = torch.flip(img, [d + 1 for d in flips])
        ring[t0:t1] = img.permute(0, 2, 3, 1)
    return ring
