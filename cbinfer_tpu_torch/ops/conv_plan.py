"""Launch plan and weight packing of the bf16 tile-conv kernels (B2
``delta_conv`` and B6 ``delta_conv_detect``, ``csrc/cb_conv.cuh``).

A changed out tile of 64 pixels is computed by a CLUSTER of ``csize``
blocks, each owning slices of ``n_blk`` output channels. The plan depends
on cout alone, so B2 and B6 sum every output in the same order (B6 stays
bit-identical to B2 followed by B1):

    cout <= 64        one block, n_blk = 16, 32 or 64 (cout rounded up)
    64 < cout <= 128  n_blk = 32, csize = cout / 32 (128 -> 4 x 32)
    cout > 128        n_blk = 64, csize = min(8, cout / 64) (256 -> 4 x 64,
                      512 -> 8 x 64); past 512 a block takes slices rank,
                      rank + 8, ... in turn

A slice past cout (cout off the n_blk grid) is computed on zero weights
and not stored. A block streams its slices' weights through a ring of ``stages``
shared-memory stages of ``STAGE_STEPS`` k-steps (16 input channels each)
with 1-D bulk copies, from the packed copy that ``pack_weights`` makes
once per weight tensor: per slice, per stage, the ``n_blk x 64`` operand
in the layout the wgmma reads as a K-major B with the 128-byte swizzle
(each output channel's 64 input channels one 128-byte row, the 16-byte
chunk c of row n stored at chunk c ^ (n % 8)). Every tap's input channels
are padded to a multiple of 16 and the k-steps to a multiple of
``STAGE_STEPS``, with zero weights.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

SMEM_LIMIT = 232_448   # dynamic shared memory one H100 block may opt into
SMEM_HEADER = 1024     # mbarriers, per-pixel partial maxima and flags
SMEM_ALIGN = 1024      # slack to align the ring to the 1024-byte swizzle atom
STAGE_STEPS = 4        # k-steps (16 input channels each) per ring stage
MAX_STAGES = 4
MAX_CLUSTER = 8        # the portable cluster size


class ConvPlan(NamedTuple):
    n_blk: int    # output channels of one slice (the wgmma's N)
    csize: int    # blocks per tile: one cluster (up to MAX_CLUSTER)
    slices: int   # slices of n_blk covering cout (the last may overhang)
    steps: int    # k-steps of 16 input channels, padded to STAGE_STEPS
    stages: int   # ring stages
    smem: int     # dynamic shared memory bytes of one block


def split(cout: int):
    """(n_blk, csize, slices) for cout output channels."""
    if cout <= 64:
        n = 16 if cout <= 16 else 32 if cout <= 32 else 64
    else:
        n = 32 if cout <= 128 else 64
    slices = -(-cout // n)
    return n, min(MAX_CLUSTER, slices), slices


def pixel_stride(cin: int) -> int:
    """Staged elements per window pixel (``conv_pixel_stride`` of
    cb_conv.cuh): the channels plus 8 (16 off the 16-channel grid), so the
    8 pixels one ldmatrix phase reads fall in different bank groups."""
    return cin + (16 if cin % 16 else 8)


def k_steps(cin: int, kh: int, kw: int) -> int:
    t = kh * kw * (-(-cin // 16))
    return -(-t // STAGE_STEPS) * STAGE_STEPS


@functools.lru_cache(maxsize=None)
def conv_plan(cin: int, cout: int, kh: int, kw: int, win_h: int,
              win_w: int, detect: bool = False) -> ConvPlan:
    """The whole launch plan of one layer's bf16 tile conv; ``detect``:
    B6's, whose block also stages the consumer cache's 64 pixels at its
    channels when it has one slice. Raises when the window does not fit a
    block's shared memory."""
    n, csize, slices = split(cout)
    window = win_h * win_w * pixel_stride(cin) * 2
    if detect and slices <= csize:
        window += 64 * (n + 8) * 2
    stage = STAGE_STEPS * n * 16 * 2
    free = SMEM_LIMIT - SMEM_HEADER - SMEM_ALIGN - window
    stages = min(MAX_STAGES, free // stage)
    if stages < 1:
        raise ValueError(f"tile conv: a {win_h}x{win_w}x{cin} window does "
                         "not fit one block's shared memory")
    return ConvPlan(n, csize, slices, k_steps(cin, kh, kw), stages,
                    SMEM_HEADER + SMEM_ALIGN + stages * stage + window)


def _swizzle(n: int, device) -> torch.Tensor:
    """[r, c]: the chunk that 16-byte position c of row r holds, c ^ r % 8
    (an involution: the same table packs and unpacks). Made on ``device``:
    a copy from the host would sync a frame loop."""
    r = torch.arange(n, device=device).view(n, 1)
    return torch.arange(8, device=device).view(1, 8) ^ (r % 8)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO (kh, kw, cin, cout) -> the packed operand, (slices, stages,
    n_blk, 8, 8): [s, g, r, c, e] is the weight of input row
    64 g + 8 (c ^ r % 8) + e (taps in HWIO order, each padded to 16
    channels) and output channel s n_blk + r; zeros where either is
    padding."""
    kh, kw, cin, cout = w.shape
    n, _, slices = split(cout)
    cin16 = -(-cin // 16) * 16
    steps = k_steps(cin, kh, kw)
    wp = w.new_zeros((steps * 16, slices * n))
    wp[:kh * kw * cin16].view(kh * kw, cin16, slices * n)[:, :cin, :cout] \
        = w.reshape(kh * kw, cin, cout)
    wp = wp.view(steps // STAGE_STEPS, 8, 8, slices, n) \
        .permute(3, 0, 4, 1, 2)                 # [s, g, r, c, e] unswizzled
    rows = torch.arange(n, device=w.device).view(n, 1)
    return wp[:, :, rows, _swizzle(n, w.device)].contiguous()


def unpack_weights(wp: torch.Tensor, kh: int, kw: int, cin: int,
                   cout: int) -> torch.Tensor:
    """The inverse of ``pack_weights``."""
    slices, stages, n = wp.shape[:3]
    rows = torch.arange(n, device=wp.device).view(n, 1)
    wp = wp[:, :, rows, _swizzle(n, wp.device)]
    cin16 = -(-cin // 16) * 16
    full = wp.permute(1, 3, 4, 0, 2).reshape(stages * 64, slices * n)
    return full[:kh * kw * cin16].view(kh * kw, cin16, -1)[:, :cin, :cout] \
        .reshape(kh, kw, cin, cout)


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """The packed copy of ``w``, made at its first use and kept on the
    tensor itself (beside the HWIO weights the plain versions read); made
    anew if ``w`` was written in place since."""
    got = getattr(w, "_cb_packed", None)
    if got is None or got[0] != w._version:
        got = (w._version, pack_weights(w))
        w._cb_packed = got
    return got[1]
