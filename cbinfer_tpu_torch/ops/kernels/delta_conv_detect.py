"""Fused sparse delta conv + the next layer's change detection (B6).

Replaces ``cbinfer_tpu/ops/pallas/delta_conv_detect.py::
delta_conv_detect_pallas``. The CUDA source (``csrc/delta_conv_detect.cu``)
carries the design note: operations bound it on the H100 as they bound the
delta conv, whose cluster it shares (the same split plan, so the same
sums); the blocks of a tile's cluster combine their per-pixel maxima
through distributed shared memory and accept their own channels of the
changed pixels, so the consumer never re-reads the tile and needs no
launch or hint compaction of its own.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import detect as detect_ops
from ..conv_plan import conv_plan, packed_weights
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel
from .build import check, library
from .delta_conv import channel_quantum, delta_conv_plain
from .detect_sparse import detect_sparse_plain

HINT = 8

KERNEL = Kernel(name="delta_conv_detect", route="cuda",
                source="cbinfer_tpu_torch/csrc/delta_conv_detect.cu",
                replaces="cbinfer_tpu/ops/pallas/delta_conv_detect.py:236")


def fuse_gate(g: TileGeometry, g2: Optional[TileGeometry]) -> bool:
    """Static eligibility of the producer(g) -> consumer(g2) detect fusion:
    the producer's compute tiles are 8x8 (one compute tile is one hint
    tile), its logical out width is a multiple of 8 (no clamped right
    edge), the consumer reads exactly the producer's output map, and the
    consumer's storage has the rows to hold the full last tile row of a
    ragged-height map (rows >= out_h are masked, not clamped). The JAX
    package's gate also asks for 128-lane channel widths, a Mosaic rule
    with no counterpart on the card, so that condition is dropped."""
    if g2 is None:
        return False
    return (g.th == HINT and g.tw == HINT
            and g.out_w % HINT == 0 and g.out_w_pad == g.out_w
            and g2.in_h == g.out_h and g2.in_w == g.out_w
            and g2.store_shape[0] >= g2.store_lo_h + g.out_h_pad)


def delta_conv_detect_plain(xp: torch.Tensor, idx: torch.Tensor,
                            w: torch.Tensor, b: Optional[torch.Tensor],
                            out_cache: torch.Tensor, g: TileGeometry,
                            activation: Optional[str], compute_dtype,
                            next_cache: torch.Tensor, next_tau,
                            g2: TileGeometry, *, count: torch.Tensor):
    """Plain PyTorch version: the plain delta conv, then the plain sparse
    detect of the consumer over the producer's tile list (the producer's
    8x8 tile grid is the consumer's hint grid)."""
    delta_conv_plain(xp, idx, w, b, out_cache, g, activation, compute_dtype,
                     count=count)
    _, mask, npix = detect_sparse_plain(out_cache, next_cache, next_tau, idx,
                                        count, g2)
    return out_cache, next_cache, mask, npix


def _fn():
    f = library("delta_conv_detect").cb_delta_conv_detect
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = ([vp] * 9 + [i] * 14 + [ll, ll, i, i, vp, i, ll]
                      + [i] * 16 + [vp])
        f.restype = ctypes.c_int
    return f


def delta_conv_detect(xp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], out_cache: torch.Tensor,
                      g: TileGeometry, activation: Optional[str],
                      compute_dtype, next_cache: torch.Tensor, next_tau,
                      g2: TileGeometry, *, count: torch.Tensor):
    """Producer delta conv over ``idx[:count]`` plus the consumer's detect
    on the tiles it computed.

    Arguments as ``delta_conv`` plus the consumer's padded input cache
    ``next_cache`` (UPDATED IN PLACE, like ``out_cache``), its threshold
    (a host number, or a 0-d float32 tensor on the card that the kernel
    reads at run time) and its geometry ``g2``. Returns (out_cache,
    next_cache, the consumer's out-tile mask float32 (g2.tiles_h,
    g2.tiles_w), changed pixels int32 (1,)). ``count`` = 0 leaves both
    caches untouched and returns zeros.
    """
    if not fuse_gate(g, g2):
        raise ValueError(f"delta_conv_detect: fuse gate fails for {g} -> {g2}")
    cin, cout = w.shape[2], w.shape[3]
    if (g2.cin != cout or out_cache.shape[-1] != cout
            or next_cache.shape[-1] != cout):
        raise ValueError(
            f"delta_conv_detect: the consumer reads {g2.cin} channels, the "
            f"producer writes {cout} (out cache {tuple(out_cache.shape)}, "
            f"next cache {tuple(next_cache.shape)})")
    if all(t.device.type == "cpu" for t in (xp, out_cache, next_cache)):
        return delta_conv_detect_plain(xp, idx, w, b, out_cache, g,
                                       activation, compute_dtype, next_cache,
                                       next_tau, g2, count=count)
    dtype = xp.dtype
    tensors = [xp, idx, w, out_cache, next_cache, count] \
        + ([b] if b is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("delta_conv_detect: tensors must all be on the card")
    q = channel_quantum(dtype)
    if (dtype not in DTYPE_CODE or w.dtype != dtype
            or out_cache.dtype != dtype or next_cache.dtype != dtype
            or dtype != compute_dtype
            or tuple(xp.shape) != g.store_shape or cin != g.cin
            or tuple(out_cache.shape) != (g.out_h_pad, g.out_w_pad, cout)
            or tuple(next_cache.shape) != g2.store_shape
            or cin % q or cout % q or xp.data_ptr() % 16
            or (b is not None and (b.dtype != torch.float32
                                   or b.shape != (cout,)))
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1 or idx.numel() > g.n_tiles
            or activation not in (None, "relu")):
        raise ValueError(
            f"delta_conv_detect: unsupported operands xp{tuple(xp.shape)} "
            f"{dtype} w{tuple(w.shape)} {w.dtype} out"
            f"{tuple(out_cache.shape)} {out_cache.dtype} next"
            f"{tuple(next_cache.shape)} {next_cache.dtype} compute "
            f"{compute_dtype} for {g} -> {g2}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("delta_conv_detect: operands must be contiguous")
    next_tau = detect_ops.tau_on(next_tau, xp.device)
    mask = torch.zeros((g2.tiles_h, g2.tiles_w), dtype=torch.float32,
                       device=xp.device)
    npix = torch.zeros((1,), dtype=torch.int32, device=xp.device)
    sh, sw = g.stride
    dh, dw = g.dilation
    kh, kw = g.kernel
    s2h, s2w = g2.stride
    if dtype == torch.bfloat16:
        wk, plan = packed_weights(w), conv_plan(cin, cout, kh, kw, g.win_h,
                                                 g.win_w, True)
    else:
        wk, plan = w, (0,) * 6
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = _fn()(xp.data_ptr(), idx.data_ptr(), count.data_ptr(),
                wk.data_ptr(), b.data_ptr() if b is not None else None,
                out_cache.data_ptr(), next_cache.data_ptr(), mask.data_ptr(),
                npix.data_ptr(), idx.numel(), DTYPE_CODE[dtype], cin, cout,
                kh, kw, sh, sw, dh, dw, g.win_h, g.win_w, g.dx0, g.tiles_w,
                xp.shape[1] * cin, g.out_w_pad * cout,
                int(activation == "relu"), int(b is not None),
                next_tau.data_ptr(), g.out_h, next_cache.shape[1] * cout,
                g2.store_lo_h, g2.store_lo_w, g2.tiles_h, g2.tiles_w,
                g2.th * s2h, g2.tw * s2w, g2.pad_lo_h, g2.pad_lo_w,
                g2.win_h, g2.win_w, *plan, stream)
    check(err, "delta_conv_detect")
    KERNEL.launches += 1
    return out_cache, next_cache, mask, npix
