"""Full-map change detection for a layer without a dirty hint (B7).

Replaces ``cbinfer_tpu/ops/pallas/detect.py::detect_full_pallas``. The CUDA
source (``csrc/detect_full.cu``) carries the design note: bytes bound it on
the H100 (x and the cache are read once). An x with the storage's channels
(the wide path) is walked by a grid sized to the card, 8x8-pixel tiles a
step, a warp a tile row with every lane's 16-byte loads in flight before
its first comparison, as in the sparse detect kernel. An x with fewer
channels than the storage, or an odd count (the 3-channel stem, whose
input cache a ``"cuda"`` conv stores at the tile convs' channel grid),
takes a lane 4 pixels, a 16-byte load of each cache pixel, and compares
x's own channels only. A warp step marks an out tile at most once, and
the launch overlaps the one fill of mask and npix.
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect as detect_ops
from ..delta_conv import storage_interior
from ..geometry import TileGeometry, cdiv
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

# blocks of 256 threads per SM of the wide path's walk: a bf16 pixel of
# C = 128 holds 32 registers a lane in loads
BLOCKS_PER_SM = 4

KERNEL = Kernel(name="detect_full", route="cuda",
                source="cbinfer_tpu_torch/csrc/detect_full.cu",
                replaces="cbinfer_tpu/ops/pallas/detect.py:140")


def detect_full_plain(x: torch.Tensor, storage: torch.Tensor, tau,
                      g: TileGeometry):
    """Plain PyTorch version (same signature and results as the kernel):
    ``x`` cast to the cache dtype first, the full-map detect on x's
    channels (the storage's channels past them are left alone), the
    windowed OR onto the layer's out-tile grid. Updates ``storage`` in
    place; returns (storage, mask f32 (tiles_h, tiles_w), npix int32
    (1,))."""
    interior = storage_interior(storage, g)[..., :x.shape[-1]]
    xi = x[:g.in_h, :g.in_w].to(storage.dtype)
    new, changed = detect_ops.detect_and_update(xi, interior, tau)
    interior.copy_(new)
    mask = detect_ops.changed_tile_mask(changed, g).float()
    return storage, mask, changed.sum(dtype=torch.int32).reshape(1)


def _fn():
    f = library("detect_full").cb_detect_full
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 5 + [i] * 6 + [ll, ll] + [i] * 10 + [vp]
        f.restype = ctypes.c_int
    return f


def detect_full(x: torch.Tensor, storage: torch.Tensor, tau,
                g: TileGeometry):
    """Detect + accept + dilate over the whole input map.

    x: (>=H, >=W, cx) current input (only logical coordinates are read),
    compared in the cache dtype; cx <= C, any count (the storage's
    channels past cx keep their values). storage: this layer's
    padded input cache of C channels
    (conv: zero margins; pool: the finite "-inf" fill), UPDATED IN PLACE
    (the JAX package donates and aliases it). tau: a host number or a 0-d
    float32 tensor on the card, which the kernel reads at run time (a
    captured graph takes a new value written into it). Returns (storage,
    mask f32 (tiles_h, tiles_w), npix int32 (1,))."""
    H, W = g.in_h, g.in_w
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return detect_full_plain(x, storage, tau, g)
    if not (x.is_cuda and storage.is_cuda):
        raise ValueError("detect_full: tensors must all be on the card")
    x = x.to(storage.dtype)  # the JAX kernel compares in the cache dtype
    C, cx = storage.shape[-1], x.shape[-1]
    if (storage.dtype not in DTYPE_CODE or not 1 <= cx <= C
            or x.shape[0] < H or x.shape[1] < W
            or tuple(storage.shape) != g.store_shape[:2] + (C,)
            or not x.is_contiguous() or not storage.is_contiguous()):
        raise ValueError(
            f"detect_full: unsupported operands x{tuple(x.shape)} {x.dtype} "
            f"storage{tuple(storage.shape)} {storage.dtype} for {g}")
    tau = detect_ops.tau_on(tau, storage.device)
    # mask and npix are two views of one buffer: one fill per call
    n_mask = g.tiles_h * g.tiles_w
    out = torch.zeros((n_mask + 1,), dtype=torch.int32, device=storage.device)
    mask = out[:n_mask].view(torch.float32).view(g.tiles_h, g.tiles_w)
    npix = out[n_mask:]
    sh, sw = g.stride
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    # the wide path's walk over the 8x8-pixel tiles (the narrow path sizes
    # its own grid)
    grid = walk_grid(cdiv(H, 8) * cdiv(W, 8), sm_count(storage.device.index),
                     BLOCKS_PER_SM)
    err = _fn()(x.data_ptr(), storage.data_ptr(), mask.data_ptr(),
                npix.data_ptr(), tau.data_ptr(), DTYPE_CODE[storage.dtype],
                H, W, C, cx, grid, x.shape[1] * cx, storage.shape[1] * C,
                g.store_lo_h, g.store_lo_w, g.tiles_h, g.tiles_w, g.th * sh,
                g.tw * sw, g.pad_lo_h, g.pad_lo_w, g.win_h, g.win_w, stream)
    check(err, "detect_full")
    KERNEL.launches += 1
    return storage, mask, npix
