"""Full-map detect + accept + dilate of the small-cin stem (B4).

Replaces ``cbinfer_tpu/ops/pallas/flat4_detect.py::
detect_accept_flat4_pallas``. The CUDA source (``csrc/stem_detect.cu``)
carries the design note: bytes bound it on the H100 (the float32 frame and
the cache are read once); one thread per pixel compares the UNROUNDED
input, one atomic per block counts, and the 8x8 cell mask is dilated by
same-value stores. The cache is the port's padded HWC stem storage, not the
reference's flat4 buffer (``ops/flat4.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect as detect_ops
from .. import flat4
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel
from .build import check, library

KERNEL = Kernel(name="stem_detect", route="cuda",
                source="cbinfer_tpu_torch/csrc/stem_detect.cu",
                replaces="cbinfer_tpu/ops/pallas/flat4_detect.py:204")


def stem_detect_plain(x: torch.Tensor, storage: torch.Tensor, tau,
                      g: TileGeometry):
    """Plain PyTorch version (same signature and results as the kernel):
    the per-pixel detect of ``flat4.detect_accept_flat4`` plus the windowed
    OR onto the 8x8 cell grid. Updates ``storage`` in place; returns
    (storage, cell mask f32 (H/8, W/8), npix int32 (1,))."""
    storage, changed, n_pix = flat4.detect_accept_flat4(
        x[:g.in_h, :g.in_w], storage, tau, g)
    mask = detect_ops.changed_tile_mask(changed, flat4.cell_geometry(g))
    return storage, mask.float(), n_pix.reshape(1)


def _fn():
    f = library("stem_detect").cb_stem_detect
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 4 + [ctypes.c_float] + [i] * 4 + [ll] \
            + [i] * 10 + [vp]
        f.restype = ctypes.c_int
    return f


def stem_detect(x: torch.Tensor, storage: torch.Tensor, tau,
                g: TileGeometry):
    """Detect + accept + dilate over the whole stem input.

    x: (H, W, cin <= 3) frame, compared as float32 WITHOUT rounding to the
    cache dtype first. storage: the stem's padded HWC input cache (geometry
    ``g``, the (8, 32)-tile stem geometry), UPDATED IN PLACE (the JAX
    package donates and aliases its flat4 buffer). tau < 0 marks every
    pixel. Returns (storage, cell mask f32 (H/8, W/8): the 8x8 cells whose
    3x3 SAME window holds a changed pixel, npix int32 (1,))."""
    H, W, C = g.in_h, g.in_w, g.cin
    if H % flat4.CELL or W % flat4.CELL:
        raise ValueError(f"stem_detect needs an 8-aligned map, got {(H, W)}")
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return stem_detect_plain(x, storage, tau, g)
    if not (x.is_cuda and storage.is_cuda):
        raise ValueError("stem_detect: tensors must all be on the card")
    # no-ops for the contiguous float32 frames of the video path
    x = x[:H, :W].float().contiguous()
    if (storage.dtype not in DTYPE_CODE or tuple(x.shape) != (H, W, C)
            or not 1 <= C <= 4 or tuple(storage.shape) != g.store_shape
            or not storage.is_contiguous()):
        raise ValueError(
            f"stem_detect: unsupported operands x{tuple(x.shape)} "
            f"storage{tuple(storage.shape)} {storage.dtype} for {g}")
    gc = flat4.cell_geometry(g)
    mask = torch.zeros((gc.tiles_h, gc.tiles_w), dtype=torch.float32,
                       device=storage.device)
    npix = torch.zeros((1,), dtype=torch.int32, device=storage.device)
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    err = _fn()(x.data_ptr(), storage.data_ptr(), mask.data_ptr(),
                npix.data_ptr(), float(tau), DTYPE_CODE[storage.dtype], H,
                W, C, storage.shape[1] * C, g.store_lo_h, g.store_lo_w,
                gc.tiles_h, gc.tiles_w, gc.th * gc.stride[0],
                gc.tw * gc.stride[1], gc.pad_lo_h, gc.pad_lo_w, gc.win_h,
                gc.win_w, stream)
    check(err, "stem_detect")
    KERNEL.launches += 1
    return storage, mask, npix
