"""Full-map detect + accept + dilate of the small-cin stem (B4).

Replaces ``cbinfer_tpu/ops/pallas/flat4_detect.py::
detect_accept_flat4_pallas``. The CUDA source (``csrc/stem_detect.cu``)
carries the design note: bytes bound it on the H100 (the float32 frame and
the cache are read once); a thread holds the loads of one cell's row of 8
pixels in flight and compares the UNROUNDED input, a block of 8 warps owns
32 cells and dilates the 8x8 cell mask with at most one store per cell it
marks (a finer cell, for a configured tile that is not whole 8x8 cells:
one store per cell a changed pixel reaches), and the kernel's launch
overlaps the one fill of mask and npix. The
cache is the port's padded HWC stem storage, not the reference's flat4
buffer (``ops/flat4.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect as detect_ops
from .. import flat4
from ..geometry import TileGeometry, cdiv
from . import DTYPE_CODE, Kernel
from .build import check, library

KERNEL = Kernel(name="stem_detect", route="cuda",
                source="cbinfer_tpu_torch/csrc/stem_detect.cu",
                replaces="cbinfer_tpu/ops/pallas/flat4_detect.py:204")


def stem_detect_plain(x: torch.Tensor, storage: torch.Tensor, tau,
                      g: TileGeometry, cell: int = flat4.CELL):
    """Plain PyTorch version (same signature and results as the kernel):
    the per-pixel detect of ``flat4.detect_accept_flat4`` plus the windowed
    OR onto the grid of ``cell`` x ``cell`` cells. Updates ``storage`` in
    place; returns (storage, cell mask f32 (H/cell, W/cell), npix int32
    (1,))."""
    storage, changed, n_pix = flat4.detect_accept_flat4(
        x[:g.in_h, :g.in_w], storage, tau, g)
    mask = detect_ops.changed_tile_mask(changed,
                                        flat4.cell_geometry(g, cell))
    return storage, mask.float(), n_pix.reshape(1)


def block_plan(H: int, W: int) -> tuple:
    """(blocks over a cell row, grid) of B4 on an 8-aligned H x W map: a
    block owns 8 map rows and 32 cells of them (lane l of warp w the 8
    pixels of its block's cell l in the block's row w), so a cell row
    takes cdiv(W / 8, 32) blocks. The kernel takes these as they are."""
    bw = cdiv(W // flat4.CELL, 32)
    return bw, bw * (H // flat4.CELL)


def vec16(x_ptr: int, st_ptr: int, s_row_bytes: int,
          origin_bytes: int) -> bool:
    """Whether B4 takes 16-byte loads: a thread's 8 pixels then start
    16-byte aligned in the frame (where its pointer is: its rows and
    8-pixel groups are multiples of 32 bytes) and in the storage (where its
    pointer plus the interior's origin and its rows are: a group is 16 * C
    or 32 * C bytes). Else the kernel loads one element at a time."""
    return not any(v % 16 for v in (x_ptr, st_ptr + origin_bytes,
                                    s_row_bytes))


def _fn():
    f = library("stem_detect").cb_stem_detect
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 5 + [i] * 4 + [ll] + [i] * 5 + [vp]
        f.restype = ctypes.c_int
    return f


def stem_detect(x: torch.Tensor, storage: torch.Tensor, tau,
                g: TileGeometry, cell: int = flat4.CELL):
    """Detect + accept + dilate over the whole stem input.

    x: (H, W, cin <= 3) frame, compared as float32 WITHOUT rounding to the
    cache dtype first. storage: the stem's padded HWC input cache (geometry
    ``g``, the (8, 32)-tile stem geometry), UPDATED IN PLACE (the JAX
    package donates and aliases its flat4 buffer). tau: a host number or
    a 0-d float32 tensor on the card, read by the kernel at run time;
    tau < 0 marks every pixel. cell: 8 (the hint grid), or 4, 2 or 1 for
    a configured tile that is not whole 8x8 cells (``flat4.mask_cell``).
    Returns (storage, cell mask f32 (H/cell, W/cell): the cells whose 3x3
    SAME window holds a changed pixel, npix int32 (1,))."""
    H, W, C = g.in_h, g.in_w, g.cin
    if H % flat4.CELL or W % flat4.CELL or cell not in (8, 4, 2, 1):
        raise ValueError(f"stem_detect needs an 8-aligned map and a cell "
                         f"of 8, 4, 2 or 1, got {(H, W)}, cell {cell}")
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return stem_detect_plain(x, storage, tau, g, cell)
    if not (x.is_cuda and storage.is_cuda):
        raise ValueError("stem_detect: tensors must all be on the card")
    # no-ops for the contiguous float32 frames of the video path
    x = x[:H, :W].float().contiguous()
    if (storage.dtype not in DTYPE_CODE or tuple(x.shape) != (H, W, C)
            or not 1 <= C <= 4 or tuple(storage.shape) != g.store_shape
            or not storage.is_contiguous() or x.data_ptr() % 4
            or storage.data_ptr() % storage.element_size()
            or g.kernel != (3, 3) or g.stride != (1, 1)
            or g.dilation != (1, 1) or (g.pad_lo_h, g.pad_lo_w) != (1, 1)):
        raise ValueError(
            f"stem_detect: unsupported operands x{tuple(x.shape)} "
            f"storage{tuple(storage.shape)} {storage.dtype} for {g}")
    tau = detect_ops.tau_on(tau, storage.device)
    # mask and npix are two views of one buffer: one fill per call
    ch, cw = H // cell, W // cell
    out = torch.zeros((ch * cw + 1,), dtype=torch.int32,
                      device=storage.device)
    mask = out[:ch * cw].view(torch.float32).view(ch, cw)
    npix = out[ch * cw:]
    es = storage.element_size()
    s_row = storage.shape[1] * C
    vec = vec16(x.data_ptr(), storage.data_ptr(), s_row * es,
                (g.store_lo_h * s_row + g.store_lo_w * C) * es)
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    err = _fn()(x.data_ptr(), storage.data_ptr(), mask.data_ptr(),
                npix.data_ptr(), tau.data_ptr(), DTYPE_CODE[storage.dtype], H,
                W, C, s_row, g.store_lo_h, g.store_lo_w, int(vec),
                block_plan(H, W)[0], cell, stream)
    check(err, "stem_detect")
    KERNEL.launches += 1
    return storage, mask, npix
