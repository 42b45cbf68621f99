"""Sparse change detection over the producer's dirty hint tiles (B1).

Replaces ``cbinfer_tpu/ops/pallas/detect.py::detect_sparse``. The CUDA
source (``csrc/detect_sparse.cu``) carries the design note: bytes bound
the kernel on the H100 (it reads x and the cache once per visited tile and
writes the accepted pixels), a grid sized to the card walks the
device-side count, a warp holds a whole tile row in flight, and the last
hint row and column may be partial (any map size): nothing past the
logical map is read or written.
"""

from __future__ import annotations

import ctypes

import torch

from .. import detect as detect_ops
from ..delta_conv import storage_interior, tile_ids
from ..geometry import TileGeometry, cdiv
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

HINT = 8
# blocks of 256 threads per SM: a bf16 row of C = 256 holds 64 registers a
# lane in loads, so two blocks fit an SM
BLOCKS_PER_SM = 2

KERNEL = Kernel(name="detect_sparse", route="cuda",
                source="cbinfer_tpu_torch/csrc/detect_sparse.cu",
                replaces="cbinfer_tpu/ops/pallas/detect.py:316")


def detect_sparse_plain(x: torch.Tensor, storage: torch.Tensor, tau,
                        idx: torch.Tensor, count: torch.Tensor,
                        g: TileGeometry):
    """Plain PyTorch version (same signature and results as the kernel).
    Updates ``storage`` in place; returns (storage, mask f32
    (tiles_h, tiles_w), npix int32 (1,))."""
    H, W = g.in_h, g.in_w
    hh, hw = cdiv(H, HINT), cdiv(W, HINT)
    hm = torch.zeros(hh * hw, dtype=torch.bool, device=x.device)
    hm[tile_ids(idx, count)] = True
    # a pixel belongs to the hint tile that holds it: the last hint row
    # and column own what is left of the map
    pix = hm.view(hh, hw).repeat_interleave(HINT, 0).repeat_interleave(
        HINT, 1)[:H, :W]
    interior = storage_interior(storage, g)
    xi = x[:H, :W].to(storage.dtype)
    diff = (xi.float() - interior.float()).abs().amax(dim=-1)
    changed = (diff > detect_ops.tau32(tau)) & pix
    interior.copy_(torch.where(changed[..., None], xi, interior))
    mask = detect_ops.changed_tile_mask(changed, g).float()
    return storage, mask, changed.sum(dtype=torch.int32).reshape(1)


def _fn():
    f = library("detect_sparse").cb_detect_sparse
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp, vp, vp, vp, vp, vp, i, i, vp, i, i, i, i, ll, ll,
                      i, i, i, i, i, i, i, i, i, i, vp]
        f.restype = ctypes.c_int
    return f


def detect_sparse(x: torch.Tensor, storage: torch.Tensor, tau,
                  idx: torch.Tensor, count: torch.Tensor, g: TileGeometry):
    """Detect + accept + dilate restricted to the producer's dirty tiles.

    x: (>=H, >=W, C) current input (may be the producer's padded out
    cache; only logical coordinates are read). storage: this layer's
    padded input cache, UPDATED IN PLACE (the JAX package donates and
    aliases it). idx/count: compacted ids on the 8x8 hint grid of the
    input (``cdiv(H, 8) x cdiv(W, 8)``: any map size), ``count`` a device
    int32 scalar. tau: a host number or a 0-d float32 tensor on the card,
    read by the kernel at run time. Returns (storage, mask f32 (tiles_h,
    tiles_w), npix int32 (1,)).
    """
    H, W = g.in_h, g.in_w
    if x.device.type == "cpu" and storage.device.type == "cpu":
        return detect_sparse_plain(x, storage, tau, idx, count, g)
    x = x.to(storage.dtype)  # the JAX kernel compares in the cache dtype
    C = storage.shape[-1]
    if not (x.is_cuda and storage.is_cuda and idx.is_cuda
            and count.is_cuda):
        raise ValueError("detect_sparse: tensors must all be on the card")
    if (storage.dtype not in DTYPE_CODE or x.shape[-1] != C or C % 2
            or x.shape[0] < H or x.shape[1] < W
            or tuple(storage.shape) != g.store_shape[:2] + (C,)
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1
            or idx.numel() > cdiv(H, HINT) * cdiv(W, HINT)
            or x.data_ptr() % 4 or storage.data_ptr() % 4):
        raise ValueError(
            f"detect_sparse: unsupported operands x{tuple(x.shape)} "
            f"{x.dtype} storage{tuple(storage.shape)} {storage.dtype} "
            f"idx{tuple(idx.shape)} {idx.dtype}")
    for t in (x, storage, idx):
        if not t.is_contiguous():
            raise ValueError("detect_sparse: operands must be contiguous")
    tau = detect_ops.tau_on(tau, storage.device)
    # mask and npix are two views of one buffer: one fill per call
    n_mask = g.tiles_h * g.tiles_w
    out = torch.zeros((n_mask + 1,), dtype=torch.int32, device=storage.device)
    mask = out[:n_mask].view(torch.float32).view(g.tiles_h, g.tiles_w)
    npix = out[n_mask:]
    sh, sw = g.stride
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    grid = walk_grid(idx.numel(), sm_count(storage.device.index),
                     BLOCKS_PER_SM)
    err = _fn()(x.data_ptr(), storage.data_ptr(), idx.data_ptr(),
                count.data_ptr(), mask.data_ptr(), npix.data_ptr(),
                idx.numel(), grid, tau.data_ptr(),
                DTYPE_CODE[storage.dtype], H, C, W, x.shape[1] * C,
                storage.shape[1] * C, g.store_lo_h, g.store_lo_w, g.tiles_h,
                g.tiles_w, g.th * sh, g.tw * sw, g.pad_lo_h, g.pad_lo_w,
                g.win_h, g.win_w, stream)
    check(err, "detect_sparse")
    KERNEL.launches += 1
    return storage, mask, npix
