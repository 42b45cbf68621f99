"""Sparse 3x3 stem conv over the changed (8, 32) stem tiles (B5).

Replaces ``cbinfer_tpu/ops/pallas/patch_stem.py::patch_stem_conv``. The
CUDA source (``csrc/stem_conv.cu``) carries the design note: bytes bound it
at a static-camera clip's stem density; a grid sized to the card walks
(tile, tile row, 16-pixel half, channel chunk) items, one warp each, a lane
keeping its channels' weights in registers and summing in (dy, dx, c)
order in float32. When ``count > capacity`` the walk covers every tile
(the reference's dense overflow branch, without a host branch).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import flat4
from ..delta_conv import gather_windows, scatter_tiles
from ..geometry import TileGeometry
from . import DTYPE_CODE, Kernel, sm_count, walk_grid
from .build import check, library

# blocks of 256 threads (8 warps) per SM: a lane holds its 108 weights and
# 32 accumulators in registers, so one block fills an SM's registers
BLOCKS_PER_SM = 1


def lane_split(cout: int) -> tuple:
    """(cc, lanes, cs) of B5 at ``cout``: a lane takes cc = 4 channels (1
    where cout is no multiple of 4); a block of 8 pixels takes ``lanes``
    lanes, a power of two up to 32 (lanes past cout idle), so that the
    blocks of a 16-pixel item split the warp evenly; a chunk is the
    channels of those lanes, and cout takes 1 << cs chunks, a power of two
    (a chunk past cout idles). The kernel takes these as they are."""
    cc = 4 if cout % 4 == 0 else 1
    lanes = min(32, 1 << (cout // cc - 1).bit_length())
    return cc, lanes, (-(-cout // (lanes * cc)) - 1).bit_length()


def walk_blocks(g: TileGeometry, cout: int) -> int:
    """Blocks of 8 work items (a warp each) that the walk over every tile
    covers, the overflow's: a tile has 8 rows x 2 halves x chunks items."""
    return g.n_tiles * 2 * (1 << lane_split(cout)[2])


KERNEL = Kernel(name="stem_conv", route="cuda",
                source="cbinfer_tpu_torch/csrc/stem_conv.cu",
                replaces="cbinfer_tpu/ops/pallas/patch_stem.py:154")


def _check_geometry(g: TileGeometry) -> None:
    if not (g.kernel == (3, 3) and g.stride == (1, 1)
            and g.dilation == (1, 1) and (g.pad_lo_h, g.pad_lo_w) == (1, 1)
            and (g.th, g.tw) == (flat4.TILE_H, flat4.TILE_W)
            and g.in_h % flat4.TILE_H == 0 and g.in_w % flat4.TILE_W == 0
            and 1 <= g.cin <= 3):
        raise ValueError(f"stem_conv: not a patch-stem geometry: {g}")


def stem_conv_plain(storage: torch.Tensor, idx: torch.Tensor,
                    count: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], out_cache: torch.Tensor,
                    g: TileGeometry, activation: Optional[str],
                    compute_dtype=torch.float32, *,
                    capacity: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: gather the listed tiles' windows, sum the
    9*cin taps in (dy, dx, c) order in float32 (operands, weights AND bias
    rounded through the compute dtype first, as the reference packs them),
    bias, ReLU, scatter into ``out_cache`` in place. ``count > capacity``
    computes every tile."""
    _check_geometry(g)
    n = int(count)
    if capacity is not None and n > capacity:
        ids = torch.arange(g.n_tiles, device=storage.device)
    else:
        ids = idx[:n].long()
    win = gather_windows(storage, ids, g).to(compute_dtype).float()
    wf = w.to(compute_dtype).float()
    acc = torch.zeros((ids.numel(), g.th, g.tw, w.shape[-1]),
                      dtype=torch.float32, device=storage.device)
    for dy in range(3):
        for dx in range(3):
            for c in range(g.cin):
                acc += (win[:, dy:dy + g.th, dx:dx + g.tw, c, None]
                        * wf[dy, dx, c])
    if b is not None:
        acc += b.to(compute_dtype).float()
    if activation == "relu":
        acc = torch.relu(acc)
    return scatter_tiles(out_cache, ids, acc, g)


def _fn():
    f = library("stem_conv").cb_stem_conv
    if f.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [vp] * 6 + [i] * 12 + [ll, ll, vp]
        f.restype = ctypes.c_int
    return f


def stem_conv(storage: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
              w: torch.Tensor, b: Optional[torch.Tensor],
              out_cache: torch.Tensor, g: TileGeometry,
              activation: Optional[str], compute_dtype=torch.float32, *,
              capacity: Optional[int] = None) -> torch.Tensor:
    """Recompute the stem tiles ``idx[:count]`` into ``out_cache``.

    storage: the stem's padded HWC input cache (geometry ``g``: (8, 32)
    tiles); w: (3, 3, cin <= 3, cout) HWIO; b: (cout,) float32 or None;
    out_cache: (H, W, cout), UPDATED IN PLACE (the JAX package donates and
    aliases it) — tiles not listed are never touched. ``count`` is a device
    int32 scalar. ``capacity`` (default: the length of ``idx``) is the
    bound past which the list is cut short: ``count > capacity`` recomputes
    EVERY tile. On the card, storage, weights and out cache share the
    compute dtype."""
    if capacity is None:
        capacity = idx.numel()
    if storage.device.type == "cpu" and out_cache.device.type == "cpu":
        return stem_conv_plain(storage, idx, count, w, b, out_cache, g,
                               activation, compute_dtype, capacity=capacity)
    _check_geometry(g)
    dtype = storage.dtype
    cin, cout = w.shape[2], w.shape[3]
    tensors = [storage, idx, w, out_cache, count] \
        + ([b] if b is not None else [])
    if not all(t.is_cuda for t in tensors):
        raise ValueError("stem_conv: tensors must all be on the card")
    if (dtype not in DTYPE_CODE or w.dtype != dtype
            or out_cache.dtype != dtype or dtype != compute_dtype
            or tuple(storage.shape) != g.store_shape or cin != g.cin
            or tuple(w.shape[:2]) != (3, 3)
            or tuple(out_cache.shape) != (g.out_h_pad, g.out_w_pad, cout)
            # at most 4 chunks of 32 lanes' channels
            or lane_split(cout)[2] > 2
            or out_cache.data_ptr() % 16 or w.data_ptr() % 16
            or (b is not None and (b.dtype != torch.float32
                                   or b.shape != (cout,)))
            or idx.dtype != torch.int32 or count.dtype != torch.int32
            or count.numel() != 1 or not 0 < capacity <= idx.numel()
            or activation not in (None, "relu")):
        raise ValueError(
            f"stem_conv: unsupported operands storage{tuple(storage.shape)} "
            f"{dtype} w{tuple(w.shape)} {w.dtype} out{tuple(out_cache.shape)}"
            f" {out_cache.dtype} compute {compute_dtype} idx"
            f"{tuple(idx.shape)} capacity {capacity} for {g}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("stem_conv: operands must be contiguous")
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    # the overflow walk's items, the most a call can have
    grid = walk_grid(walk_blocks(g, cout), sm_count(storage.device.index),
                     BLOCKS_PER_SM)
    err = _fn()(storage.data_ptr(), idx.data_ptr(), count.data_ptr(),
                w.data_ptr(), b.data_ptr() if b is not None else None,
                out_cache.data_ptr(), grid, DTYPE_CODE[dtype], cin,
                cout, *lane_split(cout), g.tiles_w, g.n_tiles, capacity,
                g.dx0, int(activation == "relu"), storage.shape[1] * cin,
                g.out_w_pad * cout, stream)
    check(err, "stem_conv")
    KERNEL.launches += 1
    return out_cache
