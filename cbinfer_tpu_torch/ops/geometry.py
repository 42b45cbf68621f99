"""Tile/receptive-field geometry shared by all pipeline stages.

A verbatim copy of ``cbinfer_tpu.ops.geometry``: the port keeps the JAX
package's storage shapes (8-aligned left margin ``store_lo_w``, in-window
shift ``dx0``, DMA slack), so caches compare element for element. The CUDA
kernels address the conv window at storage column
``tj*tw*sw + dx0 + dx*dil``; ``win_w_dma``/``win_h_dma`` are TPU DMA extents
and only size the storage margins here.

Tiles are defined on the OUTPUT grid of each layer (SURVEY.md §7 design
stance, refined): the unit of recompute is a (th, tw) block of output
pixels. The input region feeding one output tile is the tile's receptive
field: size ``(th-1)*stride + k_eff`` per dim, at offset
``tile_origin * stride`` in the padded input. Because detection stays
per-pixel, the output-tile mask derived here is the EXACT minimal tile set
covering the per-pixel changed-output map — no input-side over-approximation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_dim(padding, axis: int):
    """Per-axis padding selector: 'SAME'/'VALID' pass through; an explicit
    (ph, pw) pair (torch-style symmetric padding, config.ConvSpec) yields
    the int for this axis."""
    return padding if isinstance(padding, str) else int(padding[axis])


def conv_out_size(n: int, k: int, s: int, d: int, padding) -> int:
    """Output size for one spatial dim. ``padding``: 'SAME' | 'VALID' |
    int (explicit symmetric pad, torch semantics: floor((n+2p-keff)/s)+1)."""
    keff = (k - 1) * d + 1
    if padding == "SAME":
        return cdiv(n, s)
    p = 0 if padding == "VALID" else int(padding)
    return (n + 2 * p - keff) // s + 1


def same_pads(n: int, k: int, s: int, d: int) -> Tuple[int, int]:
    keff = (k - 1) * d + 1
    out = cdiv(n, s)
    total = max(0, (out - 1) * s + keff - n)
    lo = total // 2
    return lo, total - lo


def conv_pads(n: int, k: int, s: int, d: int, padding) -> Tuple[int, int]:
    """(lo, hi) conv padding for one spatial dim under any padding mode.

    Explicit int padding is SYMMETRIC on input (lo == hi == p, torch
    semantics); the effective hi actually consumed may be smaller when the
    strided output grid does not reach it — hi here is the declared pad,
    matching what lax.conv_general_dilated receives."""
    if padding == "SAME":
        return same_pads(n, k, s, d)
    if padding == "VALID":
        return 0, 0
    p = int(padding)
    return p, p


@dataclasses.dataclass(frozen=True)
class TileGeometry:
    """Static geometry of one tiled layer, one spatial dim pair."""

    in_h: int
    in_w: int
    cin: int
    out_h: int       # logical output dims
    out_w: int
    out_h_pad: int   # tile-grid-padded output dims (caches use these; the
    out_w_pad: int   # layer returns the [:out_h, :out_w] crop)
    th: int          # tile height (output pixels)
    tw: int
    tiles_h: int     # tile grid dims
    tiles_w: int
    n_tiles: int
    win_h: int       # input window per tile (incl. halo) — true extent
    win_w: int       # true extent (used for mask dilation semantics)
    # DMA window extents used by the Pallas kernels. Mosaic forbids strided
    # vector slices, so strided (dy, dx) phases are extracted by contiguous
    # slice + reshape-split, which needs th*sh (+ alignment) extra room:
    win_h_dma: int   # >= keff_h-1 + th*sh
    win_w_dma: int   # >= dx0 + keff_w-1 + tw*sw, rounded to 8 (DMA align)
    pad_lo_h: int    # LOGICAL conv padding (mask/dilation semantics)
    pad_hi_h: int
    pad_lo_w: int
    pad_hi_w: int
    # PERSISTENT STORAGE margins: in_cache is stored spatially padded so no
    # per-frame pad copy is needed. Top/left margins hold the conv zero
    # padding; left margin is 8-aligned so the detect kernel's interior tile
    # origins stay DMA-legal, and gathers absorb the residual shift dx0
    # in-kernel. Margins are written once at init, never touched again.
    store_lo_h: int  # == pad_lo_h
    store_hi_h: int
    store_lo_w: int  # == roundup(pad_lo_w, 8)
    store_hi_w: int
    dx0: int         # store_lo_w - pad_lo_w, in [0, 8)
    stride: Tuple[int, int]
    dilation: Tuple[int, int]
    kernel: Tuple[int, int]

    @property
    def store_shape(self) -> Tuple[int, int, int]:
        return (self.in_h + self.store_lo_h + self.store_hi_h,
                self.in_w + self.store_lo_w + self.store_hi_w, self.cin)


def conv_tile_geometry(in_shape: Tuple[int, int, int], kernel, stride, dilation,
                       padding, th: int, tw: int) -> TileGeometry:
    H, W, C = in_shape
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilation
    ph_, pw_ = pad_dim(padding, 0), pad_dim(padding, 1)
    Ho = conv_out_size(H, kh, sh, dh, ph_)
    Wo = conv_out_size(W, kw, sw, dw, pw_)
    th = min(th, Ho)
    tw = min(tw, Wo)
    # Tile grid rounds UP: edge tiles that overhang the logical output are
    # computed on zero-padded input and cropped away by the layer. Costs at
    # most one extra tile row/col of compute; keeps shapes static and aligned.
    tiles_h = cdiv(Ho, th)
    tiles_w = cdiv(Wo, tw)
    Hop, Wop = tiles_h * th, tiles_w * tw
    plo_h, phi_h = conv_pads(H, kh, sh, dh, ph_)
    plo_w, phi_w = conv_pads(W, kw, sw, dw, pw_)
    keff_h = (kh - 1) * dh + 1
    keff_w = (kw - 1) * dw + 1
    win_h = (th - 1) * sh + keff_h
    win_w = (tw - 1) * sw + keff_w
    # storage margins (see TileGeometry doc): 8-aligned left margin
    slo_h = plo_h
    slo_w = ((plo_w + 7) // 8) * 8
    dx0 = slo_w - plo_w
    # DMA extents: room for slice+reshape phase extraction (kernel offset up
    # to dx0 + keff-1, then th*sh rows reshape-split by sh), W rounded to 8
    # for the Mosaic sublane-alignment rule on HBM<->VMEM copies (H is
    # unconstrained, C slices full). Kernels ignore the excess rows/columns.
    win_h_dma = (keff_h - 1) + th * sh
    win_w_dma = ((dx0 + (keff_w - 1) + tw * sw + 7) // 8) * 8
    # storage extents must fit the last tile's DMA window; gather offsets in
    # storage coords are (ti*th*sh, tj*tw*sw).
    shi_h = max(0, (tiles_h - 1) * th * sh + win_h_dma - H - slo_h)
    shi_w = max(0, (tiles_w - 1) * tw * sw + win_w_dma - W - slo_w)
    return TileGeometry(
        in_h=H, in_w=W, cin=C, out_h=Ho, out_w=Wo, out_h_pad=Hop,
        out_w_pad=Wop, th=th, tw=tw,
        tiles_h=tiles_h, tiles_w=tiles_w, n_tiles=tiles_h * tiles_w,
        win_h=win_h, win_w=win_w, win_h_dma=win_h_dma, win_w_dma=win_w_dma,
        pad_lo_h=plo_h, pad_hi_h=phi_h, pad_lo_w=plo_w, pad_hi_w=phi_w,
        store_lo_h=slo_h, store_hi_h=shi_h, store_lo_w=slo_w,
        store_hi_w=shi_w, dx0=dx0,
        stride=(sh, sw), dilation=(dh, dw), kernel=(kh, kw))
