"""Window copies on the Tensor Memory Accelerator (P1 and P2).

Replaces the two kernels of ``scripts/probe_dma_constraints.py``:
``run_case`` (P1: a bf16 ramp staged in fast memory and written into a
window of a buffer by one DMA) and ``run_case_read`` (P2: a window of a
buffer read by one DMA and written out to a dense array). Those probes
ask which window shapes the chip's copy engine takes; on Hopper the
engine is TMA, so each wrapper encodes one tensor map whose box is the
window and moves it with one ``cp.async.bulk.tensor``.

On the H100 the launch bounds both, not bytes (``csrc/tma_window.cu``
carries the design note). P1's block builds each 16-byte vector of the ramp
once in registers and stores it into every row it owns, as ``write_plan``
lays the threads out (no division an element), then one thread stores the
tile and waits only until the copy engine has read it. P2 is one thread of
one warp: a tensor load into shared memory and a bulk copy out of it, both
on the copy engine, as the reference's two DMAs.

A window the card will not encode raises ``WindowRefused`` with the
encoder's ``CUresult`` and the rules it breaks (``encode_refusal``, the
encoder's documented rules written out); nothing is copied another way.
A window is a tuple of slices, one per dimension, with step 1.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import Kernel
from .build import check, library

KERNEL_WRITE = Kernel(name="tma_window_write", route="cuda",
                      source="cbinfer_tpu_torch/csrc/tma_window.cu",
                      replaces="scripts/probe_dma_constraints.py:47")
KERNEL_READ = Kernel(name="tma_window_read", route="cuda",
                     source="cbinfer_tpu_torch/csrc/tma_window.cu",
                     replaces="scripts/probe_dma_constraints.py:87")

MAX_RANK = 5
MAX_BOX = 256            # elements of one box extent
ALIGN = 16               # bytes: global address, strides, box rows
MAX_SMEM = 232448        # dynamic shared memory of one block on the H100
MAX_THREADS = 256        # P1's block at most
VEC = ALIGN // 2         # bf16 values in one 16-byte vector


class WindowRefused(RuntimeError):
    """The card did not encode the window's tensor map (``cu_result``, a
    ``CUresult``); ``rules`` are the encoder's rules the window breaks."""

    def __init__(self, what: str, cu_result: int, rules: List[str]):
        self.cu_result, self.rules = cu_result, rules
        super().__init__(f"{what}: CUresult {cu_result} ("
                         f"{'; '.join(rules) or 'no rule written out'})")


def window_bounds(shape: Sequence[int], window) -> Tuple[Tuple[int, ...],
                                                         Tuple[int, ...]]:
    """(origin, box) of a window of a tensor of ``shape``: one slice per
    dimension, step 1, non-empty and in bounds."""
    if len(window) != len(shape):
        raise ValueError(f"window {window} for shape {tuple(shape)}")
    start, box = [], []
    for s, n in zip(window, shape):
        a, b, step = s.indices(n)
        if step != 1 or b <= a or (s.stop is not None and s.stop > n):
            raise ValueError(f"window {window} for shape {tuple(shape)}")
        start.append(a)
        box.append(b - a)
    return tuple(start), tuple(box)


def encode_refusal(shape: Sequence[int], window, element_size: int = 2,
                   address: int = 0) -> List[str]:
    """The rules of ``cuTensorMapEncodeTiled`` (no interleave, no swizzle)
    that a map over the contiguous tensor of ``shape`` at ``address`` with
    the window as its box breaks; empty when it encodes."""
    _, box = window_bounds(shape, window)
    rules = []
    if not 1 <= len(shape) <= MAX_RANK:
        rules.append(f"rank {len(shape)} not in 1..{MAX_RANK}")
    if address % ALIGN:
        rules.append(f"global address not {ALIGN}-byte aligned")
    stride = element_size
    for d in range(len(shape) - 1, 0, -1):
        stride *= shape[d]
        if stride % ALIGN:
            rules.append(f"stride of dim {d - 1} = {stride} B, not a "
                         f"multiple of {ALIGN}")
    for d, b in enumerate(box):
        if b > MAX_BOX:
            rules.append(f"box extent of dim {d} = {b} > {MAX_BOX}")
    if box[-1] * element_size % ALIGN:
        rules.append(f"box row = {box[-1]} x {element_size} = "
                     f"{box[-1] * element_size} B, not a multiple of "
                     f"{ALIGN}")
    return rules


def write_plan(box: Sequence[int]) -> Tuple[int, int]:
    """(threads, vpr) of P1's block for a box: ``vpr`` 16-byte vectors make
    a box row, and the block is ``vpr`` columns by as many rows a step as
    fit in ``MAX_THREADS`` threads and the box has rows; thread (x, y)
    stores vector x of rows y, y + threads / vpr, ... . (0, 0) for a box
    whose row is not whole vectors of at most ``MAX_BOX`` elements: the
    encoder refuses it, and nothing is launched."""
    inner = box[-1]
    if inner % VEC or not 0 < inner <= MAX_BOX:
        return 0, 0
    vpr = inner // VEC
    rows = 1
    for b in box[:-1]:
        rows *= b
    return vpr * min(MAX_THREADS // vpr, rows), vpr


def ramp(box: Sequence[int], device=None) -> torch.Tensor:
    """The P1 tile: ``lane + 1`` over the innermost extent, in bf16 (the
    reference's lane iota plus one), broadcast over the box."""
    r = torch.arange(1, box[-1] + 1, dtype=torch.float32, device=device)
    return r.to(torch.bfloat16).expand(tuple(box))


def window_write_plain(dst: torch.Tensor, window) -> torch.Tensor:
    """Plain PyTorch version of P1: ``dst[window] = ramp``, in place."""
    _, box = window_bounds(dst.shape, window)
    dst[tuple(window)].copy_(ramp(box, dst.device))
    return dst


def window_read_plain(src: torch.Tensor, window) -> torch.Tensor:
    """Plain PyTorch version of P2: a dense copy of ``src[window]``."""
    window_bounds(src.shape, window)
    return src[tuple(window)].clone()


def _fn(name):
    f = getattr(library("tma_window"), name)
    if f.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, i, vp, vp, vp] \
            + ([vp] if name == "cb_tma_window_read" else [i]) + [vp, vp]
        f.restype = ctypes.c_int
    return f


def _card_operands(t: torch.Tensor, window, what: str):
    """ctypes arrays (shape, origin, box) of a window of a card tensor,
    after the checks the kernel relies on."""
    start, box = window_bounds(t.shape, window)
    if (t.dtype != torch.bfloat16 or not t.is_contiguous()
            or not 1 <= t.ndim <= MAX_RANK):
        raise ValueError(f"{what}: a contiguous bf16 tensor of rank 1 to "
                         f"{MAX_RANK}, got {tuple(t.shape)} {t.dtype}")
    n = 2
    for b in box:
        n *= b
    if n + 16 > MAX_SMEM:
        raise ValueError(f"{what}: a {n}-byte window does not fit one "
                         "block's shared memory")
    r = t.ndim
    return ((ctypes.c_longlong * r)(*t.shape),
            (ctypes.c_longlong * r)(*start), (ctypes.c_int * r)(*box), box)


def window_write(dst: torch.Tensor, window, vshape=None) -> torch.Tensor:
    """P1: the ramp written into ``dst[window]`` IN PLACE by one TMA store
    from a tile filled as ``write_plan`` lays out the block (the reference
    aliases its zero buffer to the output). ``vshape``:
    the staged tile's shape, as the reference's scratch; it must be the
    window's. Returns ``dst``; raises ``WindowRefused`` when the card does
    not encode the window."""
    _, box = window_bounds(dst.shape, window)
    if vshape is not None and tuple(vshape) != box:
        raise ValueError(f"window_write: tile {tuple(vshape)} for a "
                         f"window of {box}")
    if dst.device.type == "cpu":
        return window_write_plain(dst, window)
    if not dst.is_cuda:
        raise ValueError("window_write: the tensor must be on the card")
    shape, start, boxa, _ = _card_operands(dst, window, "window_write")
    threads, _ = write_plan(box)
    cu = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    err = _fn("cb_tma_window_write")(dst.data_ptr(), dst.ndim, shape, start,
                                     boxa, threads, ctypes.byref(cu), stream)
    check(err, "tma_window_write")
    if cu.value:
        raise WindowRefused("tma_window_write", cu.value, encode_refusal(
            dst.shape, window, 2, dst.data_ptr()))
    KERNEL_WRITE.launches += 1
    return dst


def window_read(src: torch.Tensor, window) -> torch.Tensor:
    """P2: ``src[window]`` copied into a new dense tensor by one TMA load
    into shared memory and one bulk copy out of it; raises
    ``WindowRefused`` when the card does not encode the window."""
    if src.device.type == "cpu":
        return window_read_plain(src, window)
    if not src.is_cuda:
        raise ValueError("window_read: the tensor must be on the card")
    shape, start, boxa, box = _card_operands(src, window, "window_read")
    out = torch.empty(box, dtype=src.dtype, device=src.device)
    cu = ctypes.c_int(0)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = _fn("cb_tma_window_read")(src.data_ptr(), src.ndim, shape, start,
                                    boxa, out.data_ptr(), ctypes.byref(cu),
                                    stream)
    check(err, "tma_window_read")
    if cu.value:
        raise WindowRefused("tma_window_read", cu.value, encode_refusal(
            src.shape, window, 2, src.data_ptr()))
    KERNEL_READ.launches += 1
    return out
