#!/usr/bin/env python3
"""Same-call A/B of the DMA-window probes P1 (``cb_tma_window_write``) and
P2 (``cb_tma_window_read``) built from two or more source trees, on one
card, in turns.

    mkdir -p build/parent
    git archive <commit> cbinfer_tpu_torch | tar -x -C build/parent
    python3 scripts/torch_tma_ab.py \\
        --csrc build/parent/cbinfer_tpu_torch/csrc --csrc cbinfer_tpu_torch/csrc
    python3 scripts/torch_tma_ab.py --device cpu  # the cases, plain arms

Each ``--csrc`` directory holds ``tma_window.cu`` (and the headers it
includes); nvcc builds it (sm_90a) into ``build/tma_ab/``. Each tree's
interface is read from its source: a ``cb_tma_window_write`` that takes
``int threads`` gets this checkout's ``write_plan``, an older one does
not. The cases: the probe's four accepted windows (w1, w4, w6 through P1,
r3 through P2) and the timed windows of its ``SWEEP`` through both. Each
case first checks every tree's output against the plain version bit for
bit, then times each tree as ``chip_smoke.py`` times a kernel (the card
asleep while the host enqueues, L2 flushed by writing 64 MiB, the buffer
restored, untimed, before each launch), ``--reps`` launches a turn, the
trees taking turns (A B .. B A) for ``--rounds`` rounds; ``copy_`` of the
same window (the library call), the plain version and an empty one-block
kernel (the launch floor) take a turn in every round. Prints the card's
name and power limit, then one JSON line per case; ``--out`` also writes
the records as JSON. ``--device cpu`` runs no kernel: each case's plain
version and ``copy_`` arm on CPU tensors against numpy's plain slices, no
times. Without ``--device cpu`` it needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch.ops.kernels import tma_window as K  # noqa: E402
from cbinfer_tpu_torch.ops.kernels.build import ARCH, nvcc_path  # noqa: E402

PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s


def _probe():
    """scripts/torch_probe_dma_constraints.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_probe_dma_constraints",
        os.path.join(REPO, "scripts", "torch_probe_dma_constraints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases():
    """[(kernel, name, the probe's SweepCase)]: w1, w4, w6 through P1, r3
    through P2, then each timed sweep window through P1 and P2."""
    mod = _probe()
    take = ("w1", "w4", "w6", "r3")
    out = [("P1", n, mod.SweepCase(n, (mod.R, mod.G, mod.L), w, 0, True,
                                   True))
           for n, w in mod.WRITE_CASES if n.split()[0] in take]
    out += [("P2", n, mod.SweepCase(n, sh, w, 0, True, True))
            for n, sh, w in mod.READ_CASES if n.split()[0] in take]
    for c in mod.SWEEP:
        if c.timed:
            out += [("P1", c.name, c), ("P2", c.name, c)]
    return mod, out


class Tree:
    """One source tree's P1 and P2 behind their C interfaces."""

    def __init__(self, csrc, out_dir, tag):
        src = os.path.join(csrc, "tma_window.cu")
        with open(src) as f:
            self.plan = bool(re.search(
                r"cb_tma_window_write\([^)]*int threads", f.read()))
        so = os.path.join(out_dir, f"libtma_window_{tag}.so")
        subprocess.run([nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.write = lib.cb_tma_window_write
        self.write.argtypes = [vp, i, vp, vp, vp] + [i] * self.plan \
            + [vp, vp]
        self.read = lib.cb_tma_window_read
        self.read.argtypes = [vp, i, vp, vp, vp, vp, vp, vp]
        for f in (self.write, self.read):
            f.restype = i


def _card(trees, args, mod, kernel, name, case, flush, stream):
    """One case's record on the card."""
    start, box = K.window_bounds(case.shape, case.window)
    r = len(case.shape)
    ops = ((ctypes.c_longlong * r)(*case.shape),
           (ctypes.c_longlong * r)(*start), (ctypes.c_int * r)(*box))
    threads, vpr = K.write_plan(box)
    cu = ctypes.c_int(0)
    write = kernel == "P1"
    values = mod.read_source(case.shape).cuda()
    buf = mod.sweep_buffer(case, "cuda", None if write else values)
    outs = [torch.empty(box, dtype=torch.bfloat16, device="cuda")
            for _ in trees]
    lib_out = torch.empty(box, dtype=torch.bfloat16, device="cuda")
    tile = K.ramp(box, "cuda").contiguous()
    view = buf[case.window]

    def launch(j):
        t = trees[j]
        if write:
            err = t.write(buf.data_ptr(), r, *ops, *([threads] * t.plan),
                          ctypes.byref(cu), stream)
        else:
            err = t.read(buf.data_ptr(), r, *ops, outs[j].data_ptr(),
                         ctypes.byref(cu), stream)
        if err or cu.value:
            raise RuntimeError(f"{name}: CUDA error {err}, CUresult "
                               f"{cu.value}")

    if write:
        restore = buf.zero_
        plain = lambda: K.window_write_plain(buf, case.window)  # noqa: E731
        library = lambda: view.copy_(tile)  # noqa: E731
    else:
        restore = lambda: None  # noqa: E731
        plain = lambda: K.window_read_plain(buf, case.window)  # noqa: E731
        library = lambda: lib_out.copy_(view)  # noqa: E731
    want = (K.window_write_plain(mod.sweep_buffer(case, "cuda"), case.window)
            if write else K.window_read_plain(buf, case.window))
    same = []
    for j in range(len(trees)):
        restore()
        launch(j)
        torch.cuda.synchronize()
        same.append(bool(torch.equal(buf if write else outs[j], want)))

    def turn(fn):
        total = 0.0
        for _ in range(args.reps):
            restore()
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            total += e0.elapsed_time(e1)
        return total / args.reps

    series = {c: [] for c in args.csrc}
    arms = {"copy_ms": library, "plain_ms": plain,
            "empty_ms": lambda: torch.cuda._sleep(0)}
    other = {k: [] for k in arms}
    order = list(range(len(trees)))
    for rnd in range(args.rounds):
        for j in (order if rnd % 2 == 0 else order[::-1]):
            series[args.csrc[j]].append(turn(lambda: launch(j)))
        for k, fn in arms.items():
            other[k].append(turn(fn))
    nbytes = int(np.prod(box)) * 2 * (1 if write else 2)
    return dict(kernel=kernel, case=name, box=list(box), bytes=nbytes,
                plan=[threads, vpr] if write else None,
                bound_ms=nbytes / PEAK_BYTES * 1e3,
                bit_identical_to_plain=same, ms_per_launch=series, **other)


def _cpu(mod, kernel, name, case):
    """One case's plain arms on CPU tensors against numpy's slices."""
    _, box = K.window_bounds(case.shape, case.window)
    values = mod.read_source(case.shape)
    if kernel == "P1":
        want = np.zeros(case.shape, np.float32)
        want[case.window] = np.arange(1, box[-1] + 1, dtype=np.float32)
        plain = K.window_write_plain(mod.sweep_buffer(case, "cpu"),
                                     case.window)
        lib = mod.sweep_buffer(case, "cpu")
        lib[case.window].copy_(K.ramp(box))
    else:
        want = values.float().numpy()[case.window]
        src = mod.sweep_buffer(case, "cpu", values)
        plain = K.window_read_plain(src, case.window)
        lib = torch.empty(box, dtype=torch.bfloat16).copy_(src[case.window])
    threads, vpr = K.write_plan(box)
    return dict(kernel=kernel, case=name, box=list(box), device="cpu",
                plan=[threads, vpr] if kernel == "P1" else None,
                plain_equals_numpy=bool(np.array_equal(
                    plain.float().numpy(), want)),
                copy_equals_numpy=bool(np.array_equal(
                    lib.float().numpy(), want)),
                ms_per_launch=None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (build and time the trees) or cpu (the "
                    "plain arms only)")
    ap.add_argument("--out", default=None, help="write the records here")
    args = ap.parse_args(argv)
    mod, todo = cases()
    records = []
    if args.device == "cpu":
        for kernel, name, case in todo:
            records.append(_cpu(mod, kernel, name, case))
            print(json.dumps(records[-1]), flush=True)
        ok = all(r["plain_equals_numpy"] and r["copy_equals_numpy"]
                 for r in records)
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu for the "
                             "plain arms")
        if not args.csrc:
            raise SystemExit("--csrc: at least one source tree")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
            flush=True)
        tmp = os.path.join(REPO, "build", "tma_ab")  # git-ignored
        os.makedirs(tmp, exist_ok=True)
        trees = [Tree(c, tmp, str(k)) for k, c in enumerate(args.csrc)]
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for kernel, name, case in todo:
            records.append(_card(trees, args, mod, kernel, name, case, flush,
                                 stream))
            print(json.dumps(records[-1]), flush=True)
        ok = all(all(r["bit_identical_to_plain"]) for r in records)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
