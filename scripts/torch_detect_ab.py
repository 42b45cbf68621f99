#!/usr/bin/env python3
"""Same-call A/B of the list-walking kernels (B1 ``cb_detect_sparse``, B3
``cb_pool_fused``) built from two or more source trees, on one card, in
turns.

    mkdir -p build/parent
    git archive d4b4d4c cbinfer_tpu_torch | tar -x -C build/parent
    python3 scripts/torch_detect_ab.py \\
        --csrc build/parent/cbinfer_tpu_torch/csrc --csrc cbinfer_tpu_torch/csrc

Each ``--csrc`` directory holds ``detect_sparse.cu`` and ``pool_fused.cu``
(and the headers they include). Two C interfaces are known, and each tree
gets its own: one block per list entry up to the capacity (a grid of
``n_blocks``), or a grid sized to the card that walks the list (``cap``
and ``grid``: ``walk_grid`` with the ``BLOCKS_PER_SM`` of the tree's own
``../ops/kernels/*.py`` where it has them, else this checkout's). Every
tree's kernels are built with nvcc (sm_90a) and run on the same seeded
bf16 inputs at the steady-frame shapes and list lengths that
``chip_smoke.py`` records on the scene flagship and on pose, plus one
all-tiles case each: per-launch device ms by CUDA events, L2 flushed, the
cache restored and the mask and npix zeroed before each launch, the trees
taking turns (A B .. B A) for ``--rounds`` rounds; ``ms_per_launch`` is
the kernel alone, ``ms_per_call`` the kernel after the zero-fills its tree's
wrapper makes (one for a list walker, one per output before), as
``chip_smoke.py`` times a call. Each case reports whether every
tree's outputs (cache, mask, npix) equal the first tree's bit for bit and
whether the first tree's equal this checkout's plain version. Prints the
card's name and power limit, then one JSON line per case. Needs a CUDA GPU
and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import sm_count, walk_grid  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import pool_fused as KP  # noqa: E402
from cbinfer_tpu_torch.ops.kernels.build import ARCH, nvcc_path  # noqa: E402

TAU = 0.15  # the scene net's tuned taus
# (kernel, case, map, channels, the layer's geometry, listed entries)
CASES = [
    ("B1", "flagship 360x640 C128 (spec 2)", (360, 640), 128, "conv", 62),
    ("B1", "flagship 180x320 C256 (spec 4)", (180, 320), 256, "conv", 31),
    ("B1", "flagship 180x320 C256 (spec 5)", (180, 320), 256, "conv", 36),
    ("B1", "pose 720x1280 C64", (720, 1280), 64, "conv", 1041),
    ("B1", "pose 360x640 C64", (360, 640), 64, "conv", 601),
    ("B1", "pose 180x320 C128", (180, 320), 128, "conv", 301),
    ("B1", "pose 180x320 C256 on a pool", (180, 320), 256, "pool", 97),
    ("B1", "pose 90x160 C256", (90, 160), 256, "conv", 14),
    ("B1", "all tiles 360x640 C128", (360, 640), 128, "conv", 3600),
    ("B3", "flagship 720x1280 C128 (spec 1)", (720, 1280), 128, "pool", 92),
    ("B3", "flagship 360x640 C256 (spec 3)", (360, 640), 256, "pool", 46),
    ("B3", "pose 720x1280 C64", (720, 1280), 64, "pool", 878),
    ("B3", "pose 360x640 C128", (360, 640), 128, "pool", 429),
    ("B3", "all blocks 720x1280 C128", (720, 1280), 128, "pool", 7200),
]


def _blocks_per_sm(csrc, wrapper, default):
    path = os.path.join(csrc, os.pardir, "ops", "kernels", wrapper)
    if os.path.exists(path):
        with open(path) as f:
            m = re.search(r"^BLOCKS_PER_SM = (\d+)", f.read(), re.M)
        if m:
            return int(m.group(1))
    return default


class Tree:
    """One source tree's B1 and B3 behind one calling convention."""

    def __init__(self, csrc, out_dir, tag):
        with open(os.path.join(csrc, "detect_sparse.cu")) as f:
            self.walks = "int cap, int grid" in f.read()
        self.per_sm = {
            "B1": _blocks_per_sm(csrc, "detect_sparse.py", KD.BLOCKS_PER_SM),
            "B3": _blocks_per_sm(csrc, "pool_fused.py", KP.BLOCKS_PER_SM)}
        procs, libs = [], {}
        for name in ("detect_sparse", "pool_fused"):
            so = os.path.join(out_dir, f"lib{name}_{tag}.so")
            procs.append(subprocess.Popen(
                [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-o", so,
                 os.path.join(csrc, f"{name}.cu")]))
            libs[name] = so
        for p in procs:
            if p.wait():
                raise RuntimeError(f"nvcc failed on {csrc}")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        grid = [i, i] if self.walks else [i]
        self.b1 = ctypes.CDLL(libs["detect_sparse"]).cb_detect_sparse
        self.b1.argtypes = ([vp] * 6 + grid + [ctypes.c_float] + [i] * 4
                            + [ll, ll] + [i] * 10 + [vp])
        self.b1.restype = i
        self.b3 = ctypes.CDLL(libs["pool_fused"]).cb_pool_fused
        self.b3.argtypes = [vp] * 5 + grid + [i] * 7 + [ll, ll, vp]
        self.b3.restype = i

    def grid(self, kind, cap):
        if not self.walks:
            return [cap]
        return [cap, walk_grid(cap, sm_count(torch.cuda.current_device()),
                               self.per_sm[kind])]


def make_case(kind, hw, C, geom, n, gen):
    """Seeded inputs of one case: x, the cache it updates (B1) or the out
    cache (B3), the list, its count, the geometry."""
    h, w = hw
    bf = torch.bfloat16
    if geom == "conv":
        g = conv_tile_geometry((h, w, C), (3, 3), (1, 1), (1, 1), "SAME",
                               8, 8)
    else:
        g = conv_tile_geometry((h, w, C), (2, 2), (2, 2), (1, 1), "VALID",
                               8, 8)
    if kind == "B1":
        cap = -(-h // 8) * (w // 8)
        prev = torch.randn(h, w, C, device="cuda", generator=gen)
        # a quarter of the pixels move by 0.05..0.5 on every channel
        move = (torch.rand(h, w, 1, device="cuda", generator=gen) < 0.25) \
            * torch.empty(h, w, C, device="cuda").uniform_(
                0.05, 0.5, generator=gen)
        x = (prev + move).to(bf)
        st = torch.zeros(g.store_shape, dtype=bf, device="cuda")
        st[g.store_lo_h:g.store_lo_h + h,
           g.store_lo_w:g.store_lo_w + w] = prev.to(bf)
    else:
        cap = (h // 8) * (w // 16)
        x = torch.randn(h, w, C, device="cuda", generator=gen).to(bf)
        st = torch.randn(g.out_h_pad, g.out_w_pad, C, device="cuda",
                         generator=gen).to(bf)
    # compaction lists ids in row-major order
    idx = torch.randperm(cap, device="cuda", generator=gen)[:n].sort() \
        .values.to(torch.int32)
    idx = torch.cat([idx, torch.full((cap - n,), cap, dtype=torch.int32,
                                     device="cuda")])
    count = torch.tensor(n, dtype=torch.int32, device="cuda")
    return x, st, idx, count, g, cap


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    tmp = os.path.join(REPO, "build", "detect_ab")  # git-ignored
    os.makedirs(tmp, exist_ok=True)
    trees = [Tree(c, tmp, str(k)) for k, c in enumerate(args.csrc)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for kind, name, hw, C, geom, n in CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, st0, idx, count, g, cap = make_case(kind, hw, C, geom, n, gen)
        st = st0.clone()
        n_mask = g.tiles_h * g.tiles_w
        out = torch.zeros((n_mask + 1,), dtype=torch.int32, device="cuda")
        mask = out[:n_mask].view(torch.float32).view(g.tiles_h, g.tiles_w)
        npix = out[n_mask:]

        def launch(j):
            tree = trees[j]
            if kind == "B1":
                sh, sw = g.stride
                err = tree.b1(
                    x.data_ptr(), st.data_ptr(), idx.data_ptr(),
                    count.data_ptr(), mask.data_ptr(), npix.data_ptr(),
                    *tree.grid(kind, cap), TAU, 1, g.in_h, C, g.in_w // 8,
                    x.shape[1] * C, st.shape[1] * C, g.store_lo_h,
                    g.store_lo_w, g.tiles_h, g.tiles_w, g.th * sh,
                    g.tw * sw, g.pad_lo_h, g.pad_lo_w, g.win_h, g.win_w,
                    stream)
            else:
                err = tree.b3(
                    x.data_ptr(), st.data_ptr(), idx.data_ptr(),
                    count.data_ptr(), mask.data_ptr(),
                    *tree.grid(kind, cap), 1, C, g.in_w // 16, 8, 16, 2,
                    g.tiles_w, x.shape[1] * C, g.out_w_pad * C, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")

        def fill(j):
            """The zero-fills of tree j's wrapper: one for a list walker
            (mask and npix share a buffer), else one per output."""
            if trees[j].walks:
                out.zero_()
            else:
                mask.zero_()
                if kind == "B1":
                    npix.zero_()

        def restore():
            st.copy_(st0)
            out.zero_()

        outs = []
        for j in range(len(trees)):
            restore()
            launch(j)
            torch.cuda.synchronize()
            outs.append((st.clone(), mask.clone(), npix.clone()))
        same = [all(torch.equal(a, b) for a, b in zip(o, outs[0]))
                for o in outs]
        if kind == "B1":
            sp, mp, pp = KD.detect_sparse_plain(x, st0.clone(), TAU, idx,
                                                count, g)
            plain = (torch.equal(outs[0][0], sp) and torch.equal(
                outs[0][1], mp) and torch.equal(outs[0][2], pp))
            changed = int(pp)
        else:
            sp, mp = KP.detect_pool_fused_plain(x, st0.clone(), idx, count,
                                                g)
            plain = (torch.equal(outs[0][0], sp)
                     and torch.equal(outs[0][1], mp))
            changed = None

        def time_one(j, with_fill):
            total = 0.0
            for _ in range(args.reps):
                restore()
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                if with_fill:
                    fill(j)
                launch(j)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / args.reps

        order = list(range(len(trees)))
        series = {c: [] for c in args.csrc}
        calls = {c: [] for c in args.csrc}
        for r in range(args.rounds):
            for j in (order if r % 2 == 0 else order[::-1]):
                series[args.csrc[j]].append(time_one(j, False))
                calls[args.csrc[j]].append(time_one(j, True))
        print(json.dumps({
            "kernel": kind, "case": name, "channels": C, "listed": n,
            "of": cap, "changed_pixels": changed,
            "grids": [t.grid(kind, cap)[-1] for t in trees],
            "bit_identical_to_first": same, "first_equals_plain": plain,
            "ms_per_launch": series, "ms_per_call": calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
