#!/usr/bin/env python3
"""Same-call A/B of the tile-conv kernels (B2 ``cb_delta_conv``, B6
``cb_delta_conv_detect``) built from two or more source trees, on one
card, in turns.

    git archive 3e2ee07 cbinfer_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py --csrc build/parent/cbinfer_tpu_torch/csrc \\
                                       --csrc cbinfer_tpu_torch/csrc

Each ``--csrc`` directory holds ``delta_conv.cu`` and
``delta_conv_detect.cu`` (and the headers they include). Two C interfaces
are known, and each tree gets the adapter of its own: the one-block-per-
tile mma.sync kernels (HWIO weights), and the cluster/wgmma kernels (a
tree whose ``cb_conv.cuh`` uses wgmma: weights packed and the launch plan
made by the tree's own ``../ops/conv_plan.py`` where it has one, else by
this checkout's; B6's tau2 a float or, where the tree's source reads it
from device memory, a pointer). Every tree's kernels are
built with nvcc (sm_90a) and run on the same seeded bf16 inputs at the
720p paths' shapes and tile counts (the pose net's 90-, 180-, 360- and
720-row maps, the scene flagship's 180-row map, the plain converter's
3-channel stem on its 8-channel input cache): per-launch device ms by
CUDA events, L2 flushed, the caches restored and B6's mask and count
zeroed (the wrapper's work) before each launch, the
trees taking turns (A B .. B A) for ``--rounds`` rounds. Each case also
reports every tree's largest difference from the first tree's output
(another summation order: within 2e-2, not bit for bit) and, for B6,
whether each tree's consumer mask and npix equal the first tree's. Prints
the card's name and power limit, then one JSON line per case. Needs a
CUDA GPU and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch.ops import conv_plan as own_plan  # noqa: E402
from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry  # noqa: E402
from cbinfer_tpu_torch.ops.kernels.build import ARCH, nvcc_path  # noqa: E402

# (kernel, name, map, cin, cout, kernel size, the consumer's kernel size,
# listed tiles): the steady-frame launches of chip_smoke.py's paths
CASES = [
    ("B2", "scene 180x320 3x3 256->256", (180, 320), 256, 256, 3, None, 60),
    ("B2", "pose 720x1280 3x3 64->64", (720, 1280), 64, 64, 3, None, 1305),
    ("B2", "pose 360x640 3x3 128->128", (360, 640), 128, 128, 3, None, 591),
    ("B2", "pose 180x320 3x3 256->256", (180, 320), 256, 256, 3, None, 97),
    ("B2", "pose 90x160 1x1 256->56", (90, 160), 256, 56, 1, None, 26),
    ("B2", "cin-3 stem 720x1280 3x3 8->128 (cin padded)", (720, 1280), 8,
     128, 3, None, 1440),
    ("B6", "pose 360x640 3x3 64->128", (360, 640), 64, 128, 3, 3, 602),
    ("B6", "pose 180x320 3x3 128->256", (180, 320), 128, 256, 3, 3, 306),
    ("B6", "pose 180x320 3x3 256->256", (180, 320), 256, 256, 3, 3, 190),
    ("B6", "pose 90x160 3x3 256->512", (90, 160), 256, 512, 3, 3, 26),
    ("B6", "pose 90x160 3x3 512->256", (90, 160), 512, 256, 3, 3, 26),
    ("B6", "pose 90x160 3x3 256->128", (90, 160), 256, 128, 3, 3, 26),
    ("B6", "pose 90x160 1x1 128->56", (90, 160), 128, 56, 1, 3, 26),
    ("B6", "pose 90x160 3x3 56->256", (90, 160), 56, 256, 3, 3, 26),
]


class Tree:
    """One source tree's two kernels behind one calling convention."""

    def __init__(self, csrc, out_dir, tag):
        with open(os.path.join(csrc, "cb_conv.cuh")) as f:
            self.wgmma = "wgmma" in f.read()
        self.plan = own_plan
        path = os.path.join(csrc, os.pardir, "ops", "conv_plan.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"plan_{tag}", path)
            self.plan = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(self.plan)
        vp, i, ll, fl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
        plan = [i] * 6 if self.wgmma else []
        libs = {}
        procs = []
        with open(os.path.join(csrc, "delta_conv_detect.cu")) as f:
            # B6 reads tau2 from device memory (a pointer) or takes a float
            self.tau_ptr = bool(re.search(r"const float\* tau2", f.read()))
        for name in ("delta_conv", "delta_conv_detect"):
            so = os.path.join(out_dir, f"lib{name}_{tag}.so")
            procs.append(subprocess.Popen(
                [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-o", so,
                 os.path.join(csrc, f"{name}.cu")]))
            libs[name] = so
        for p in procs:
            if p.wait():
                raise RuntimeError(f"nvcc failed on {csrc}")
        self.b2 = ctypes.CDLL(libs["delta_conv"]).cb_delta_conv
        self.b2.argtypes = [vp] * 6 + [i] * 16 + [ll, ll, i, i] + plan + [vp]
        self.b2.restype = i
        self.b6 = ctypes.CDLL(libs["delta_conv_detect"]).cb_delta_conv_detect
        self.b6.argtypes = ([vp] * 9 + [i] * 14 + [ll, ll, i, i]
                            + [vp if self.tau_ptr else fl, i, ll]
                            + [i] * 10 + plan + [vp])
        self.b6.restype = i

    def weights_and_plan(self, w, g, detect):
        kh, kw, cin, cout = w.shape
        if not self.wgmma:
            return w, []
        return self.plan.pack_weights(w), list(self.plan.conv_plan(
            cin, cout, kh, kw, g.win_h, g.win_w, detect))


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
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    trees = [Tree(c, tmp, str(k)) for k, c in enumerate(args.csrc)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    for kind, name, (h, w_), cin, cout, k, k2, n in CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = conv_tile_geometry((h, w_, cin), (k, k), (1, 1), (1, 1), "SAME",
                               8, 8)
        xp = torch.randn(g.store_shape, device="cuda", generator=gen).to(bf)
        wt = (torch.randn((k, k, cin, cout), device="cuda", generator=gen)
              * (2.0 / (k * k * cin)) ** 0.5).to(bf)
        b = torch.randn(cout, device="cuda", generator=gen)
        out0 = torch.zeros((g.out_h_pad, g.out_w_pad, cout), dtype=bf,
                           device="cuda")
        idx = torch.randperm(g.n_tiles, device="cuda", generator=gen)[:n] \
            .sort().values.to(torch.int32).contiguous()
        count = torch.tensor(n, dtype=torch.int32, device="cuda")
        out = out0.clone()
        if kind == "B6":
            g2 = conv_tile_geometry((g.out_h, g.out_w, cout), (k2, k2),
                                    (1, 1), (1, 1), "SAME", 8, 8)
            nc0 = (torch.randn(g2.store_shape, device="cuda", generator=gen)
                   * 0.5).to(bf)
            nc = nc0.clone()
            mask = torch.zeros((g2.tiles_h, g2.tiles_w), device="cuda")
            npix = torch.zeros((1,), dtype=torch.int32, device="cuda")
        ops = [t.weights_and_plan(wt, g, kind == "B6") for t in trees]
        tau2 = torch.full((), 0.05, dtype=torch.float32, device="cuda")

        def launch(j):
            tree, (wk, plan) = trees[j], ops[j]
            common = (xp.data_ptr(), idx.data_ptr(), count.data_ptr(),
                      wk.data_ptr(), b.data_ptr(), out.data_ptr())
            if kind == "B2":
                err = tree.b2(*common, n, 1, cin, cout, k, k, 1, 1, 1, 1,
                              g.th, g.tw, g.win_h, g.win_w, g.dx0, g.tiles_w,
                              xp.shape[1] * cin, g.out_w_pad * cout, 1, 1,
                              *plan, stream)
            else:
                err = tree.b6(*common, nc.data_ptr(), mask.data_ptr(),
                              npix.data_ptr(), n, 1, cin, cout, k, k, 1, 1,
                              1, 1, g.win_h, g.win_w, g.dx0, g.tiles_w,
                              xp.shape[1] * cin, g.out_w_pad * cout, 1, 1,
                              tau2.data_ptr() if tree.tau_ptr else 0.05,
                              g.out_h, nc.shape[1] * cout,
                              g2.store_lo_h, g2.store_lo_w, g2.tiles_h,
                              g2.tiles_w, g2.th, g2.tw, g2.pad_lo_h,
                              g2.pad_lo_w, g2.win_h, g2.win_w, *plan, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")

        def restore():
            out.copy_(out0)
            if kind == "B6":
                nc.copy_(nc0)
                mask.zero_()
                npix.zero_()

        outs = []
        for j in range(len(trees)):
            restore()
            launch(j)
            torch.cuda.synchronize()
            outs.append((out.clone(), mask.clone(), npix.clone())
                        if kind == "B6" else (out.clone(),))
        diff = [float((o[0].float() - outs[0][0].float()).abs().max())
                for o in outs]
        same_detect = ([bool(torch.equal(o[1], outs[0][1])
                             and torch.equal(o[2], outs[0][2]))
                        for o in outs] if kind == "B6" else None)

        def time_one(j):
            total = 0.0
            for _ in range(args.reps):
                restore()
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                launch(j)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / args.reps

        order = list(range(len(trees)))
        series = {c: [] for c in args.csrc}
        for r in range(args.rounds):
            for j in (order if r % 2 == 0 else order[::-1]):
                series[args.csrc[j]].append(time_one(j))
        print(json.dumps({"kernel": kind, "case": name, "tiles": n,
                          "max_abs_diff_vs_first": diff,
                          "mask_npix_equal_first": same_detect,
                          "ms_per_launch": series}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
