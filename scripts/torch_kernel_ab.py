#!/usr/bin/env python3
"""Same-call A/B of the delta conv kernel built from two or more source
trees, on one card, in turns.

    python3 scripts/torch_kernel_ab.py --csrc build/parent/cbinfer_tpu_torch/csrc \
                                       --csrc cbinfer_tpu_torch/csrc

Each ``--csrc`` directory holds a ``delta_conv.cu`` (and the headers it
includes) with the C interface ``cb_delta_conv`` of the port. Every tree's
kernel is built with nvcc (sm_90a), checked against the first tree's output
bit for bit, and timed on the same seeded bf16 inputs at the shapes of the
720p paths: per-launch device ms by CUDA events, L2 flushed and the out
cache restored before each launch, the trees taking turns (A B .. B A) for
``--rounds`` rounds. Prints the card's name and power limit, then one JSON
line per case. Needs a CUDA GPU and nvcc; imports the port only for its
geometry and its wrapper's argument order.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry  # noqa: E402
from cbinfer_tpu_torch.ops.kernels.build import ARCH, nvcc_path  # noqa: E402

# (name, map, cin, cout, kernel, listed tiles)
CASES = [
    ("scene 180x320 3x3 256->256", (180, 320), 256, 256, 3, 60),
    ("pose 360x640 3x3 128->128", (360, 640), 128, 128, 3, 600),
    ("pose 90x160 3x3 512->256", (90, 160), 512, 256, 3, 28),
    ("pose 90x160 1x1 256->256", (90, 160), 256, 256, 1, 28),
]


def build(csrc, out_dir, tag):
    so = os.path.join(out_dir, f"libdelta_conv_{tag}.so")
    subprocess.run([nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(csrc, "delta_conv.cu")], check=True)
    fn = ctypes.CDLL(so).cb_delta_conv
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp] * 6 + [i] * 16 + [ll, ll, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="kernel_ab_")
    fns = [build(c, tmp, str(k)) for k, c in enumerate(args.csrc)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for name, (h, w_), cin, cout, k, n in CASES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = conv_tile_geometry((h, w_, cin), (k, k), (1, 1), (1, 1), "SAME",
                               8, 8)
        xp = torch.randn(g.store_shape, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        wt = (torch.randn((k, k, cin, cout), device="cuda", generator=gen)
              * 0.05).to(torch.bfloat16)
        b = torch.randn(cout, device="cuda", generator=gen)
        out0 = torch.zeros((g.out_h_pad, g.out_w_pad, cout),
                           dtype=torch.bfloat16, device="cuda")
        idx = torch.randperm(g.n_tiles, device="cuda", generator=gen)[:n] \
            .sort().values.to(torch.int32).contiguous()
        count = torch.tensor(n, dtype=torch.int32, device="cuda")
        out = out0.clone()

        def launch(fn):
            err = fn(xp.data_ptr(), idx.data_ptr(), count.data_ptr(),
                     wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, 1, cin,
                     cout, k, k, 1, 1, 1, 1, g.th, g.tw, g.win_h, g.win_w,
                     g.dx0, g.tiles_w, xp.shape[1] * cin, g.out_w_pad * cout,
                     1, 1, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")

        outs = []
        for fn in fns:
            out.copy_(out0)
            launch(fn)
            torch.cuda.synchronize()
            outs.append(out.clone())
        same = [bool(torch.equal(o, outs[0])) for o in outs]

        def time_one(fn):
            total = 0.0
            for _ in range(args.reps):
                out.copy_(out0)
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                launch(fn)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / args.reps

        order = list(range(len(fns)))
        series = {c: [] for c in args.csrc}
        for r in range(args.rounds):
            for j in (order if r % 2 == 0 else order[::-1]):
                series[args.csrc[j]].append(time_one(fns[j]))
        print(json.dumps({"case": name, "tiles": n,
                          "bit_identical_to_first": same,
                          "ms_per_launch": series}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
