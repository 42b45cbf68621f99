#!/usr/bin/env python3
"""Which copy windows does the card's copy engine take? The PyTorch + CUDA
twin of scripts/probe_dma_constraints.py.

    python3 scripts/torch_probe_dma_constraints.py               # the card
    python3 scripts/torch_probe_dma_constraints.py --device cpu  # plain

The same eleven cases under the same names: six writes of a bf16 ramp
(lane + 1) into a window of a zero (64, 48, 128) buffer (w1-w6), and five
reads of a window of a random bf16 array into a dense one (r0-r4). On the
card each case is one TMA copy (``cbinfer_tpu_torch.ops.kernels.
tma_window``): its tensor map has the window as its box, so the card's
encoder rules on the window. A case prints the card's verdict, ACCEPTED or
REFUSED with the encoder's CUresult and the rules the window breaks; an
accepted case's values are then checked against numpy built from plain
slices. (The reference checks its reads by indexing numpy with ``pl.ds``
objects, which raises, so its read cases print REJECTED whatever the chip
does.) On the CPU the wrappers run their plain versions: a case prints
what the encoder's rules predict, then checks the plain version's values.
The exit code is 1 when an accepted case's values are wrong.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cbinfer_tpu_torch.ops.kernels import tma_window as K  # noqa: E402

R, G, L = 64, 48, 128


def ds(start, size):
    """The reference's ``pl.ds(start, size)`` as a plain slice."""
    return slice(start, start + size)


FULL = slice(None)
# name -> the window of the (R, G, L) buffer the ramp is written into
WRITE_CASES = (
    ("w1 full-lane aligned (8,16,128)@(8,16,0)",
     (ds(8, 8), ds(16, 16), FULL)),
    ("w2 narrow lanes (8,16,36)@(5,16,36)",
     (ds(5, 8), ds(16, 16), ds(36, 36))),
    ("w3 narrow lanes (8,16,36)@(3,8,72)",
     (ds(3, 8), ds(8, 16), ds(72, 36))),
    ("w4 group extent 9 (8,9,128)@(8,7,0)",
     (ds(8, 8), ds(7, 9), FULL)),
    ("w5 (8,9,36)@(1,7,36)",
     (ds(1, 8), ds(7, 9), ds(36, 36))),
    ("w6 (8,16,64)@(8,16,64)",
     (ds(8, 8), ds(16, 16), ds(64, 64))),
)
# name -> (the source's shape, the window read out of it)
READ_CASES = (
    ("r0 flat read (8,384)@(16,128) of (720,5504)", (720, 5504),
     (ds(16, 8), ds(128, 384))),
    ("r1 flat read (8,384)@(17,128) of (720,5504)", (720, 5504),
     (ds(17, 8), ds(128, 384))),
    ("r2 flat read (8,384)@(17,96) of (720,5504)", (720, 5504),
     (ds(17, 8), ds(96, 384))),
    ("r3 3D read (8,9,128)@(9,15,0) of (64,48,128)", (R, G, L),
     (ds(9, 8), ds(15, 9), FULL)),
    ("r4 flat read (10,256)@(3,256) of (722,5444)", (722, 5444),
     (ds(3, 10), ds(256, 256))),
)


def read_source(shape, seed=0):
    """The read cases' source, as the reference makes it: uniform numbers
    from numpy's generator (seeded per case), rounded to bf16."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random(shape)).to(torch.bfloat16)


def want_write(window):
    """The write cases' expected buffer, from plain numpy slices."""
    want = np.zeros((R, G, L), np.float32)
    _, box = K.window_bounds(want.shape, window)
    want[window] = np.arange(1, box[-1] + 1, dtype=np.float32)
    return want


def _verdict(fn, shape, window, card):
    """(result or None, record of the verdict): on the card the copy's
    own; on the CPU the encoder rules' prediction (the plain version runs
    either way)."""
    rules = K.encode_refusal(shape, window)
    if not card:
        return fn(), dict(verdict="refused" if rules else "accepted",
                          verdict_by="rules", rules=rules, cu_result=None)
    try:
        return fn(), dict(verdict="accepted", verdict_by="card",
                          rules=rules, cu_result=0)
    except K.WindowRefused as e:
        return None, dict(verdict="refused", verdict_by="card",
                          rules=e.rules, cu_result=e.cu_result)


def run_cases(device="cuda", log=print):
    """Every case on ``device``; one record a case."""
    device = torch.device(device)
    card = device.type == "cuda"
    records = []
    for name, window in WRITE_CASES:
        dst = torch.zeros((R, G, L), dtype=torch.bfloat16, device=device)
        _, box = K.window_bounds(dst.shape, window)
        out, rec = _verdict(lambda: K.window_write(dst, window, box),
                            dst.shape, window, card)
        if out is not None:
            rec["values_ok"] = bool(np.array_equal(
                out.float().cpu().numpy(), want_write(window)))
        records.append(dict(case=name, kernel=K.KERNEL_WRITE.name,
                            shape=[R, G, L], window=_spans(window, dst.shape),
                            **rec))
    for name, shape, window in READ_CASES:
        src = read_source(shape).to(device)
        out, rec = _verdict(lambda: K.window_read(src, window), shape,
                            window, card)
        if out is not None:
            want = src.float().cpu().numpy()[window]
            rec["values_ok"] = bool(np.array_equal(
                out.float().cpu().numpy(), want))
        records.append(dict(case=name, kernel=K.KERNEL_READ.name,
                            shape=list(shape), window=_spans(window, shape),
                            **rec))
    for r in records:
        log(_line(r))
    return records


def _spans(window, shape):
    start, box = K.window_bounds(shape, window)
    return [[a, b] for a, b in zip(start, box)]


def _line(r):
    if r["verdict"] == "refused":
        why = "; ".join(r["rules"]) or "no rule written out"
        head = (f"REFUSED (CUresult {r['cu_result']}: {why})"
                if r["verdict_by"] == "card"
                else f"REFUSED by the encode rules ({why})")
    else:
        head = ("ACCEPTED" if r["verdict_by"] == "card"
                else "within the encode rules")
    if "values_ok" in r:
        head += f", values {'OK' if r['values_ok'] else 'WRONG'}"
    return f"{r['case']}: {head}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's verdicts) or cpu (the plain "
                         "versions and the encoder rules' prediction)")
    ap.add_argument("--out", default=None,
                    help="write the records here as JSON")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions")
    records = run_cases(args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 1 if any(r.get("values_ok") is False for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())
