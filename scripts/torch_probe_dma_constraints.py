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

``SWEEP`` holds more windows for P1 and P2 beyond the eleven (every rank,
box rows of 1 to 32 16-byte vectors, a single row, the last element of
every dimension, a box near the shared-memory limit, and a window for each
encoder rule the eleven do not break); ``check_sweep_case`` runs one of
them through both kernels, ``sweep_faults`` judges a card's record. The card tests, ``chip_smoke.py``'s
``probe_dma`` phase and ``scripts/torch_tma_ab.py`` use them.
"""

import argparse
import collections
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


# A window of a contiguous bf16 tensor whose data starts ``offset`` elements
# past its allocation's start; ``timed``: one of scripts/torch_tma_ab.py's
# cases; ``accepted``: the encoder takes it.
SweepCase = collections.namedtuple(
    "SweepCase", "name shape window offset timed accepted")
SWEEP = (
    SweepCase("s1 rank 1, one vector (8)@(40) of (4096)", (4096,),
              (ds(40, 8),), 0, True, True),
    SweepCase("s2 rank 1, vpr 32, last element (256)@(3840) of (4096)",
              (4096,), (ds(3840, 256),), 0, False, True),
    SweepCase("s3 rank 2, vpr 3 (37,24)@(3,8) of (40,264)", (40, 264),
              (ds(3, 37), ds(8, 24)), 0, True, True),
    SweepCase("s4 rank 3, vpr 5 (5,7,40)@(1,3,8) of (20,12,48)",
              (20, 12, 48), (ds(1, 5), ds(3, 7), ds(8, 40)), 0, False, True),
    SweepCase("s5 rank 4, vpr 7 (3,4,9,56)@(2,1,0,8) of (6,5,9,64)",
              (6, 5, 9, 64), (ds(2, 3), ds(1, 4), FULL, ds(8, 56)), 0,
              False, True),
    SweepCase("s6 rank 5, vpr 9 (2,3,4,5,72)@(1,1,1,1,8) of (3,4,5,6,80)",
              (3, 4, 5, 6, 80), (ds(1, 2), ds(1, 3), ds(1, 4), ds(1, 5),
                                 ds(8, 72)), 0, True, True),
    SweepCase("s7 single row, vpr 32 (1,256)@(15,0) of (16,256)", (16, 256),
              (ds(15, 1), FULL), 0, True, True),
    SweepCase("s8 last element of each dim (8,9,128)@(56,39,0) of "
              "(64,48,128)", (R, G, L), (ds(56, 8), ds(39, 9), FULL), 0,
              False, True),
    SweepCase("s9 vpr 1, 256 rows (256,8)@(44,8) of (300,16)", (300, 16),
              (ds(44, 256), ds(8, 8)), 0, False, True),
    SweepCase("s10 224 KiB (7,128,128)@(1,2,8) of (9,130,136)",
              (9, 130, 136), (ds(1, 7), ds(2, 128), ds(8, 128)), 0, True,
              True),
    SweepCase("s11 box row of 12 B (4,6)@(0,2) of (8,16)", (8, 16),
              (ds(0, 4), ds(2, 6)), 0, False, False),
    SweepCase("s12 box extent 257 (257,8)@(0,0) of (300,8)", (300, 8),
              (ds(0, 257), FULL), 0, False, False),
    SweepCase("s13 stride of 200 B (4,8)@(0,0) of (8,100)", (8, 100),
              (ds(0, 4), ds(0, 8)), 0, False, False),
    SweepCase("s14 address 8 B past 16 (8,64)@(0,0) of (8,64)", (8, 64),
              (FULL, FULL), 4, False, False),
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


def sweep_buffer(case, device, values=None):
    """A fresh contiguous bf16 tensor of the case's shape starting
    ``case.offset`` elements into its allocation: zeros, or ``values``."""
    n = int(np.prod(case.shape))
    t = torch.zeros(case.offset + n, dtype=torch.bfloat16, device=device)
    t = t[case.offset:].view(case.shape)
    if values is not None:
        t.copy_(values)
    return t


def check_sweep_case(case, device="cuda"):
    """One sweep window through P1 (into zeros) and P2 (out of
    ``read_source``) on ``device``: a record per kernel of the verdict (on
    the card the encoder's, on the CPU the rules' prediction), and for an
    accepted window whether the output equals the plain version's and
    numpy's plain slices bit for bit, for a window the card refuses
    whether the call raised and left its buffer untouched. On the CPU the
    wrappers run the plain version on every window."""
    device = torch.device(device)
    card = device.type == "cuda"
    _, box = K.window_bounds(case.shape, case.window)
    want_w = np.zeros(case.shape, np.float32)
    want_w[case.window] = np.arange(1, box[-1] + 1, dtype=np.float32)
    values = read_source(case.shape).to(device)
    out = dict(case=case.name, shape=list(case.shape),
               window=_spans(case.window, case.shape), offset=case.offset)
    for kernel, run, plain, want, buf in (
            ("write", K.window_write, K.window_write_plain, want_w,
             sweep_buffer(case, device)),
            ("read", K.window_read, K.window_read_plain,
             values.float().cpu().numpy()[case.window],
             sweep_buffer(case, device, values))):
        before = buf.clone()
        rules = K.encode_refusal(case.shape, case.window, 2, buf.data_ptr())
        rec = dict(rules=rules, verdict_by="card" if card else "rules")
        got = None
        if card:
            try:
                got = run(buf, case.window)
            except K.WindowRefused as e:
                rec.update(verdict="refused", cu_result=e.cu_result,
                           raised_rules=e.rules,
                           untouched=bool(torch.equal(buf, before)))
            else:
                rec.update(verdict="accepted", cu_result=0)
        else:  # the plain version, whatever the rules predict
            got = run(buf, case.window)
            rec.update(verdict="refused" if rules else "accepted",
                       cu_result=None)
        if got is not None:
            ref = plain(sweep_buffer(case, device, before), case.window)
            rec.update(exact=bool(torch.equal(got, ref)),
                       values_ok=bool(np.array_equal(
                           got.float().cpu().numpy(), want)))
        out[kernel] = rec
    return out


def sweep_faults(case, record):
    """What is wrong with a card's ``check_sweep_case`` record: a verdict
    other than the expected one or the rules' prediction, an accepted
    output off the plain version or numpy's slices, a refusal without a
    CUresult, with other rules or with its buffer changed."""
    faults = []
    for kernel in ("write", "read"):
        r = record[kernel]
        if r["verdict"] != ("accepted" if case.accepted else "refused") \
                or bool(r["rules"]) == case.accepted:
            faults.append(f"{kernel}: verdict {r['verdict']}, rules "
                          f"{r['rules']}")
        elif case.accepted and not (r["exact"] and r["values_ok"]):
            faults.append(f"{kernel}: output differs: {r}")
        elif not case.accepted and not (
                r["cu_result"] and r["untouched"]
                and r["raised_rules"] == r["rules"]):
            faults.append(f"{kernel}: refusal: {r}")
    return faults


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
