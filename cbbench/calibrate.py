"""The two readings each limit of ``correct`` is set from, on the card at a
cell's own size:

    python3 -m cbbench.calibrate --workload <cell> --seeds 1,2,3 [--out PATH]

For each seed it makes that seed's ring and runs the judged pass of a run
(``run.judged_pass``: the program through ``FrameStepper`` over one pass,
each frame's stored state judged node by node), with the control beside
it: per node the reference's own function at float8 e4m3 storage on the
program's same stored input, and the answers of the reference's last
layer at that storage. In cells with the free-running check the
control's answers are instead the reference's own over the ring at float8
storage, and the program's are the judged pass's (a run holds them equal
to the window's, bit for bit). Each side is then judged by
``run.verdict``, the code that decides a run's ``correct``. It prints one
JSON line per seed, on standard output and in ``--out``: each side's
compared numbers beside their limits, its failed frames and whether it is
correct, and the largest gap per node. The program's ``mismatched`` comes
from runs (``python3 -m cbbench.run``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

from . import frames, run, spec


def readings(cell_name: str, seeds, device: str = "cuda", overrides=None):
    """Yield one reading of the program and the control per seed."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    limits = cell["limits"]
    prep = run.prepare(cell, config, device, overrides)
    h, w = prep.shape[:2]
    for seed in seeds:
        t0 = time.perf_counter()
        ring = frames.make_ring(cell["video"], prep.ring_frames, seed, h, w,
                                device)
        jp = run.judged_pass(prep, config, ring, control=True)
        ctl = types.SimpleNamespace(
            layer_gap=jp.control_layer_gap, answer_gap=jp.control_answer_gap,
            decisions=prep.torch.zeros_like(jp.decisions),
            answers=jp.control_answers, judge=jp.judge)
        ref_out = None
        if "worst_gap" in limits:
            ref_out = run.reference_pass(prep, config, ring)
            ctl.answers = run.answers_of(run.reference_pass(
                prep, config, ring, storage="float8_e4m3fn"),
                config["output"])
        sides = {}
        for side, ns in (("program", jp), ("control", ctl)):
            check, failed, correct = run.verdict(
                ns, [(0, ns.answers)], limits, ref_out)
            sides[side] = {"check": check, "failed": failed,
                           "correct": correct}
        yield {"cell": cell_name, "seed": seed, **sides,
               "by_node": jp.judge.by_node(),
               "seconds": time.perf_counter() - t0}
        del ring, jp, ctl, ref_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, seeds):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        print("cbbench.calibrate: no CUDA card", file=sys.stderr)
        sys.exit(3)
    sys.exit(main())
