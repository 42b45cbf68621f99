"""The control of ``correct``, read on the card at a cell's own size:

    python3 -m cbbench.calibrate --workload <cell> --seeds 1,2,3 [--out PATH]

For each seed it makes that seed's ring, runs the plain reference over
one pass of it at the configuration's precision and again at the
precision below (float8 e4m3 storage), puts the second's answers (the
argmax of its own outputs) in the program's place, and judges them as a
run judges the program's: one JSON line per seed, with ``worst_gap``
beside the cell's limit, on standard output and in ``--out``. The
program's readings are the ``check`` of ordinary runs
(``python3 -m cbbench.run``).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import frames, run, spec


def control(cell_name: str, seeds, device: str = "cuda", overrides=None):
    """Yield one reading of the control per seed."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    prep = run.prepare(cell, config, device, overrides)
    del prep.wl  # the reference needs only the pinned files
    h, w = prep.shape[:2]
    for seed in seeds:
        ring = frames.make_ring(cell["video"], prep.ring_frames, seed, h, w,
                                device)
        ref_out, _ = run.reference_pass(prep, config, ring)
        ctl, _ = run.reference_pass(prep, config, ring,
                                    storage="float8_e4m3fn")
        answers = ctl.argmax(-1)
        if config["output"]["kind"] == "class_map":
            answers = answers.to(prep.torch.uint8)
        check, failed = run.judge(ref_out, [(0, answers)], cell["limits"])
        yield {"cell": cell_name, "seed": seed, "failed": failed,
               "correct": failed == 0, "check": check}
        del ring, ref_out, ctl, answers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for r in control(args.workload, seeds):
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
