#!/usr/bin/env python3
"""The change-rate sweep's accuracy over many clip seeds.

    python3 scripts/torch_changerate_seeds.py --seeds 94099,84615
        [--points sprites16,sprites24] [--out PATH]
    python3 scripts/torch_changerate_seeds.py --root build/other --seeds 0

``chip_smoke.py``'s ``changerate`` phase seeds its clips from the clock.
This runs the sweep of ``scripts/torch_bench_changerate.py`` (of the tree
in ``--root``, default this one) on the points named, once per seed, on
the scene flagship at 720p, so a seed the smoke drew can be replayed and
the spread over seeds read off. Prints one line per (seed, point): the
agreement mIoU (CB against dense) per chunk, pixel agreement, GT-mIoU of
CB and dense and their difference against the 0.5% budget, and each
class whose IoU between the two maps is below 0.9 in a chunk, with its
pixel count in each map. Writes every row in full (per chunk and class)
to ``--out``, default ``chiprun_out/changerate_seeds.json``. Needs a
CUDA GPU.
"""

import argparse
import importlib.util
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the source tree to run")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated clip seeds")
    ap.add_argument("--points", default="sprites16,sprites24",
                    help="comma-separated point labels, or 'all'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)  # the tree's checkpoints and calibration files
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    spec = importlib.util.spec_from_file_location(
        "torch_bench_changerate",
        os.path.join(root, "scripts", "torch_bench_changerate.py"))
    cr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cr)
    points = None if args.points == "all" else args.points.split(",")
    out = {"root": root, "gt_budget": cr.GT_BUDGET, "card": cr.card(),
           "seeds": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = cr.sweep(seed, points=points, log=lambda m: None)
        out["seeds"][seed] = rec["rows"]
        for r in rec["rows"]:
            low = [(i + 1, c["cls"], c["iou"], c["cb_pixels"],
                    c["dense_pixels"])
                   for i, ch in enumerate(r["class_iou"]) for c in ch
                   if c["iou"] is not None and c["iou"] < 0.9]
            print(json.dumps({
                "seed": seed, "point": r["point"],
                "agreement_chunks": r["agreement_miou_chunks"],
                "agreement": r["agreement_miou"],
                "pixel_agreement": r["pixel_agreement"],
                "miou_gt_cb": r["miou_gt_cb"],
                "miou_gt_dense": r["miou_gt_dense"],
                "miou_degradation": r["miou_degradation"],
                "within_budget": r["within_budget"],
                "classes_below_0.9 (chunk, cls, iou, cb_px, dense_px)": low}),
                flush=True)
        torch.cuda.empty_cache()
    out["seeds_over_budget"] = sorted(
        s for s, rows in out["seeds"].items()
        if not all(r["within_budget"] for r in rows))
    path = args.out or os.path.join(root, "chiprun_out",
                                    "changerate_seeds.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"seeds_over_budget": out["seeds_over_budget"],
                      "wrote": path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
