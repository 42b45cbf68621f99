#!/usr/bin/env python3
"""The change-rate sweep's agreement gate over many clip seeds.

    python3 scripts/torch_changerate_seeds.py --seeds 94099,84615
    python3 scripts/torch_changerate_seeds.py --root build/parent --seeds 0,1

``chip_smoke.py``'s ``changerate`` phase seeds its clips from the clock
and gates CB's agreement mIoU with dense at ``CR_AGREEMENT`` on each
point. This runs that phase's own point function (``_changerate_point``
of the ``chip_smoke.py`` in ``--root``, default this tree) on the points
named, once per seed, on the scene flagship at 720p, so a seed that
failed the smoke can be replayed and the gate's failure rate over seeds
read off, for this tree and another source tree (e.g. a parent commit
unpacked into ``build/parent``). Prints one line per (seed, point) and a
JSON summary: the agreement per seed and point, and the seeds below the
gate. Needs a CUDA GPU.
"""

import argparse
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
                    help="comma-separated CHANGERATE_POINTS labels")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # the tree's checkpoints and calibration files
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    import chip_smoke as cs
    from cbinfer_tpu_torch.video import (SpriteVideo, SpriteVideoConfig,
                                         workload_video_kwargs)
    wl, cadence = cs.scene_workload()
    points = dict(cs.CHANGERATE_POINTS)
    labels = args.points.split(",")
    out = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for label in labels:
            video = SpriteVideo(SpriteVideoConfig(
                height=cs.H, width=cs.W, noise_std=0.002, seed=seed,
                **workload_video_kwargs("scene"), **points[label]))
            chunks = [torch.from_numpy(video.clip(cs.T)).cuda()
                      for _ in range(cs.CR_CHUNKS)]
            row = cs._changerate_point(torch, np, wl, cadence, label,
                                       points[label], chunks)
            out.setdefault(seed, {})[label] = row["agreement_miou"]
            print(f"seed {seed} {label}: agreement {row['agreement_miou']}",
                  flush=True)
            del chunks
            torch.cuda.empty_cache()
    below = sorted(s for s, r in out.items()
                   if min(r.values()) < cs.CR_AGREEMENT)
    print(json.dumps({"root": root, "gate": cs.CR_AGREEMENT,
                      "agreement": out, "seeds_below_gate": below}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
