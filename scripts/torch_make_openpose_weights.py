#!/usr/bin/env python3
"""Write the seeded weights of the COCO OpenPose DAG
(``models.pose.openpose_coco``) as an npz that ``zoo.load("openpose")``
and the benchmark read.

    python3 scripts/torch_make_openpose_weights.py [--seed 1611]
        [--width 64] [--out ckpts/openpose_coco.npz]

Per conv node in topological order, from ``numpy.random.default_rng(seed)``:
the HWIO weights He-normal (standard normal times sqrt(2 / fan_in), fan_in
= kh * kw * cin), then the bias, normal with standard deviation 0.01; both
stored as float16 under ``w:{node}`` and ``b:{node}``. These are random
weights, not trained ones: they give the published net's arithmetic and
shapes, not its answers. The same seed and width give the same file, byte
for byte (``numpy.savez`` writes fixed zip times).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

SEED = 1611
BIAS_STD = 0.01


def make_weights(seed: int = SEED, width: int = 64):
    """{``w:{node}``: HWIO float16, ``b:{node}``: float16} of every conv
    node of ``openpose_coco(width)``."""
    from cbinfer_tpu_torch.config import ConvSpec
    from cbinfer_tpu_torch.graph import node_out_shapes
    from cbinfer_tpu_torch.models.pose import openpose_coco
    nodes, _ = openpose_coco(width)
    # channels do not depend on the map size
    shapes = node_out_shapes(nodes, (64, 64, 3))
    rng = np.random.default_rng(seed)
    out = {}
    for n in nodes:
        if not isinstance(n.spec, ConvSpec):
            continue
        kh, kw = n.spec.kernel
        cin, cout = shapes[n.inputs[0]][2], n.spec.features
        std = math.sqrt(2.0 / (kh * kw * cin))
        out[f"w:{n.name}"] = (rng.standard_normal((kh, kw, cin, cout))
                              * std).astype(np.float16)
        out[f"b:{n.name}"] = (rng.standard_normal(cout)
                              * BIAS_STD).astype(np.float16)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(REPO, "ckpts",
                                                  "openpose_coco.npz"))
    args = ap.parse_args(argv)
    w = make_weights(args.seed, args.width)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **w)
    n = sum(v.size for v in w.values())
    print(f"{args.out}: {len(w) // 2} convs, {n} parameters, seed "
          f"{args.seed}, width {args.width}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
