#!/usr/bin/env python3
"""GT-PCK degradation of the pose DAG over seeds, tau vectors and refresh
cadences with the PyTorch port (the twin of ``scripts/graph_acc_sweep.py``).

    python3 scripts/torch_graph_acc_sweep.py [--seeds 4]
        [--taus tuned,flat0.04,flat0.02] [--cadences 2,1] [--t 16]
        [--chunks 4] [--h 720] [--w 1280] [--device cuda|cpu]
        [--width-mult N] [--out PATH]

``scripts/torch_pose_acc_sweep.py``'s protocol on ``zoo.load("pose_graph")``
(the OpenPose DAG) with the reference's DAG settings: T = 16, seeds
2000 + 77 s, 3 sprites of 32 px. Writes GRAPH_ACC.json's keys (plus the
device and the card's name and power limit) to ``--out``, default
``chiprun_out/GRAPH_ACC_torch.json``; the reference's file is never
written.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_pose_acc_sweep import run_sweep  # noqa: E402


def main(argv=None):
    run_sweep("pose_graph", argv, 16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
