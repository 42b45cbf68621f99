#!/usr/bin/env python3
"""Train a shipped workload's weights with the PyTorch port.

    python3 scripts/torch_train.py {scene,scene_hard,seg,pose,pose_graph}
                                   --out DIR [--steps N]
                                   [--device cuda|cpu]

The recipes are the JAX package's train scripts': ``scripts/train_scene.py``
(``scene``: w128, 8 classes, 600 steps; ``scene_hard``: the hard palette,
1200 steps), ``scripts/train_seg.py`` (w64, 1200 steps on the seg video
profile), ``scripts/train_pose.py`` and ``scripts/train_pose_graph.py``
(w64, 3000 steps on the pose profile, 24 videos), all at 192x256, batch 4,
seed 0. ``--steps`` overrides the step count.

Writes ``DIR/<workload>_w<width>.npz`` (``scene_w128.npz``,
``scene_w128_hard.npz``, ``seg_w64.npz``, ``pose_w64.npz``,
``pose_graph_w64.npz``) in the JAX package's key layout (``w{i}``/``b{i}``,
``w:{node}``/``b:{node}`` for the DAG), which ``checkpoint.load_npz_params``
and ``zoo.load`` read. The shipped ``ckpts/`` weights are the reference's
and the tests read them: this script writes only where ``--out`` says.
The train scripts' 720p evaluation is not repeated here
(``chip_smoke.py``'s ``train`` phase serves freshly trained weights).
Prints the loss every 50 or 100 steps and one JSON line at the end:
seconds (all, and of making the data), ms per step (the rest over the
steps) and, on the card, the steady ms per step after 20 steps (CUDA
events), the first and last 20-step mean loss, the final accuracy or PCK,
and the card's name and power limit on the card. ``train_workload`` is
what ``chip_smoke.py``'s ``train`` phase calls.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cbinfer_tpu_torch import checkpoint, train  # noqa: E402
from cbinfer_tpu_torch.models import get_model  # noqa: E402
from cbinfer_tpu_torch.models.pose import pose_graph  # noqa: E402
from cbinfer_tpu_torch.video import workload_video_kwargs  # noqa: E402

IN_SHAPE = (192, 256, 3)    # train at low res; conv nets are size-agnostic
# workload -> (width, steps, npz name)
RECIPES = {
    "scene": (128, 600, "scene_w128.npz"),
    "scene_hard": (128, 1200, "scene_w128_hard.npz"),
    "seg": (64, 1200, "seg_w64.npz"),
    "pose": (64, 3000, "pose_w64.npz"),
    "pose_graph": (64, 3000, "pose_graph_w64.npz"),
}


WARM_STEPS = 20   # steps before the steady time per step is read


class _StepLog(list):
    """The trainer's ``losses`` list; on the card it also records a CUDA
    event at each step's end, so the steady time per step is read off the
    device's clock without a host sync inside the loop."""

    def __init__(self, cuda: bool):
        super().__init__()
        self.events = [] if cuda else None

    def append(self, loss):
        super().append(loss)
        if self.events is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def steady_ms(self):
        """Device ms per step from the end of step WARM_STEPS to the last
        (None on the CPU or for too few steps)."""
        ev = self.events
        if not ev or len(ev) <= WARM_STEPS + 1:
            return None
        ev[-1].synchronize()
        return ev[WARM_STEPS].elapsed_time(ev[-1]) / (len(ev) - 1
                                                      - WARM_STEPS)


def _video_kwargs(name):
    return ({"palette": "hard"} if name == "scene_hard"
            else {} if name == "scene" else workload_video_kwargs(name))


def _run(name, steps, device, losses):
    """(params, metric name, metric value) of the workload's recipe."""
    width = RECIPES[name][0]
    common = dict(steps=steps, batch=4, verbose=True, device=device,
                  losses=losses, video_kwargs=_video_kwargs(name))
    if name in ("scene", "scene_hard", "seg"):
        model = "seg" if name == "seg" else "scene"
        params, acc = train.train_segmentation(
            get_model(model, num_classes=8, width=width), IN_SHAPE, 8,
            n_videos=16, **common)
        return params, "train_acc", acc
    if name == "pose":
        params, pck = train.train_pose(
            get_model("pose", width=width), IN_SHAPE, n_videos=24,
            **common)
        return params, "train_pck", pck
    nodes, out = pose_graph(width=width)
    params, pck = train.train_pose_graph(nodes, out, IN_SHAPE, n_videos=24,
                                         **common)
    return params, "train_pck", pck


def _data_seconds(name):
    """Seconds to make the recipe's training data alone (the trainer makes
    it again, from the same seed)."""
    H, W, _ = IN_SHAPE
    t0 = time.perf_counter()
    if name in ("scene", "scene_hard", "seg"):
        train._seg_dataset(np.random.default_rng(0), H, W, 0, 16,
                           video_kwargs=_video_kwargs(name))
    else:
        train._pose_dataset(H, W, H // 8, W // 8, 8, 0, 24, 8,
                            _video_kwargs(name))
    return time.perf_counter() - t0


def train_workload(name, steps=None, device="cuda"):
    """Train ``name`` by its recipe (``steps`` overrides the step count).
    Returns a dict: ``params``, the metric (``train_acc`` or
    ``train_pck``), ``losses`` (floats, one a step), ``seconds`` (data,
    steps and the final evaluation), ``data_seconds``, ``ms_per_step``
    (the rest, over the steps: first-call costs included) and, on the
    card, ``steady_ms_per_step`` (CUDA events, after WARM_STEPS steps)."""
    steps = RECIPES[name][1] if steps is None else steps
    data_s = _data_seconds(name)
    log = _StepLog(device == "cuda")
    t0 = time.perf_counter()
    params, metric, value = _run(name, steps, device, log)
    seconds = time.perf_counter() - t0
    return {"params": params, "metric": metric, metric: value,
            "steps": steps, "losses": torch.stack(log).cpu().tolist(),
            "seconds": seconds, "data_seconds": data_s,
            "ms_per_step": (seconds - data_s) / max(1, steps) * 1e3,
            "steady_ms_per_step": log.steady_ms()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", choices=sorted(RECIPES))
    ap.add_argument("--out", required=True,
                    help="directory of the npz (made if missing)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    width, _, npz = RECIPES[args.workload]
    r = train_workload(args.workload, args.steps, args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, npz)
    if isinstance(r["params"], dict):
        checkpoint.save_npz_graph_params(path, r["params"])
    else:
        checkpoint.save_npz_params(path, r["params"])
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
    loss = r["losses"]
    print(json.dumps({
        "workload": args.workload, "width": width, "steps": r["steps"],
        "in_shape": list(IN_SHAPE), "device": args.device, "card": card,
        "seconds": r["seconds"], "data_seconds": r["data_seconds"],
        "ms_per_step": r["ms_per_step"],
        "steady_ms_per_step": r["steady_ms_per_step"],
        "loss_first20": sum(loss[:20]) / len(loss[:20]),
        "loss_last20": sum(loss[-20:]) / len(loss[-20:]),
        r["metric"]: r[r["metric"]], "npz": path}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
