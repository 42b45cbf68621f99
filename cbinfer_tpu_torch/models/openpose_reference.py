"""A plain float32 reference of COCO OpenPose (Cao et al., CVPR 2017,
arXiv 1611.08050), written from the layers of
CMU-Perceptual-Computing-Lab/openpose's ``pose_deploy_linevec.prototxt``
with ``torch.nn.functional`` alone (conv2d, relu, max_pool2d, cat), to hold
the program's OpenPose (``models.pose.openpose_coco`` through the CB path)
against. It imports nothing else of this package, no kernel and no JAX,
and turns TF32 off: every product is a float32 product.

The layers, as the prototxt gives them: every conv has stride 1, the
padding that keeps the map's size and a bias; a ReLU follows every conv
but the branch outputs (``conv5_5_CPM_L*``, ``Mconv7_stage*_L*``); the
pools are 2x2 max pools of stride 2. The VGG-19 front runs to
``conv4_2``, then ``conv4_3_CPM`` 256 and ``conv4_4_CPM`` 128 make F at
stride 8. Stage 1 has two branches (L1: 38 PAF channels, L2: 19
heatmaps) of three 3x3x128 convs, a 1x1x512 and the 1x1 output; stage t =
2..6 reads ``concat_stage{t}`` = (L1, L2 of stage t-1, F), 185 channels,
and each branch is five 7x7x128 convs, a 1x1x128 and the 1x1 output.
Weights are read from a dict of HWIO arrays under ``w:{node}`` and
``b:{node}``, node names as the program's (the prototxt's name behind the
part: ``bb_conv1_1``, ``s1_conv5_1_CPM_L1``, ``s2_Mconv1_L1``).

Departures from the prototxt, none of which changes the arithmetic of a
layer:

- the output joins (L1, L2) of stage 6, the heatmaps last; the
  prototxt's ``net_output`` joins (L2, L1);
- the input is the (H, W, 3) float32 frame as it comes, RGB in [0, 1];
  OpenPose feeds BGR scaled to x / 256 - 0.5;
- the pools floor an odd size where Caffe's ceil; every map this port
  runs is even at each pool, where the two agree;
- the weights are whatever the dict holds (the benchmark's are seeded
  random, not the trained COCO model's).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAFS, HEATMAPS, STAGES = 38, 19, 6

# (name, kind, kernel, features, relu, inputs): the prototxt in order
Layer = Tuple[str, str, int, Optional[int], bool, Tuple[str, ...]]


def layers(width: int = 64) -> List[Layer]:
    """The net's layers; ``width`` scales every width but the outputs' by
    ``width / 64`` (64: the published net)."""
    def sc(c):
        return c * width // 64
    out: List[Layer] = []
    prev = "input"

    def add(name, kind, k, c, relu, *ins):
        out.append((name, kind, k, c, relu, tuple(ins)))
        return name

    for name, c in (("conv1_1", 64), ("conv1_2", 64), ("pool1_stage1", 0),
                    ("conv2_1", 128), ("conv2_2", 128), ("pool2_stage1", 0),
                    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
                    ("conv3_4", 256), ("pool3_stage1", 0), ("conv4_1", 512),
                    ("conv4_2", 512), ("conv4_3_CPM", 256),
                    ("conv4_4_CPM", 128)):
        prev = (add("bb_" + name, "pool", 2, None, False, prev) if not c
                else add("bb_" + name, "conv", 3, sc(c), True, prev))
    feat = prev
    last = {}
    for b, oc in ((1, PAFS), (2, HEATMAPS)):
        p = feat
        for j in (1, 2, 3):
            p = add(f"s1_conv5_{j}_CPM_L{b}", "conv", 3, sc(128), True, p)
        p = add(f"s1_conv5_4_CPM_L{b}", "conv", 1, sc(512), True, p)
        last[b] = add(f"s1_conv5_5_CPM_L{b}", "conv", 1, oc, False, p)
    for t in range(2, STAGES + 1):
        cat = add(f"s{t}_cat", "concat", 0, None, False, last[1], last[2],
                  feat)
        for b, oc in ((1, PAFS), (2, HEATMAPS)):
            p = cat
            for j in range(1, 6):
                p = add(f"s{t}_Mconv{j}_L{b}", "conv", 7, sc(128), True, p)
            p = add(f"s{t}_Mconv6_L{b}", "conv", 1, sc(128), True, p)
            last[b] = add(f"s{t}_Mconv7_L{b}", "conv", 1, oc, False, p)
    add("out", "concat", 0, None, False, last[1], last[2])
    return out


class OpenPoseReference:
    """The net in float32 over (C, H, W) maps, from a weight dict."""

    def __init__(self, weights, device="cpu", width: int = 64):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.layers = layers(width)
        self.by_name = {lay[0]: lay for lay in self.layers}
        dev = torch.device(device)
        self.params = {}
        for name, kind, *_ in self.layers:
            if kind == "conv":
                w = np.asarray(weights[f"w:{name}"], np.float32)
                b = np.asarray(weights[f"b:{name}"], np.float32)
                self.params[name] = (
                    torch.from_numpy(w).to(dev).permute(3, 2, 0, 1)
                    .contiguous(), torch.from_numpy(b).to(dev))

    def node(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One conv or pool layer's function of its (C, H, W) input."""
        _, kind, k, _, relu, _ = self.by_name[name]
        if kind == "pool":
            return F.max_pool2d(x[None], k, k)[0]
        w, b = self.params[name]
        y = F.conv2d(x[None].float(), w, b, padding=k // 2)[0]
        return F.relu(y) if relu else y

    def forward(self, frame: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every layer's (C, H, W) output for one (H, W, 3) frame; ``out``
        is (L1, L2) of stage 6."""
        outs = {"input": frame.permute(2, 0, 1).float()}
        with torch.no_grad():
            for name, kind, _, _, _, ins in self.layers:
                if kind == "concat":
                    outs[name] = torch.cat([outs[i] for i in ins], 0)
                else:
                    outs[name] = self.node(name, outs[ins[0]])
        return outs

    def __call__(self, frame: torch.Tensor) -> torch.Tensor:
        return self.forward(frame)["out"]
