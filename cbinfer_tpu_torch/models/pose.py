"""OpenPose-style pose-estimation CNN: a VGG-like backbone at stride 8 and
two refinement stages that emit part-affinity fields and keypoint heatmaps
jointly (copy of ``cbinfer_tpu.models.pose``): the sequential ``pose`` net
and ``pose_graph``, the faithful OpenPose DAG (``graph.py``)."""

from ..config import ConvSpec, PoolSpec
from . import register


@register("pose_backbone")
def pose_backbone(width: int = 64):
    """VGG-ish feature extractor, stride 8, ~10 conv layers."""
    w = width
    return [
        ConvSpec(features=w, kernel=(3, 3)),
        ConvSpec(features=w, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=2 * w, kernel=(3, 3)),
        ConvSpec(features=2 * w, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=4 * w, kernel=(3, 3)),
        ConvSpec(features=4 * w, kernel=(3, 3)),
        ConvSpec(features=4 * w, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=8 * w, kernel=(3, 3)),
        ConvSpec(features=4 * w, kernel=(3, 3)),  # CPM-style reduction
    ]


def pose_graph(num_keypoints: int = 18, num_pafs: int = 38, width: int = 64,
               stages: int = 2):
    """Faithful OpenPose topology as a DAG (graph.py):

    backbone -> stage1 {PAF branch, heatmap branch}
    stage s>1 consumes concat(backbone, paf_{s-1}, heat_{s-1}).
    Returns (nodes, output_name); the output concatenates both final
    branches."""
    from ..graph import ConcatSpec, GraphNode

    w = width
    nodes = []
    prev = "input"
    for i, spec in enumerate(pose_backbone(width)):
        name = f"bb{i}"
        nodes.append(GraphNode(name=name, spec=spec, inputs=(prev,)))
        prev = name
    feat = prev

    def branch(stage, kind, src, out_ch, ctx):
        p = src
        for j in range(3):
            n = f"s{stage}_{kind}_c{j}"
            nodes.append(GraphNode(
                name=n, spec=ConvSpec(features=ctx, kernel=(3, 3)),
                inputs=(p,)))
            p = n
        n = f"s{stage}_{kind}_1x1"
        nodes.append(GraphNode(name=n,
                               spec=ConvSpec(features=ctx, kernel=(1, 1)),
                               inputs=(p,)))
        out = f"s{stage}_{kind}_out"
        nodes.append(GraphNode(
            name=out, spec=ConvSpec(features=out_ch, kernel=(1, 1),
                                    activation=None), inputs=(n,)))
        return out

    paf, heat = None, None
    src = feat
    for s in range(1, stages + 1):
        ctx = 2 * w if s == 1 else 4 * w
        if s > 1:
            cat = f"s{s}_cat"
            nodes.append(GraphNode(name=cat, spec=ConcatSpec(),
                                   inputs=(feat, paf, heat)))
            src = cat
        paf = branch(s, "paf", src, num_pafs, ctx)
        heat = branch(s, "heat", src, num_keypoints, ctx)
    nodes.append(GraphNode(name="out", spec=ConcatSpec(),
                           inputs=(paf, heat)))
    return nodes, "out"


@register("pose")
def pose_cnn(num_keypoints: int = 18, num_pafs: int = 38, width: int = 64,
             stages: int = 2):
    """Backbone + ``stages`` refinement stages (large-context convs as
    stacked 3x3), emitting PAF + heatmap channels jointly as the final
    conv's features."""
    w = width
    out_ch = num_keypoints + num_pafs
    layers = pose_backbone(width)
    for s in range(stages):
        ctx = 2 * w if s == 0 else 4 * w
        layers += [
            ConvSpec(features=ctx, kernel=(3, 3)),
            ConvSpec(features=ctx, kernel=(3, 3)),
            ConvSpec(features=ctx, kernel=(3, 3)),
            ConvSpec(features=ctx, kernel=(1, 1)),
            ConvSpec(features=out_ch, kernel=(1, 1), activation=None),
        ]
    return layers
