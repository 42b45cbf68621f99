"""OpenPose-style pose-estimation CNN: a VGG-like backbone at stride 8 and
two refinement stages that emit part-affinity fields and keypoint heatmaps
jointly (copy of the sequential part of ``cbinfer_tpu.models.pose``; the
DAG variant ``pose_graph`` waits for the graph converter)."""

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
