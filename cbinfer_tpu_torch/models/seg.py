"""Semantic-segmentation CNN (copy of ``cbinfer_tpu.models.seg``): a
VGG-style conv/pool encoder at decreasing resolution, a dilated context
block, and a 1x1 classifier head upsampled back to input resolution. Every
conv and pool layer is change-based; the nearest upsample runs dense."""

from ..config import ConvSpec, PoolSpec, UpsampleSpec
from . import register


@register("seg")
def seg_cnn(num_classes: int = 12, width: int = 64):
    """Encoder stride 4 + dilated context + upsampled classifier."""
    w = width
    return [
        # stem
        ConvSpec(features=w, kernel=(3, 3)),
        ConvSpec(features=w, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        # stage 2
        ConvSpec(features=2 * w, kernel=(3, 3)),
        ConvSpec(features=2 * w, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        # context (dilated, keeps resolution)
        ConvSpec(features=4 * w, kernel=(3, 3)),
        ConvSpec(features=4 * w, kernel=(3, 3), dilation=(2, 2)),
        ConvSpec(features=2 * w, kernel=(1, 1)),
        # classifier head at 1/4 res, upsampled
        ConvSpec(features=num_classes, kernel=(1, 1), activation=None),
        UpsampleSpec(scale=(4, 4), method="nearest"),
    ]


@register("seg_small")
def seg_small(num_classes: int = 8, width: int = 32):
    return seg_cnn(num_classes=num_classes, width=width)
