"""Scene-labeling CNN: a conv/pool/relu chain ending in a 1x1 classifier,
output at 1/4 spatial resolution (copy of ``cbinfer_tpu.models.scene``)."""

from ..config import ConvSpec, PoolSpec
from . import register


@register("scene")
def scene_cnn(num_classes: int = 8, width: int = 32):
    """~7-layer scene-labeling chain; output stride 4."""
    return [
        ConvSpec(features=width, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=2 * width, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=2 * width, kernel=(3, 3)),
        ConvSpec(features=2 * width, kernel=(3, 3)),
        ConvSpec(features=num_classes, kernel=(1, 1), activation=None),
    ]


@register("scene_tiny")
def scene_tiny(num_classes: int = 5, width: int = 16):
    """3-layer bring-up variant (fast CI / compile checks)."""
    return [
        ConvSpec(features=width, kernel=(3, 3)),
        PoolSpec(window=(2, 2), stride=(2, 2)),
        ConvSpec(features=width, kernel=(3, 3)),
        ConvSpec(features=num_classes, kernel=(1, 1), activation=None),
    ]
