"""OpenPose-style pose-estimation CNN: a VGG-like backbone at stride 8 and
two refinement stages that emit part-affinity fields and keypoint heatmaps
jointly (copy of ``cbinfer_tpu.models.pose``): the sequential ``pose`` net
and ``pose_graph``, the repository's OpenPose-style DAG (``graph.py``); and
``openpose_coco``, the published COCO OpenPose at its own widths, which the
JAX package does not have."""

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


# OpenPose COCO (Cao et al., CVPR 2017, arXiv 1611.08050), the layers of
# CMU-Perceptual-Computing-Lab/openpose's pose_deploy_linevec.prototxt
OPENPOSE_PAFS = 38
OPENPOSE_HEATMAPS = 19  # 18 keypoints and the background
OPENPOSE_STAGES = 6
# the VGG-19 front (F at stride 8): (prototxt name, features or None for
# a pool) at width 64
_OPENPOSE_FRONT = (
    ("conv1_1", 64), ("conv1_2", 64), ("pool1_stage1", None),
    ("conv2_1", 128), ("conv2_2", 128), ("pool2_stage1", None),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("pool3_stage1", None), ("conv4_1", 512), ("conv4_2", 512),
    ("conv4_3_CPM", 256), ("conv4_4_CPM", 128))


def openpose_coco(width: int = 64):
    """The COCO OpenPose DAG of ``pose_deploy_linevec.prototxt`` as graph
    nodes: stride-1 SAME convs with biases, ReLU after every conv but the
    branch outputs, 2x2 max pools of stride 2.

    * ``bb_*``: the VGG-19 front to ``conv4_2`` (3x3 convs, three pools)
      and ``conv4_3_CPM`` 256, ``conv4_4_CPM`` 128: F, at stride 8;
    * ``s1_*``: stage 1, two branches of three 3x3x128 convs, a 1x1x512 and
      a 1x1 output (38 PAF channels on L1, 19 heatmaps on L2);
    * ``s{t}_*``, t = 2..6: ``s{t}_cat`` = concat(L1 of stage t-1, L2 of
      stage t-1, F), 185 channels in the prototxt's ``concat_stage{t}``
      order, then per branch five 7x7x128 convs (``Mconv1``-``Mconv5``),
      a 1x1x128 (``Mconv6``) and the 1x1 output (``Mconv7``).

    Node names are the prototxt's layer names behind the part's prefix
    (``bb_conv1_1``, ``s1_conv5_1_CPM_L1``, ``s2_Mconv1_L1``), so each
    node's scope names its part. The output node ``out`` is concat(L1 of
    stage 6, L2 of stage 6): the 19 heatmaps are the last channels (the
    prototxt's ``net_output`` puts L2 first; the order changes no
    arithmetic). ``width`` scales every width but the outputs' by
    ``width / 64`` (64: the published net). Returns (nodes, output)."""
    from ..graph import ConcatSpec, GraphNode

    def sc(c):
        return c * width // 64

    nodes = []

    def conv(name, src, features, k, relu=True):
        nodes.append(GraphNode(name=name, inputs=(src,), spec=ConvSpec(
            features=features, kernel=(k, k),
            activation="relu" if relu else None)))
        return name

    prev = "input"
    for name, c in _OPENPOSE_FRONT:
        if c is None:
            nodes.append(GraphNode(name=f"bb_{name}", inputs=(prev,),
                                   spec=PoolSpec(window=(2, 2),
                                                 stride=(2, 2))))
            prev = f"bb_{name}"
        else:
            prev = conv(f"bb_{name}", prev, sc(c), 3)
    feat = prev
    outs = {}
    for b, out_ch in ((1, OPENPOSE_PAFS), (2, OPENPOSE_HEATMAPS)):
        p = feat
        for j in (1, 2, 3):
            p = conv(f"s1_conv5_{j}_CPM_L{b}", p, sc(128), 3)
        p = conv(f"s1_conv5_4_CPM_L{b}", p, sc(512), 1)
        outs[b] = conv(f"s1_conv5_5_CPM_L{b}", p, out_ch, 1, relu=False)
    for t in range(2, OPENPOSE_STAGES + 1):
        cat = f"s{t}_cat"
        nodes.append(GraphNode(name=cat, spec=ConcatSpec(),
                               inputs=(outs[1], outs[2], feat)))
        for b, out_ch in ((1, OPENPOSE_PAFS), (2, OPENPOSE_HEATMAPS)):
            p = cat
            for j in range(1, 6):
                p = conv(f"s{t}_Mconv{j}_L{b}", p, sc(128), 7)
            p = conv(f"s{t}_Mconv6_L{b}", p, sc(128), 1)
            outs[b] = conv(f"s{t}_Mconv7_L{b}", p, out_ch, 1, relu=False)
    nodes.append(GraphNode(name="out", spec=ConcatSpec(),
                           inputs=(outs[1], outs[2])))
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
