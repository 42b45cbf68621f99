"""Workload zoo: one-call loading of the shipped model families (port of
``cbinfer_tpu.zoo``: the sequential ``scene``, ``seg`` and ``pose``
workloads and the DAG ``pose_graph``; and ``openpose``, the published COCO
OpenPose DAG, which the JAX package does not have).

A registry maps each workload name to its architecture, trained checkpoint,
tuned threshold vector and measured per-layer backend policy, so user code
builds a ready-to-stream network in one call:

    wl = zoo.load("scene", (720, 1280, 3))
    ys, st, stats = scan_video(wl.net, wl.params, clip, thresholds=wl.taus)

Missing artifacts degrade loudly but gracefully (random weights, default
taus, no policy), with the provenance recorded on the returned Workload.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .config import PipelineConfig, TileConfig, UpsampleSpec

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CK = os.path.join(_REPO, "ckpts")


def default_pipeline_config(device: str = "cuda") -> PipelineConfig:
    """The deployment PipelineConfig: the flagship operating configuration
    every shipped tau vector and backend policy was calibrated against
    (hand-written kernels on the card, bf16 compute and caches, 8x8 tiles,
    capacity 0.375). ``zoo.load`` uses it when no cfg is given.
    ``device="cpu"`` gives the same in float32 on the plain versions (the
    calibration scripts' CPU runs, as the JAX package's run off the
    TPU)."""
    dt = "bfloat16" if device == "cuda" else "float32"
    return PipelineConfig(
        tile=TileConfig(tile_h=8, tile_w=8, capacity_fraction=0.375),
        backend="cuda", compute_dtype=dt, cache_dtype=dt, device=device)


@dataclasses.dataclass(frozen=True)
class _Entry:
    kind: str                 # "sequential" | "graph"
    width: int
    metric: str               # "miou" | "pck"
    npz: str
    tau_json: str
    policy_json: str
    model_kwargs: Dict[str, Any]
    # a "graph" entry's builder in ``models.pose``: (nodes, output name)
    graph_builder: str = "pose_graph"


REGISTRY: Dict[str, _Entry] = {
    "scene": _Entry("sequential", 128, "miou",
                    f"{_CK}/scene_w128.npz", f"{_CK}/scene_w128_tau.json",
                    f"{_REPO}/POLICY_scene.json",
                    {"num_classes": 8}),
    "scene_hard": _Entry("sequential", 128, "miou",
                         f"{_CK}/scene_w128_hard.npz",
                         f"{_CK}/scene_w128_hard_tau.json",
                         f"{_REPO}/POLICY_scene_hard.json",
                         {"num_classes": 8}),
    "seg": _Entry("sequential", 64, "miou",
                  f"{_CK}/seg_w64.npz", f"{_CK}/seg_w64_tau.json",
                  f"{_REPO}/POLICY_seg.json",
                  {"num_classes": 8}),
    "pose": _Entry("sequential", 64, "pck",
                   f"{_CK}/pose_w64.npz", f"{_CK}/pose_w64_tau.json",
                   f"{_REPO}/POLICY_pose.json", {}),
    "pose_graph": _Entry("graph", 64, "pck",
                         f"{_CK}/pose_graph_w64.npz",
                         f"{_CK}/pose_graph_w64_tau.json",
                         f"{_REPO}/POLICY_pose_graph.json", {}),
    # seeded He-normal weights (scripts/torch_make_openpose_weights.py),
    # not trained ones: OpenPose at its published widths for the
    # benchmark, its taus tuned against its own dense path
    "openpose": _Entry("graph", 64, "pck",
                       f"{_CK}/openpose_coco.npz",
                       f"{_CK}/openpose_coco_tau.json",
                       f"{_REPO}/POLICY_openpose.json", {},
                       graph_builder="openpose_coco"),
}


@dataclasses.dataclass
class Workload:
    name: str
    kind: str                      # "sequential" | "graph"
    net: Any                       # CBNet | CBGraphNet (flagship policy)
    specs: Any                     # layer specs (sequential) | nodes (graph)
    params: Any
    taus: List[float]
    refresh_every: Optional[int]
    metric: str                    # "miou" | "pck"
    # provenance: a random-weights or default-tau run must be visible
    weights: str
    tau_source: str
    policy_source: str
    warnings: List[str]
    # scale of a stripped trailing upsample (see ``load``), else None
    upsample_scale: Optional[Tuple[int, int]] = None
    # whether the fused consumer-detect kernel was applied (a throughput-
    # only policy decision, bit-identical either way); its own provenance
    # field so that a policy fallback cannot misreport it
    fuse_detect: bool = False


def names() -> List[str]:
    return list(REGISTRY)


def output_stride(wl: "Workload", h: int, w: int) -> int:
    """Input rows per output row of a loaded workload's network at (h, w)
    (the stride its labels are taken at)."""
    from .network import out_shapes
    if wl.kind == "graph":
        from .graph import node_out_shapes
        return h // node_out_shapes(wl.net.nodes, (h, w, 3))[wl.net.output][0]
    return h // out_shapes(wl.net.specs, (h, w, 3))[-1][0]


def load_refresh_cadence(name: str, t: int, h: int, w: int,
                         default: int = 2) -> Tuple[int, str]:
    """Validated refresh cadence for a workload, parity-guarded.

    ``REFRESH_{name}.json`` records the largest refresh cadence — prolog
    every R-th T-frame chunk — whose worst-chunk ground-truth degradation
    stayed within the budget over a long horizon. Drift per chunk scales
    with frames per chunk and sprite scale, so the json applies only when
    the caller's chunk size and resolution match what was measured;
    otherwise the conservative default (every 2nd chunk) is returned with
    the mismatch recorded in the source string. Returns
    ``(cadence_in_chunks, source)``."""
    path = f"{_REPO}/REFRESH_{name}.json"
    if not os.path.exists(path):
        return default, "default"
    try:
        with open(path) as f:
            rj = json.load(f)
        cad = rj.get("refresh_every_chunks")
        if not cad:
            return default, f"default ({path}: no cadence validated)"
        if rj.get("T") != t or rj.get("shape") != [h, w]:
            return default, (
                f"default ({path} measured at T={rj.get('T')} "
                f"shape={rj.get('shape')}; caller runs T={t} {h}x{w})")
        return int(cad), path
    except Exception as exc:  # stale/corrupt json must not kill a bench
        return default, f"default (unreadable {path}: {exc})"


def load(name: str, in_shape: Tuple[int, int, int] = (720, 1280, 3),
         cfg: Optional[PipelineConfig] = None,
         tau: Optional[float] = None,
         apply_policy: bool = True,
         strip_trailing_upsample: bool = True,
         seed: int = 0, width: Optional[int] = None) -> Workload:
    """Build the flagship-converted network for a registered workload with
    its trained weights (on ``cfg.device``, in the compute dtype), tuned
    thresholds and measured backend policy.

    ``tau`` overrides the tuned vector with a flat value. With
    ``strip_trailing_upsample`` (default), a trailing nearest
    ``UpsampleSpec`` is removed and recorded as ``upsample_scale`` (it is
    argmax-transparent: callers upsample the class map instead, the argmax
    then a nearest ``upsample_scale`` of the uint8 map). A ``"graph"``
    workload builds its ``models.pose`` builder (``pose_graph``,
    ``openpose_coco``) through ``graph.convert_graph_flagship``; its
    policy overrides are keyed by node name. ``width`` builds the
    architecture at another channel width than the registry's (the
    calibration scripts' small CPU runs): no
    trained checkpoint fits it, so its weights are random from ``seed``
    (a warning says so); the tau file applies as long as the CB layer
    count matches."""
    from .checkpoint import load_npz_graph_params, load_npz_params
    from .convert import convert_flagship, num_cb_layers
    from .graph import convert_graph_flagship, init_graph_params
    from .models import get_model
    from .models import pose as pose_models
    from .network import init_params, torch_dtype

    if name not in REGISTRY:
        raise KeyError(f"unknown workload {name!r} (have: {names()})")
    e = REGISTRY[name]
    if width is not None and width != e.width:
        e = dataclasses.replace(e, width=width)
    cfg = cfg or default_pipeline_config()
    dtype = torch_dtype(cfg.compute_dtype)
    warnings: List[str] = []
    policy_src, extra, fuse = "none", None, False
    if apply_policy and os.path.exists(e.policy_json):
        with open(e.policy_json) as f:
            pj = json.load(f)
        pol = pj.get("overrides") or {}
        # the workload's measured adoption of the fused consumer-detect
        # kernel: a throughput decision only (bit-identical either way)
        fuse = bool(pj.get("fuse_detect", False))
        if pol or fuse:
            policy_src = e.policy_json
            # layer indexes of a sequential net, node names of a graph
            extra = (None if not pol
                     else {int(k): v for k, v in pol.items()}
                     if e.kind == "sequential" else dict(pol))

    def with_policy_fallback(build):
        """A stale policy file (layer indexes or node names of an older
        architecture) degrades to a no-policy build with a warning. The
        fuse_detect decision comes from the same file, so it is dropped
        with the overrides: provenance "none" means no part of it was
        applied."""
        nonlocal policy_src, extra, fuse
        try:
            return build(extra, fuse)
        except ValueError as exc:
            if extra is None:
                raise
            warnings.append(f"backend policy NOT applied ({exc})")
            policy_src, extra, fuse = "none", None, False
            return build(None, False)

    weights = f"random(numpy seed {seed})"
    up_scale = None
    if e.kind == "graph":
        nodes, out_name = getattr(pose_models, e.graph_builder)(
            width=e.width, **e.model_kwargs)
        net = with_policy_fallback(lambda x, fz: convert_graph_flagship(
            nodes, in_shape, cfg, output=out_name, extra_overrides=x,
            fuse_detect=fz))
        params = init_graph_params(nodes, in_shape, seed, cfg.device, dtype)
        try:
            params = load_npz_graph_params(e.npz, params)
            weights = "trained(npz)"
        except Exception as exc:
            warnings.append(f"no trained weights ({exc})")
        specs = nodes
        n_cb = net.num_cb_layers()
    else:
        base = name[:-5] if name.endswith("_hard") else name
        specs = get_model(base, width=e.width, **e.model_kwargs)
        if strip_trailing_upsample and isinstance(specs[-1], UpsampleSpec):
            up_scale = specs[-1].scale
            specs = specs[:-1]
        net = with_policy_fallback(lambda x, fz: convert_flagship(
            specs, in_shape, cfg, extra_overrides=x, fuse_detect=fz))
        params = init_params(specs, in_shape, seed, cfg.device, dtype)
        try:
            params = load_npz_params(e.npz, params, specs)
            weights = "trained(npz)"
        except Exception as exc:
            warnings.append(f"no trained weights ({exc})")
        n_cb = num_cb_layers(net.specs)

    refresh = None
    if tau is not None:
        taus, tau_src = [float(tau)] * n_cb, f"fixed({tau})"
    else:
        d = None
        try:
            with open(e.tau_json) as f:
                d = json.load(f)
        except Exception as exc:
            warnings.append(f"no tuned thresholds ({exc}); tau=0.04")
            taus, tau_src = [0.04] * n_cb, "fixed(0.04)"
        if d is not None:
            # a PRESENT tau file that no longer matches the architecture is
            # a hard error, not a silent flat-tau fallback
            taus = [float(t) for t in d["thresholds"]]
            if len(taus) != n_cb:
                raise ValueError(
                    f"{e.tau_json}: {len(taus)} thresholds for {n_cb} CB "
                    "layers (stale tau file after an architecture change?)")
            refresh = d.get("metadata", {}).get("refresh_every")
            tau_src = "tuned"

    return Workload(name=name, kind=e.kind, net=net, specs=specs,
                    params=params, taus=taus, refresh_every=refresh,
                    metric=e.metric, weights=weights, tau_source=tau_src,
                    policy_source=policy_src, warnings=warnings,
                    upsample_scale=up_scale, fuse_detect=fuse)
