"""Typed configuration (copy of ``cbinfer_tpu.config`` for the PyTorch port).

Conventions, identical to the JAX package so tensors compare like with like:
  * single-frame feature maps are HWC (channels last);
  * conv weights are HWIO: (kh, kw, c_in, c_out);
  * tiles are defined on the OUTPUT grid of each layer.

Differences from the JAX package: ``PipelineConfig.interpret`` is replaced by
``device`` (the port's entry points run on the card unless the caller asks
for the CPU), and the backends are named in the port's idiom: the
hand-written kernel backend is ``"cuda"`` — the counterpart of the JAX
package's ``"pallas"`` — and the capacity-bounded plain path is
``"torch"`` — the counterpart of its ``"jnp"`` (plain PyTorch ops on every
device, no kernel). ``"patch_stem"``, ``"dense_cached"``,
``"dense_cached_flat"`` and ``"band_cached"`` keep their names.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _as_pair(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _as_padding(v):
    """'SAME' | 'VALID' | int | (ph, pw): explicit values are symmetric
    per-dim zero padding with torch output semantics."""
    if isinstance(v, str):
        if v not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME/VALID/int pair, got {v}")
        return v
    return _as_pair(v)


@dataclass(frozen=True)
class TileConfig:
    """Tile-level block-sparsity parameters. ``capacity_fraction`` bounds
    the compacted changed-tile list of the ``patch_stem`` stem, the
    ``band_cached`` stem (in bands) and every ``"torch"`` layer: past
    ``capacity(n_tiles)`` changed tiles the layer recomputes its whole map
    (recorded as ``overflow`` in the step stats). The ``"cuda"`` layers
    walk a device-side count over a full-size list, so it bounds nothing
    there (as on the JAX package's ``"pallas"`` backend)."""

    tile_h: int = 8
    tile_w: int = 8
    capacity_fraction: float = 1.0

    def capacity(self, n_tiles: int) -> int:
        cap = int(-(-self.capacity_fraction * n_tiles // 1))  # ceil
        return max(1, min(cap, n_tiles))


@dataclass(frozen=True)
class ConvSpec:
    """Layer IR node for a (conv [+bias] [+activation]) layer."""

    features: int
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    dilation: Tuple[int, int] = (1, 1)
    padding: str = "SAME"  # "SAME" or "VALID"
    activation: Optional[str] = "relu"  # None | "relu"
    use_bias: bool = True
    threshold: float = 0.0
    use_cb: bool = True
    backend: Optional[str] = None  # per-layer override of PipelineConfig
    # Mask forwarding: when the producer emits a dirty hint, skip detection;
    # the changed-tile mask is the hint dilated by this conv's receptive
    # field and the input cache is refreshed by a pure tile copy (no diff,
    # ``threshold`` unused). Bit-identical to tau = -1 re-detection. Falls
    # back to re-detection when no hint arrives (after a dense layer).
    forward_hint: bool = False
    # Fused consumer detect (set by convert_flagship where the static fuse
    # gate holds): this layer's delta-conv kernel also runs the NEXT
    # layer's detect + accept + dilate on each tile it computes, and the
    # consumer skips its detect stage. Bit-identical to the unfused pair;
    # ignored whenever the runtime gate does not hold.
    fuse_next_detect: bool = False
    kind: str = "conv"

    def __post_init__(self):
        object.__setattr__(self, "kernel", _as_pair(self.kernel))
        object.__setattr__(self, "stride", _as_pair(self.stride))
        object.__setattr__(self, "dilation", _as_pair(self.dilation))
        object.__setattr__(self, "padding", _as_padding(self.padding))
        if self.activation not in (None, "relu"):
            raise ValueError(f"unsupported activation {self.activation}")


@dataclass(frozen=True)
class PoolSpec:
    """Layer IR node for change-based max pooling. ``forward_hint`` and
    ``elide_in_cache`` are set by ``convert.convert_flagship`` (see the
    JAX package's PoolSpec for their contract)."""

    window: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: str = "VALID"
    threshold: float = 0.0
    use_cb: bool = True
    backend: Optional[str] = None
    forward_hint: bool = False
    elide_in_cache: bool = False
    kind: str = "pool"

    def __post_init__(self):
        object.__setattr__(self, "window", _as_pair(self.window))
        object.__setattr__(self, "stride", _as_pair(self.stride))
        object.__setattr__(self, "padding", _as_padding(self.padding))


@dataclass(frozen=True)
class UpsampleSpec:
    """Nearest/bilinear upsampling (dense; used by segmentation heads)."""

    scale: Tuple[int, int] = (2, 2)
    method: str = "nearest"  # "nearest" | "bilinear"
    kind: str = "upsample"

    def __post_init__(self):
        object.__setattr__(self, "scale", _as_pair(self.scale))


LayerSpec = Any  # Union[ConvSpec, PoolSpec, UpsampleSpec]


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline execution parameters (dtypes, tiling, kernel backend,
    device)."""

    tile: TileConfig = field(default_factory=TileConfig)
    compute_dtype: str = "float32"   # dtype of conv math
    cache_dtype: str = "float32"     # dtype of persistent activation caches
    backend: str = "cuda"            # kernels (CPU: plain twins) | "torch"
    device: str = "cuda"             # "cuda" | "cpu"


@dataclass(frozen=True)
class RunConfig:
    """Top-level run description saved next to benchmark outputs
    (``cbinfer_tpu/config.py:188``); ``pipeline.device`` says where
    ``benchmark.make_clips`` puts the frames."""

    model: str = "scene"
    height: int = 720
    width: int = 1280
    frames: int = 32
    streams: int = 1
    seed: int = 0
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


# ------------------------------ JSON round-trip ------------------------------


def to_json(obj) -> str:
    return json.dumps(_encode(obj), indent=2, sort_keys=True)


def _encode(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {f.name: _encode(getattr(obj, f.name))
             for f in dataclasses.fields(obj)}
        d["__type__"] = type(obj).__name__
        return d
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


_TYPES = {
    "TileConfig": TileConfig,
    "ConvSpec": ConvSpec,
    "PoolSpec": PoolSpec,
    "UpsampleSpec": UpsampleSpec,
    "PipelineConfig": PipelineConfig,
    "RunConfig": RunConfig,
}


def from_json(s: str):
    return _decode(json.loads(s))


def _decode(obj):
    if isinstance(obj, dict):
        t = obj.pop("__type__", None)
        decoded = {k: _decode(v) for k, v in obj.items()}
        if t is not None:
            return _TYPES[t](**decoded)
        return decoded
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj
