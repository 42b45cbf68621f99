"""Change-based conv and max-pool layers (PyTorch port of the parts of
``cbinfer_tpu.layers`` that the scene and pose paths reach).

Each CB layer keeps two tensors on the device: ``in_cache``, the last input
it accepted (stored spatially padded, in the JAX package's storage layout),
and ``out_cache``, its output on the tile grid. Per frame a layer finds the
pixels that moved by more than its threshold, accepts them, and recomputes
only the output tiles whose receptive field holds such a pixel. Both caches
are UPDATED IN PLACE, where the JAX package donates and aliases them; the
state objects returned are the ones passed in.

Cold start needs no branch: ``in_cache`` starts at ``COLD_START_FILL`` so
frame 0 sees every pixel as changed. Dirty hints: each layer emits a
conservative changed-tile mask over its output on a fixed 8x8 grid, and
the next layer's sparse detect visits only those tiles.

Backends: ``"cuda"`` (the hand-written kernels; on CPU tensors their plain
versions), ``"patch_stem"`` (the sparse small-cin stem: full-map stem
detect plus the stem conv kernel over dirty (8, 32) tiles),
``"dense_cached"`` (full-map detect plus a dense conv from the accepted
cache), ``"torch"`` (the JAX package's ``"jnp"``: plain PyTorch ops, a
gathered list of ``TileConfig.capacity`` tiles and a dense fallback past
it), ``band_cached`` (a stem recomputing full-width row bands of dirty
tiles, bounded the same way) and ``dense_cached_flat`` (``dense_cached``
with the stem's input cache kept as the flat (H, W*C) view).

Capacity overflow (``"torch"``, ``band_cached``): the JAX package branches
to a dense recompute with ``lax.cond``; a branch on a device value here
would read it on the host, which a CUDA graph cannot hold. So the tile path
runs over its list every frame, the dense fallback too, and
``torch.where(overflow, dense, out_cache)`` keeps one of them. Both share
``ops.delta_conv._accumulate``, so the choice is value-exact; the cost is
a dense conv every frame, which is why these are not the shipped path.

Change-mask modes of a ``"cuda"`` conv: re-detection (the default);
mask forwarding (``ConvSpec.forward_hint``: no detection, the input cache
tracks the producer's output over the hinted tiles by a pure tile copy and
the mask is the hint dilated by the receptive field, bit-identical to
re-detection at tau = -1 on 8-aligned maps); and pre-detection
(``ConvSpec.fuse_next_detect`` on the PRODUCER: its fused kernel already
ran this layer's detect, which rides in on ``DirtyHint.predetect``).

Stage scopes: the regions the JAX package names with ``jax.named_scope``
(``detect``, ``accept_hinted``, ``compact``, ``delta_kernel``,
``patch_conv``, ``band_conv``, ``cached_conv``, ``out_pad``) are
``torch.profiler.record_function`` ranges of the same names here
(``stage``), so a profile attributes each launch to its stage. They are
host-side only and opened only while a profiler records: no device op, no
host sync, nothing inside a CUDA graph.

Lane padding: the JAX package pads every channel dim to 128 on its
``"pallas"`` backend; the port stores logical widths (the delta conv
kernels take any cin that is a multiple of 8 in bf16, 4 in float32). The
exceptions are the caches of a ``"cuda"`` layer off that grid: a conv's
out cache whose cout is off it (``stored_features``) keeps zero channels
up to the grid, computed on zero weight columns and a zero bias, and the
layer's ``Feature`` crops them; an input cache whose width is off it (the
3-channel stem, a pool's or a conv's input from such a producer;
``cache_channels``) keeps zero channels up to the grid, which the
full-map detect never reads or writes, the other kernels read as zeros,
and the delta conv multiplies by zero weight rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import network
from .config import ConvSpec, PipelineConfig, PoolSpec
from .ops import compact, detect
from .ops import flat4 as flat4_ops
from .ops.delta_conv import (delta_conv_jnp, dense_conv_shifted,
                             make_storage, storage_interior)
from .ops.delta_pool import delta_pool_jnp, dense_pool
from .ops.geometry import TileGeometry, cdiv, conv_tile_geometry
from .ops.kernels.accept import accept_tiles
from .ops.kernels.delta_conv import channel_quantum, delta_conv
from .ops.kernels.delta_conv_detect import delta_conv_detect, fuse_gate
from .ops.kernels.delta_pool import delta_pool
from .ops.kernels.detect_full import detect_full
from .ops.kernels.detect_sparse import detect_sparse
from .ops.kernels.pool_fused import detect_pool_fused
from .ops.kernels.stem_conv import stem_conv
from .ops.kernels.stem_detect import stem_detect

NEG_FILL = -3.0e38  # pool margin fill (finite "-inf")
HINT_TILE = 8       # fixed tile size of inter-layer dirty hints
BACKENDS = ("cuda", "patch_stem", "dense_cached", "torch", "band_cached",
            "dense_cached_flat")
STEM_BACKENDS = ("band_cached", "dense_cached_flat")  # conv layers only
_NO_SCOPE = contextlib.nullcontext()


def stage(name: str):
    """The profiler range of one stage (the JAX package's ``named_scope``
    of the same name), or nothing while no profiler records: a
    ``record_function`` costs the host microseconds on every call."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


@dataclasses.dataclass
class CBLayerState:
    in_cache: torch.Tensor   # padded storage of the last accepted input
    out_cache: torch.Tensor  # (Ho_pad, Wo_pad, Cout) cached output


class PreDetect(NamedTuple):
    """The consumer layer's detect outputs, computed by the PRODUCER's
    fused delta-conv + detect kernel: the consumer skips C1+C2 and goes
    straight to compaction. Bit-identical to the sparse detect on the
    producer's output."""
    in_cache: torch.Tensor  # the consumer's input cache (updated in place)
    mask: torch.Tensor      # (tiles_h, tiles_w) f32 changed-out-tile mask
    npix: torch.Tensor      # (1,) int32 changed pixels
    n_detect: torch.Tensor  # () int32 tiles visited (== producer count)


class FuseCtx(NamedTuple):
    """Consumer-layer context handed to a ``fuse_next_detect`` producer by
    ``CBNet.apply``: the consumer's spec, its input cache (which the fused
    kernel updates in place) and its runtime tau."""
    spec: Any
    in_cache: torch.Tensor
    tau: Any


class DirtyHint(NamedTuple):
    """Conservative changed-region mask over a tensor, 8x8 granularity.
    ``predetect`` is attached by a producer whose kernel already ran the
    NEXT layer's detect; only the immediate consumer reads it."""
    mask: torch.Tensor  # (ceil(H/8), ceil(W/8)) bool
    predetect: Optional[PreDetect] = None


@dataclasses.dataclass(frozen=True)
class Feature:
    """A layer output in its padded storage form plus logical dims. CB
    consumers read logical coordinates straight out of the padded array;
    others call ``crop()`` (a view, no copy)."""
    data: torch.Tensor
    h: int
    w: int
    c: int

    def crop(self) -> torch.Tensor:
        return self.data[:self.h, :self.w, :self.c]


def _unwrap(x):
    if isinstance(x, Feature):
        if x.data.shape[-1] != x.c:  # a padded out cache: its logical part
            return x.crop().contiguous(), x.h, x.w, x.c
        return x.data, x.h, x.w, x.c
    return x, x.shape[0], x.shape[1], x.shape[2]


def _unwrap_stored(x, c_store: int):
    """``_unwrap``, except that a padded Feature whose data is ``c_store``
    channels wide (a ``"cuda"`` layer's input storage) passes whole, its
    zero channels included, with no crop."""
    if isinstance(x, Feature) and x.data.shape[-1] == c_store:
        return x.data, x.h, x.w, x.c
    return _unwrap(x)


def _to_width(x: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """``x`` as wide as a ``"cuda"`` layer's input storage of ``c``
    channels, as the hinted kernels read it: itself, or (a raw input off
    the channel grid, such as a DAG's concat) its logical map with zero
    channels appended, one copy a frame."""
    if x.shape[-1] == c:
        return x
    return F.pad(x[:h, :w], (0, c - x.shape[-1]))


def _layer_cfg(spec, cfg: PipelineConfig) -> PipelineConfig:
    """Apply the spec's per-layer backend override to the pipeline cfg."""
    if spec.backend is not None and spec.backend != cfg.backend:
        cfg = dataclasses.replace(cfg, backend=spec.backend)
    if cfg.backend not in BACKENDS:
        raise NotImplementedError(
            f"backend {cfg.backend!r} is not ported (have {BACKENDS})")
    if cfg.backend in STEM_BACKENDS and not isinstance(spec, ConvSpec):
        raise ValueError(f"backend {cfg.backend!r} is for conv layers; "
                         f"got {type(spec).__name__}")
    return cfg


def _geometry(spec, in_shape: Tuple[int, int, int], cfg: PipelineConfig
              ) -> TileGeometry:
    th, tw = cfg.tile.tile_h, cfg.tile.tile_w
    if isinstance(spec, ConvSpec):
        if cfg.backend == "patch_stem":  # the stem kernel's fixed tiles
            th, tw = flat4_ops.TILE_H, flat4_ops.TILE_W
        elif cfg.backend == "band_cached":
            # full-width row bands: tw clamps to out_w, so tiles_w == 1
            # and a compacted tile id IS a band index
            tw = 1 << 30
        return conv_tile_geometry(in_shape, spec.kernel, spec.stride,
                                  spec.dilation, spec.padding, th, tw)
    return conv_tile_geometry(in_shape, spec.window, spec.stride, (1, 1),
                              spec.padding, th, tw)


def stored_features(spec: ConvSpec, cfg: PipelineConfig) -> int:
    """Channels of a conv layer's out cache: ``spec.features``, rounded up
    to the tile-conv kernels' ``channel_quantum`` on the ``"cuda"``
    backend (on every device, so that the card and the CPU keep one
    layout)."""
    cfg = _layer_cfg(spec, cfg)
    if cfg.backend != "cuda":
        return spec.features
    q = channel_quantum(network.torch_dtype(cfg.cache_dtype))
    return -(-spec.features // q) * q


def cache_channels(spec, in_c: int, cfg: PipelineConfig) -> Tuple[int, int]:
    """Channels a CB layer stores: (input storage, out cache), for an input
    of ``in_c`` logical channels. ``cb_layer_init`` sizes both caches by
    it, and the cost model (``metrics.effective_cost_view``) prices the
    detect traffic at the first, so the two cannot drift apart. The input
    storage keeps the logical width (the JAX package pads it to 128 lanes
    on its ``"pallas"`` backend), except that of a ``"cuda"`` layer,
    which is rounded up to the tile convs' ``channel_quantum`` (on every
    device, as ``stored_features``: 3 -> 8 in bf16, 4 in float32); a
    conv's out cache has ``stored_features``, a pool's its input storage's
    width. A padded producer's out cache is then exactly as wide as its
    ``"cuda"`` consumer's input storage, and passes to it whole
    (``_unwrap_stored``): the zero channels of both agree."""
    lcfg = _layer_cfg(spec, cfg)
    if lcfg.backend == "cuda":
        q = channel_quantum(network.torch_dtype(lcfg.cache_dtype))
        in_c = -(-in_c // q) * q
    if isinstance(spec, ConvSpec):
        return in_c, stored_features(spec, cfg)
    return in_c, in_c


def _padded_params(w: torch.Tensor, b: Optional[torch.Tensor], cout: int,
                   cin: Optional[int] = None):
    """``(w, b)`` with zero input channels up to ``cin`` and zero output
    channels up to ``cout``: made at the first use and kept on ``w`` (anew
    if ``w`` or ``b`` was written in place since), so every frame hands the
    kernel the same tensors."""
    cin = w.shape[2] if cin is None else cin
    if w.shape[2:] == (cin, cout):
        return w, b
    key = (w._version, cin, cout,
           None if b is None else (b.data_ptr(), b._version))
    got = getattr(w, "_cb_padded", None)
    if got is None or got[0] != key:
        wp = w.new_zeros(tuple(w.shape[:2]) + (cin, cout))
        wp[:, :, :w.shape[2], :w.shape[3]] = w
        bp = None
        if b is not None:
            bp = b.new_zeros((cout,))
            bp[:b.shape[0]] = b
        got = w._cb_padded = (key, wp, bp)
    return got[1], got[2]


def cb_layer_init(spec, in_shape: Tuple[int, int, int], cfg: PipelineConfig
                  ) -> CBLayerState:
    """Allocate a layer's caches on ``cfg.device``, of the widths
    ``cache_channels`` gives."""
    cin, cout = cache_channels(spec, in_shape[2], cfg)
    cfg = _layer_cfg(spec, cfg)
    dev = network.resolve_device(cfg.device)
    dtype = network.torch_dtype(cfg.cache_dtype)
    g = _geometry(spec, (in_shape[0], in_shape[1], cin), cfg)
    out_cache = torch.zeros((g.out_h_pad, g.out_w_pad, cout), dtype=dtype,
                            device=dev)
    if isinstance(spec, PoolSpec) and spec.elide_in_cache:
        # fused forward-hint pool: the input cache is never read
        return CBLayerState(
            in_cache=torch.zeros((1, 1, 1), dtype=dtype, device=dev),
            out_cache=out_cache)
    if cfg.backend == "dense_cached_flat":
        # the flat (H, W*C) view of the HWC cache, no margins (the conv
        # pads on read)
        return CBLayerState(
            in_cache=torch.full((in_shape[0], in_shape[1] * cin),
                                detect.COLD_START_FILL, dtype=dtype,
                                device=dev),
            out_cache=out_cache)
    margin = NEG_FILL if isinstance(spec, PoolSpec) else 0.0
    in_cache = make_storage(g, detect.COLD_START_FILL, margin, dtype, dev)
    in_cache[..., in_shape[2]:] = 0  # channels past the input: zero
    return CBLayerState(in_cache=in_cache, out_cache=out_cache)


# ----------------------------- dirty hints ----------------------------------


def _out_hint(tile_mask: torch.Tensor, g: TileGeometry,
              overflow: Optional[torch.Tensor] = None) -> DirtyHint:
    """Map this layer's changed-output-tile mask onto the 8x8 hint grid of
    the CROPPED output. ``overflow`` (a device bool): the layer recomputed
    everything, so everything is dirty."""
    hh, hw = cdiv(g.out_h, HINT_TILE), cdiv(g.out_w, HINT_TILE)
    if (g.th, g.tw) == (HINT_TILE, HINT_TILE):  # the grids coincide
        m = tile_mask[:hh, :hw]
    elif g.th % HINT_TILE == 0 and g.tw % HINT_TILE == 0:
        m = tile_mask.repeat_interleave(g.th // HINT_TILE, 0)
        m = m.repeat_interleave(g.tw // HINT_TILE, 1)[:hh, :hw]
    else:  # via pixel space (small bool map)
        pix = tile_mask.repeat_interleave(g.th, 0).repeat_interleave(g.tw, 1)
        pix = pix[:g.out_h, :g.out_w].float()
        pix = F.pad(pix, (0, hw * HINT_TILE - g.out_w,
                          0, hh * HINT_TILE - g.out_h))
        m = F.max_pool2d(pix[None, None], HINT_TILE)[0, 0] > 0
    if overflow is not None:
        m = m | overflow
    return DirtyHint(mask=m.contiguous())


@functools.lru_cache(maxsize=None)
def _forward_indicators(g: TileGeometry, hh: int, hw: int, device):
    """The two 0/1 matrices of ``_forward_mask`` for one geometry: m1[a, i]
    = out-tile row a reads hint row i, m2[j, b] = out-tile column b reads
    hint column j (rectangle-interval overlap). Built on ``device``: a
    copy from the host would make the frame loop wait for the card."""
    sh, sw = g.stride
    lo_h = torch.arange(g.tiles_h, device=device) * (g.th * sh) - g.pad_lo_h
    hi = torch.arange(hh, device=device) * HINT_TILE
    m1 = ((hi[None, :] < lo_h[:, None] + g.win_h)
          & (hi[None, :] + HINT_TILE > lo_h[:, None])).float()
    lo_w = torch.arange(g.tiles_w, device=device) * (g.tw * sw) - g.pad_lo_w
    hj = torch.arange(hw, device=device) * HINT_TILE
    m2 = ((hj[:, None] < lo_w[None, :] + g.win_w)
          & (hj[:, None] + HINT_TILE > lo_w[None, :])).float()
    return m1, m2


def _forward_mask(hint_mask: torch.Tensor, g: TileGeometry) -> torch.Tensor:
    """Changed-OUT-tile mask of a FORWARDING layer: the producer's hint
    dilated by this layer's receptive field, exact on the tile grids, as
    two tiny indicator matmuls. Equals the tau = -1 re-detection mask on
    8-aligned maps."""
    m1, m2 = _forward_indicators(g, hint_mask.shape[0], hint_mask.shape[1],
                                 hint_mask.device)
    return (m1 @ hint_mask.float() @ m2) > 0


def _accept_hinted(x: torch.Tensor, in_cache: torch.Tensor, hint: DirtyHint,
                   g: TileGeometry, cfg: Optional[PipelineConfig] = None):
    """Forwarding-mode cache update IN PLACE: the storage tracks the
    producer's output over the hinted tiles (no diff, no tau), by the tile
    copy kernel (a ``"torch"`` layer's ``cfg``: a full-map ``where``,
    value-identical). Returns (storage, n_detect_tiles)."""
    if cfg is not None and cfg.backend == "torch":
        H, W = g.in_h, g.in_w
        pix = hint.mask.repeat_interleave(HINT_TILE, 0) \
            .repeat_interleave(HINT_TILE, 1)[:H, :W]
        interior = storage_interior(in_cache, g)
        torch.where(pix[..., None], x[:H, :W].to(interior.dtype), interior,
                    out=interior)
        return in_cache, hint.mask.sum(dtype=torch.int32)
    dcomp = compact.compact_mask(hint.mask, hint.mask.numel())
    x = _to_width(x, in_cache.shape[-1], g.in_h, g.in_w)
    storage = accept_tiles(x.to(in_cache.dtype), in_cache, dcomp.idx,
                           dcomp.count, g)
    return storage, dcomp.count


# ------------------------------ detection -----------------------------------


def _detect_xla(x: torch.Tensor, in_cache: torch.Tensor, tau,
                g: TileGeometry, hint: Optional[DirtyHint]):
    """Full-map detect + accepted-cache update IN PLACE (the interior view
    of the storage; margins are constant). Returns (storage, per-pixel
    changed map, changed pixels, detect tiles). Named after the JAX
    package's function it ports."""
    H, W = g.in_h, g.in_w
    x = x[:H, :W]
    interior = storage_interior(in_cache, g)
    # |x - cache| in float32, max over channels
    diff = (x.float() - interior).abs_().amax(dim=-1)
    changed = diff > detect.tau32(tau)
    if hint is not None:
        pix_hint = hint.mask.repeat_interleave(HINT_TILE, 0) \
            .repeat_interleave(HINT_TILE, 1)[:H, :W]
        changed = changed & pix_hint
    torch.where(changed[..., None], x.to(interior.dtype), interior,
                out=interior)
    n_detect = (hint.mask.sum(dtype=torch.int32) if hint is not None
                else cdiv(H, HINT_TILE) * cdiv(W, HINT_TILE))
    return in_cache, changed, changed.sum(dtype=torch.int32), n_detect


def _detect_and_mask(x: torch.Tensor, in_cache: torch.Tensor, tau,
                     g: TileGeometry, cfg: PipelineConfig,
                     hint: Optional[DirtyHint]):
    """C1+C2: returns (storage, changed_out_tile_mask bool, changed_pixels,
    detect_tiles). ``"cuda"`` layers run the sparse detect kernel over the
    producer's hint, or the full-map detect kernel where there is none
    (after a dense layer); ``"dense_cached"`` layers detect the full map
    with torch ops. The JAX package's gates for its two detect kernels
    also ask for an 8-aligned map (the sparse one: 8 rows and 8-aligned
    columns) and 128-lane channels, and send other maps to XLA ops; these
    are rules of Mosaic's windows with no counterpart on the card (both
    CUDA kernels take the map's partial edge tiles), so they are dropped
    and every map goes through the kernels, with the same results."""
    if hint is not None and hint.predetect is not None:
        # the producer's fused kernel already ran THIS layer's detect on
        # the tiles it computed, into this very cache
        pd = hint.predetect
        assert pd.in_cache is in_cache, "pre-detect ran on another cache"
        return in_cache, pd.mask > 0.5, pd.npix[0], pd.n_detect
    H, W = g.in_h, g.in_w
    if cfg.backend == "cuda":
        if hint is None:
            storage, maskf, npix = detect_full(x, in_cache, tau, g)
            return (storage, maskf > 0.5, npix[0],
                    cdiv(H, HINT_TILE) * cdiv(W, HINT_TILE))
        dcomp = compact.compact_mask(hint.mask, hint.mask.numel())
        x = _to_width(x, in_cache.shape[-1], H, W)
        storage, maskf, npix = detect_sparse(x, in_cache, tau, dcomp.idx,
                                             dcomp.count, g)
        return storage, maskf > 0.5, npix[0], dcomp.count
    storage, changed, n_pix, n_detect = _detect_xla(x, in_cache, tau, g, hint)
    return storage, detect.changed_tile_mask(changed, g), n_pix, n_detect


# ------------------------------ layer steps ---------------------------------


def _bounded_update(storage: torch.Tensor, comp: compact.Compacted,
                    capacity: int, g: TileGeometry, out_cache: torch.Tensor,
                    tile_fn, dense_fn) -> Optional[torch.Tensor]:
    """The capacity-bounded tile path with its dense fallback, IN PLACE
    and without a host read: ``tile_fn`` over the ``capacity`` listed
    tiles, then, where more tiles changed, ``dense_fn(storage)`` (the
    whole map) replaces the out cache through ``torch.where``. Returns the
    device bool ``overflow``, or None when the list holds every tile."""
    tile_fn(storage, comp.idx, comp.count, out_cache)
    if capacity >= g.n_tiles:
        return None
    overflow = comp.count > capacity
    torch.where(overflow, dense_fn(storage).to(out_cache.dtype), out_cache,
                out=out_cache)
    return overflow


def _bounded_conv_fns(w, b, g: TileGeometry, spec: ConvSpec, compute_dtype):
    """(tile_fn, dense_fn) of a bounded conv (``"torch"``, ``band_cached``):
    the tile path over a sentinel-padded list and its dense fallback."""
    def tile_fn(storage, idx, count, out_cache):
        delta_conv_jnp(storage, idx, w, b, out_cache, g, spec.activation,
                       compute_dtype)

    def dense_fn(storage):
        return dense_conv_shifted(storage, w, b, g, spec.activation,
                                  compute_dtype)
    return tile_fn, dense_fn


def _run_gated(spec, state: CBLayerState, x: torch.Tensor, g: TileGeometry,
               cfg: PipelineConfig, tile_fn, tau=None,
               hint: Optional[DirtyHint] = None, forward: bool = False,
               fused_fn=None, dense_fn=None):
    """Shared detect -> compact -> delta-kernel skeleton. On ``"cuda"`` it
    is cond-free: the kernels walk the device-side count, so the index list
    holds every tile (capacity = n_tiles, as on the JAX package's
    ``"pallas"`` backend) and there is no overflow. On ``"torch"`` the list
    holds ``cfg.tile.capacity(n_tiles)`` tiles and ``dense_fn`` is the
    fallback past it (``_bounded_update``). ``forward`` (needs a hint):
    detection is replaced by the hint-dilated mask plus a pure tile copy,
    tau unused. ``fused_fn`` replaces ``tile_fn`` with the fused delta conv
    + consumer detect and returns the consumer's ``PreDetect``, which rides
    out on the returned hint. Returns (state, stats, out_hint)."""
    if forward:
        assert hint is not None
        with stage("accept_hinted"):
            in_cache, n_detect = _accept_hinted(x, state.in_cache, hint, g,
                                                cfg)
            mask = _forward_mask(hint.mask, g)
        # forwarding never inspects pixels; visited = hinted area
        n_pix = n_detect * (HINT_TILE * HINT_TILE)
    else:
        if tau is None:
            tau = spec.threshold
        with stage("detect"):
            in_cache, mask, n_pix, n_detect = _detect_and_mask(
                x, state.in_cache, tau, g, cfg, hint)
    bounded = cfg.backend == "torch"
    capacity = cfg.tile.capacity(g.n_tiles) if bounded else g.n_tiles
    with stage("compact"):
        comp = compact.compact_mask(mask, capacity)
    predetect = overflow = None
    with stage("delta_kernel"):
        if fused_fn is not None:
            predetect = fused_fn(in_cache, comp.idx, comp.count,
                                 state.out_cache)
        elif not bounded:
            tile_fn(in_cache, comp.idx, comp.count, state.out_cache)
        else:
            overflow = _bounded_update(in_cache, comp, capacity, g,
                                       state.out_cache, tile_fn, dense_fn)
    stats = {
        "changed_tiles": comp.count,
        "computed_tiles": (comp.count if overflow is None
                           else torch.where(overflow, g.n_tiles, comp.count)),
        "n_tiles": g.n_tiles,
        "overflow": False if overflow is None else overflow,
        "changed_pixels": n_pix,
        "detect_tiles": n_detect,
    }
    out_hint = _out_hint(mask, g, overflow)
    if predetect is not None:
        out_hint = out_hint._replace(predetect=predetect)
    return state, stats, out_hint


def fuse_next_gate(spec, spec2, in_shape: Tuple[int, int, int],
                   cfg: PipelineConfig) -> bool:
    """STATIC eligibility of marking ``spec`` (producer, input
    ``in_shape``) with ``fuse_next_detect`` for consumer ``spec2``: both
    plain ``"cuda"`` CB convs, the consumer detecting (not forwarding),
    and the kernel's ``fuse_gate``. ``cb_conv_apply`` re-checks it at run
    time."""
    if not (isinstance(spec, ConvSpec) and spec.use_cb
            and isinstance(spec2, ConvSpec) and spec2.use_cb
            and not spec2.forward_hint):
        return False
    backends = [spec.backend or cfg.backend, spec2.backend or cfg.backend]
    if backends != ["cuda", "cuda"]:
        return False
    if stored_features(spec, cfg) != spec.features:
        # the fused kernel detects on the out tile it computes, at the
        # consumer's input width: a padded tile has other channels
        return False
    g = _geometry(spec, in_shape, _layer_cfg(spec, cfg))
    g2 = _geometry(spec2, (g.out_h, g.out_w, spec.features),
                   _layer_cfg(spec2, cfg))
    return fuse_gate(g, g2)


def _conv_prep(params, x, spec: ConvSpec, cfg: PipelineConfig,
               cin_store: Optional[int] = None):
    """Unwrap the (possibly padded) Feature; returns (x, w, b, g), ``g``
    over an input storage of ``cin_store`` channels where given (a
    ``"cuda"`` conv's input cache, ``cache_channels``), else of x's."""
    w, b = params
    x, H, W, xc = (_unwrap(x) if cin_store is None
                   else _unwrap_stored(x, cin_store))
    if w.shape[2] != xc:
        raise ValueError(f"weights {tuple(w.shape)} for {xc} input channels")
    return x, w, b, _geometry(spec, (H, W, cin_store or xc), cfg)


def _store_output(state: CBLayerState, y: torch.Tensor,
                  g: TileGeometry) -> None:
    """A full-map output copied into the out cache's logical region (the
    pad rows/cols are never read by a consumer). The cache is never
    rebound: a state tensor keeps its storage for the life of the state,
    which a captured CUDA graph of the frame loop relies on. A padded
    cache's zero channels are left as they are."""
    state.out_cache[:g.out_h, :g.out_w, :y.shape[-1]].copy_(y)


def _out_region(state: CBLayerState, g: TileGeometry, dtype):
    """The out cache's logical region when a matmul can write it directly
    (contiguous, in the compute dtype), else None."""
    region = state.out_cache[:g.out_h, :g.out_w]
    return region if region.is_contiguous() and region.dtype == dtype \
        else None


def cb_conv_apply(params, state: CBLayerState, x, spec: ConvSpec,
                  cfg: PipelineConfig, tau=None,
                  hint: Optional[DirtyHint] = None,
                  fuse_ctx: Optional[FuseCtx] = None):
    """One frame through a change-based conv layer; caches updated in
    place. ``fuse_ctx`` (``CBNet.apply`` passes it when this spec has
    ``fuse_next_detect``): run the fused delta conv + consumer detect and
    return the consumer's detect outputs as ``out_hint.predetect``;
    ignored when the runtime fuse gate does not hold (value-identical).
    Returns (y: Feature, state, stats, out_hint)."""
    pipe_cfg = cfg
    cfg = _layer_cfg(spec, cfg)
    compute_dtype = network.torch_dtype(cfg.compute_dtype)
    x, w, b, g = _conv_prep(
        params, x, spec, cfg,
        state.in_cache.shape[-1] if cfg.backend == "cuda" else None)

    if cfg.backend == "patch_stem":
        return _patch_stem_apply(state, x, w, b, g, spec, cfg, compute_dtype,
                                 tau)
    if cfg.backend == "dense_cached_flat":
        return _flat_stem_apply(state, x, w, b, g, spec, compute_dtype, tau)
    if cfg.backend == "band_cached":
        return _band_apply(state, x, w, b, g, spec, cfg, compute_dtype, tau,
                           hint)

    if cfg.backend == "dense_cached":
        # detect + full dense conv FROM THE ACCEPTED CACHE every frame:
        # value-exact by the out_cache == f(in_cache) invariant, and it
        # produces the hint chain (the cin=3 stem of this slice)
        if tau is None:
            tau = spec.threshold
        with stage("detect"):
            storage, mask, n_pix, n_detect = _detect_and_mask(
                x, state.in_cache, tau, g, cfg, hint)
        region = None
        with stage("cached_conv"):
            if network.use_im2col(spec, w.shape[2]):
                # the storage's zero margins ARE the SAME padding: read the
                # padded window straight out of it, no pad copy
                xp = storage[g.store_lo_h - g.pad_lo_h:
                             g.store_lo_h + g.in_h + g.pad_hi_h,
                             g.dx0:g.store_lo_w + g.in_w + g.pad_hi_w]
                # the matmul writes straight into the cache where it can,
                # sparing a full-map copy every frame
                region = _out_region(state, g, compute_dtype)
                y = network.im2col_conv(xp, w, b, spec, compute_dtype,
                                        out=region)
            else:
                y = network.dense_conv(storage_interior(storage, g), w, b,
                                       spec, compute_dtype)
        if region is None:
            with stage("out_pad"):
                _store_output(state, y, g)
        stats = {
            "changed_tiles": mask.sum(dtype=torch.int32),
            "computed_tiles": g.n_tiles,
            "n_tiles": g.n_tiles,
            "overflow": False,
            "changed_pixels": n_pix,
            "detect_tiles": n_detect,
        }
        return (Feature(state.out_cache, g.out_h, g.out_w, spec.features),
                state, stats, _out_hint(mask, g))

    fused_fn = dense_fn = None
    if cfg.backend == "torch":
        tile_fn, dense_fn = _bounded_conv_fns(w, b, g, spec, compute_dtype)
    else:
        w, b = _padded_params(w, b, state.out_cache.shape[-1], g.cin)

        def tile_fn(storage, idx, count, out_cache):
            delta_conv(storage, idx, w, b, out_cache, g, spec.activation,
                       compute_dtype, count=count)

    if fuse_ctx is not None and cfg.backend == "cuda":
        spec2 = fuse_ctx.spec
        cfg2 = _layer_cfg(spec2, pipe_cfg)
        g2 = _geometry(spec2, (g.out_h, g.out_w, spec.features), cfg2)
        # runtime re-check of the converter's static gate: the plain
        # kernel on any mismatch (value-identical)
        if (cfg2.backend == "cuda"
                and tuple(fuse_ctx.in_cache.shape) == g2.store_shape
                and fuse_gate(g, g2)):
            tau2 = (fuse_ctx.tau if fuse_ctx.tau is not None
                    else spec2.threshold)

            def fused_fn(storage, idx, count, out_cache):
                _, nc, maskf, npix = delta_conv_detect(
                    storage, idx, w, b, out_cache, g, spec.activation,
                    compute_dtype, fuse_ctx.in_cache, tau2, g2, count=count)
                return PreDetect(in_cache=nc, mask=maskf, npix=npix,
                                 n_detect=count)

    # a forward-hint conv with no hint (after a dense layer) re-detects
    forward = bool(spec.forward_hint) and hint is not None
    state, stats, out_hint = _run_gated(spec, state, x, g, cfg, tile_fn,
                                        tau, hint, forward=forward,
                                        fused_fn=fused_fn, dense_fn=dense_fn)
    return (Feature(state.out_cache, g.out_h, g.out_w, spec.features), state,
            stats, out_hint)


def _or_cells(cells: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """OR of each (kh, kw) block of a bool cell mask; a partial block at
    the bottom or right edge counts the cells it has."""
    if (kh, kw) == (1, 1):
        return cells
    h, w = cells.shape
    m = F.pad(cells, (0, -w % kw, 0, -h % kh))
    return m.view(cdiv(h, kh), kh, cdiv(w, kw), kw).any(dim=3).any(dim=1)


def _patch_stem_apply(state: CBLayerState, x: torch.Tensor, w, b,
                      g: TileGeometry, spec: ConvSpec, cfg: PipelineConfig,
                      compute_dtype, tau):
    """The sparse small-cin stem: one kernel detects, accepts and dilates
    over the whole frame, one recomputes only the dirty (8, 32) stem tiles.
    Three grids: ``g`` (the kernel's (8, 32) tiles), the configured tile
    grid the stats are reported on, and the 8x8 hint grid."""
    if tau is None:
        tau = spec.threshold
    H, W, xc = g.in_h, g.in_w, g.cin
    if not flat4_ops.supports((H, W, xc), spec.kernel, spec.stride,
                              spec.dilation, spec.padding, spec.activation):
        raise ValueError(f"patch_stem does not support {spec} on {(H, W, xc)}")
    x = x[:H, :W, :xc]
    # the kernel's cell mask: the 8x8 hint mask itself, or, for a
    # configured tile that is not whole 8x8 cells, a finer one (the JAX
    # package detects such grids per pixel with XLA ops). The window of a
    # tile made of whole cells (a hint tile, a stem tile, a configured
    # tile) is the union of its cells' windows, so its mask is the OR of
    # theirs
    th, tw = cfg.tile.tile_h, cfg.tile.tile_w
    c = flat4_ops.mask_cell(th, tw)
    with stage("detect"):
        storage, cell_mask, npix1 = stem_detect(x, state.in_cache, tau, g, c)
        cells = cell_mask > 0
        n_pix = npix1[0]
        hint_mask = _or_cells(cells, HINT_TILE // c, HINT_TILE // c)
        mask = _or_cells(cells, g.th // c, g.tw // c)
        fine_mask = _or_cells(cells, th // c, tw // c)
    g_hint = flat4_ops.cell_geometry(g)
    capacity = cfg.tile.capacity(g.n_tiles)
    with stage("compact"):
        comp = compact.compact_mask(mask, capacity)
    # past the capacity the kernel recomputes every tile: value-exact by
    # out_cache == f(in_cache), it only spends more compute
    overflow = comp.count > capacity
    with stage("patch_conv"):
        stem_conv(storage, comp.idx, comp.count, w, b, state.out_cache, g,
                  spec.activation, compute_dtype, capacity=capacity)
    # stats on the CONFIGURED tile grid: one (8, 32) kernel tile is
    # tile_scale fine tiles, so effective_flops prices the wider recompute
    n_fine = fine_mask.numel()
    tile_scale = n_fine // g.n_tiles
    stats = {
        "changed_tiles": fine_mask.sum(dtype=torch.int32),
        "computed_tiles": torch.where(overflow, g.n_tiles, comp.count)
        * tile_scale,
        "n_tiles": n_fine,
        "overflow": overflow,
        "changed_pixels": n_pix,
        "detect_tiles": cdiv(H, HINT_TILE) * cdiv(W, HINT_TILE),
    }
    return (Feature(state.out_cache, g.out_h, g.out_w, spec.features), state,
            stats, _out_hint(hint_mask, g_hint, overflow))


def _flat_stem_apply(state: CBLayerState, x: torch.Tensor, w, b,
                     g: TileGeometry, spec: ConvSpec, compute_dtype, tau):
    """``dense_cached`` on the flat (H, W*C) input cache: detect on the
    flat view (``detect.detect_and_update_flat``), then the dense conv of
    the accepted cache every frame. A stem: an incoming hint is not read
    (the JAX package's rule)."""
    if tau is None:
        tau = spec.threshold
    H, W, C = g.in_h, g.in_w, g.cin
    xf = x[:H, :W, :C].reshape(H, W * C)
    storage, changed = detect.detect_and_update_flat(
        xf, state.in_cache, tau, C, out=state.in_cache)
    mask = detect.changed_tile_mask(changed, g)
    _store_output(state, network.dense_conv(
        storage.view(H, W, C), w, b, spec, compute_dtype), g)
    stats = {
        "changed_tiles": mask.sum(dtype=torch.int32),
        "computed_tiles": g.n_tiles,
        "n_tiles": g.n_tiles,
        "overflow": False,
        "changed_pixels": changed.sum(dtype=torch.int32),
        "detect_tiles": cdiv(H, HINT_TILE) * cdiv(W, HINT_TILE),
    }
    return (Feature(state.out_cache, g.out_h, g.out_w, spec.features), state,
            stats, _out_hint(mask, g))


def _band_apply(state: CBLayerState, x: torch.Tensor, w, b, g: TileGeometry,
                spec: ConvSpec, cfg: PipelineConfig, compute_dtype, tau,
                hint: Optional[DirtyHint]):
    """The full-width row-band sparse conv: per-pixel detect, then only the
    dirty (th x out_w) output bands recomputed from the accepted cache
    (``delta_conv_jnp`` over band ids, since ``g.tiles_w == 1``), bounded
    by ``cfg.tile.capacity(bands)`` with the dense fallback past it. Three
    grids: the bands ``g``, the configured tile grid the stats are counted
    on (a band is one row of it), and the 8x8 hint grid, which carries the
    exact dilated change region (a band would dirty a whole row of hint
    tiles downstream)."""
    if tau is None:
        tau = spec.threshold
    with stage("detect"):
        storage, changed, n_pix, n_detect = _detect_xla(
            x, state.in_cache, tau, g, hint)
        band_mask = detect.changed_tile_mask(changed, g)
    capacity = cfg.tile.capacity(g.n_tiles)
    with stage("compact"):
        comp = compact.compact_mask(band_mask, capacity)
    with stage("band_conv"):
        overflow = _bounded_update(storage, comp, capacity, g,
                                   state.out_cache,
                                   *_bounded_conv_fns(w, b, g, spec,
                                                      compute_dtype))
    in_shape = (g.in_h, g.in_w, g.cin)
    g_hint = conv_tile_geometry(in_shape, spec.kernel, spec.stride,
                                spec.dilation, spec.padding, HINT_TILE,
                                HINT_TILE)
    g_fine = conv_tile_geometry(in_shape, spec.kernel, spec.stride,
                                spec.dilation, spec.padding,
                                cfg.tile.tile_h, cfg.tile.tile_w)
    bands = (comp.count if overflow is None
             else torch.where(overflow, g.n_tiles, comp.count))
    stats = {
        "changed_tiles": detect.changed_tile_mask(changed, g_fine).sum(
            dtype=torch.int32),
        "computed_tiles": bands * g_fine.tiles_w,
        "n_tiles": g_fine.n_tiles,
        "overflow": False if overflow is None else overflow,
        "changed_pixels": n_pix,
        "detect_tiles": n_detect,
    }
    return (Feature(state.out_cache, g.out_h, g.out_w, spec.features), state,
            stats, _out_hint(detect.changed_tile_mask(changed, g_hint),
                             g_hint, overflow))


def _full_stats(g: TileGeometry, tile_scale: int = 1) -> Dict[str, Any]:
    """Stats of a full (refresh) recompute, same keys as _run_gated's.
    Counters known on the host stay Python numbers: no device work.
    ``tile_scale``: the ``patch_stem`` and ``band_cached`` stems report in
    configured-grid tiles, several to one of their tiles."""
    return {
        "changed_tiles": g.n_tiles * tile_scale,
        "computed_tiles": g.n_tiles * tile_scale,
        "n_tiles": g.n_tiles * tile_scale,
        "overflow": False,
        "changed_pixels": g.in_h * g.in_w,
        "detect_tiles": cdiv(g.in_h, HINT_TILE) * cdiv(g.in_w, HINT_TILE),
    }


def _full_hint(g: TileGeometry, device) -> DirtyHint:
    return DirtyHint(mask=torch.ones(
        (cdiv(g.out_h, HINT_TILE), cdiv(g.out_w, HINT_TILE)),
        dtype=torch.bool, device=device))


def cb_conv_refresh(params, state: CBLayerState, x, spec: ConvSpec,
                    cfg: PipelineConfig):
    """Full refresh of a CB conv layer: accept the whole input into the
    cache and recompute the whole output with the dense conv (value-exact
    by the out_cache == f(in_cache) invariant; sums in another order than
    the tile kernel). Caches updated in place. Returns (y, state, stats,
    hint)."""
    cfg = _layer_cfg(spec, cfg)
    compute_dtype = network.torch_dtype(cfg.compute_dtype)
    x, w, b, g = _conv_prep(params, x, spec, cfg)
    x = x[:g.in_h, :g.in_w]
    if cfg.backend == "dense_cached_flat":
        state.in_cache.view(g.in_h, g.in_w, g.cin).copy_(x)
    else:  # a padded input cache keeps its zero channels
        storage_interior(state.in_cache, g)[..., :g.cin].copy_(x)
    y = network.dense_conv(x.to(compute_dtype), w, b, spec, compute_dtype)
    _store_output(state, y, g)
    tile_scale = 1
    if cfg.backend in ("patch_stem", "band_cached"):
        tile_scale = (cdiv(g.out_h, cfg.tile.tile_h)
                      * cdiv(g.out_w, cfg.tile.tile_w)) // g.n_tiles
    return (Feature(state.out_cache, g.out_h, g.out_w, spec.features), state,
            _full_stats(g, tile_scale), _full_hint(g, x.device))


def cb_pool_refresh(state: CBLayerState, x, spec: PoolSpec,
                    cfg: PipelineConfig):
    """Full refresh of a CB pool layer (see cb_conv_refresh). An elided
    input cache stays a placeholder; the padded storage is then transient."""
    cfg = _layer_cfg(spec, cfg)
    x, H, W, c = _unwrap(x)
    g = _geometry(spec, (H, W, state.out_cache.shape[-1]), cfg)
    if spec.elide_in_cache:
        storage = make_storage(g, 0.0, NEG_FILL, state.out_cache.dtype,
                               x.device)
        storage[..., c:] = 0
    else:
        storage = state.in_cache
    storage_interior(storage, g)[..., :c].copy_(x[:H, :W])
    state.out_cache.copy_(dense_pool(storage, g))
    return (Feature(state.out_cache, g.out_h, g.out_w, c), state,
            _full_stats(g), _full_hint(g, x.device))


def fused_pool_gate(spec: PoolSpec, g: TileGeometry,
                    cfg: PipelineConfig) -> bool:
    """STATIC eligibility of the hint-forwarded fused pool kernel. The JAX
    package's gate also asks for 128-lane channels, a Mosaic slicing rule
    with no counterpart on the card (the CUDA kernel takes any even C), so
    that condition is dropped; the rest — aligned window == stride ==
    (p, p), p >= 2, a pooled paired block of exactly 8 columns, 8x8 out
    tiles, a block grid that divides the map — is the kernel's contract."""
    if not (isinstance(spec, PoolSpec) and cfg.backend == "cuda"):
        return False
    p = spec.stride[0]
    return (spec.window == spec.stride == (p, p)
            and p >= 2 and HINT_TILE % p == 0
            and (2 * HINT_TILE // p) % 8 == 0
            and g.th == HINT_TILE and g.tw == HINT_TILE
            and g.in_w % (2 * HINT_TILE) == 0
            and g.in_h % HINT_TILE == 0)


def cb_pool_apply(state: CBLayerState, x, spec: PoolSpec,
                  cfg: PipelineConfig, tau=None,
                  hint: Optional[DirtyHint] = None):
    """One frame through a change-based max-pool layer. Returns
    (y: Feature, state, stats, out_hint)."""
    cfg = _layer_cfg(spec, cfg)
    c_store = state.out_cache.shape[-1]  # the input storage's width
    x, H, W, c = (_unwrap_stored(x, c_store) if cfg.backend == "cuda"
                  else _unwrap(x))
    g = _geometry(spec, (H, W, c_store), cfg)
    if (spec.forward_hint and hint is not None
            and fused_pool_gate(spec, g, cfg)):
        # forward-hint mode: one fused kernel over the producer's dirty
        # blocks, no detection, tau unused. Hint tiles pair up in W into
        # 8x16 blocks, as in the JAX package: the values would not change
        # without it, the stats would
        hm = hint.mask
        pair = hm[:, 0::2] | hm[:, 1::2]
        dcomp = compact.compact_mask(pair, pair.numel())
        x = _to_width(x, c_store, H, W)
        _, maskf = detect_pool_fused(x, state.out_cache, dcomp.idx,
                                     dcomp.count, g, hint_h=HINT_TILE,
                                     hint_w=2 * HINT_TILE)
        mask = maskf > 0.5
        touched = mask.sum(dtype=torch.int32)
        stats = {
            "changed_tiles": touched,
            "computed_tiles": touched,
            "n_tiles": g.n_tiles,
            "overflow": False,
            # visited = hinted area, in 8x8 hint-tile units (2 per block)
            "changed_pixels": dcomp.count * (2 * HINT_TILE * HINT_TILE),
            "detect_tiles": dcomp.count * 2,
        }
        return (Feature(state.out_cache, g.out_h, g.out_w, c), state, stats,
                _out_hint(mask, g))

    if spec.elide_in_cache:
        # the converter only sets this when the fused gate above provably
        # holds and the producer always hints: the input cache here is a
        # (1, 1, 1) placeholder and cannot serve detection
        raise AssertionError(
            "elide_in_cache pool fell through the fused gate "
            f"(hint={'present' if hint is not None else 'MISSING'}, "
            f"backend={cfg.backend}); rebuild via the flagship converter")

    def tile_fn(storage, idx, count, out_cache):
        if cfg.backend == "torch":
            delta_pool_jnp(storage, idx, out_cache, g)
        else:
            delta_pool(storage, idx, out_cache, g, count=count)

    def dense_fn(storage):
        return dense_pool(storage, g)

    state, stats, out_hint = _run_gated(spec, state, x, g, cfg, tile_fn, tau,
                                        hint, dense_fn=dense_fn)
    return (Feature(state.out_cache, g.out_h, g.out_w, c), state, stats,
            out_hint)
