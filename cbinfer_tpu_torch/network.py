"""Sequential network IR utilities + dense baseline path (PyTorch port of
``cbinfer_tpu.network``).

A network is a tuple of LayerSpecs plus a params list (one entry per
layer: ``(w, b)`` torch tensors for a conv, ``None`` otherwise). Weights
stay HWIO and activations HWC, as in the JAX package. The dense ops here
are what the JAX package leaves to XLA, so they use ``F.conv2d``,
``F.max_pool2d`` and ``torch.matmul``.

Float32 reference numerics: TF32 is switched OFF for both cuDNN
convolutions and CUDA matmuls when this module is imported (PyTorch's
default runs float32 convolutions in TF32, which keeps ~3 decimal digits).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ConvSpec, PipelineConfig, PoolSpec, UpsampleSpec
from .ops.geometry import conv_out_size, pad_dim, same_pads

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def resolve_device(device) -> torch.device:
    """The entry points' device argument: the card unless the caller asks
    for the CPU. Raises when CUDA is asked for and absent — the port never
    carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cbinfer_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False (pass device='cpu' to run "
            "the plain PyTorch versions)")
    return dev


def init_params(specs: Sequence, in_shape: Tuple[int, int, int],
                seed: int = 0, device="cuda",
                dtype=torch.float32) -> List:
    """He-normal conv weights (numpy generator from ``seed``), zero
    biases; shapes follow the spec chain. The values differ from the JAX
    package's ``init_params`` (another generator); carry those across with
    ``checkpoint.params_from_numpy`` when parity is needed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = []
    c = in_shape[2]
    for spec in specs:
        if isinstance(spec, ConvSpec):
            kh, kw = spec.kernel
            w = (rng.standard_normal((kh, kw, c, spec.features))
                 * math.sqrt(2.0 / (kh * kw * c))).astype(np.float32)
            b = (torch.zeros((spec.features,), dtype=torch.float32,
                             device=dev) if spec.use_bias else None)
            params.append((torch.from_numpy(w).to(dev, dtype), b))
            c = spec.features
        else:
            params.append(None)
    return params


def out_shapes(specs: Sequence, in_shape: Tuple[int, int, int]
               ) -> List[Tuple[int, int, int]]:
    """Static shape chain: shape of each layer's OUTPUT."""
    shapes = []
    h, w, c = in_shape
    for spec in specs:
        if isinstance(spec, ConvSpec):
            h = conv_out_size(h, spec.kernel[0], spec.stride[0],
                              spec.dilation[0], pad_dim(spec.padding, 0))
            w = conv_out_size(w, spec.kernel[1], spec.stride[1],
                              spec.dilation[1], pad_dim(spec.padding, 1))
            c = spec.features
        elif isinstance(spec, PoolSpec):
            h = conv_out_size(h, spec.window[0], spec.stride[0], 1,
                              pad_dim(spec.padding, 0))
            w = conv_out_size(w, spec.window[1], spec.stride[1], 1,
                              pad_dim(spec.padding, 1))
        elif isinstance(spec, UpsampleSpec):
            h, w = h * spec.scale[0], w * spec.scale[1]
        else:
            raise TypeError(spec)
        shapes.append((h, w, c))
    return shapes


def _activate(y: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    return torch.relu_(y) if spec.activation == "relu" else y


def pointwise_dot_conv(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor], spec: ConvSpec,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """1x1 stride-1 conv as (H*W, cin) @ (cin, cout) + bias."""
    dtype = torch_dtype(compute_dtype)
    assert spec.kernel == (1, 1) and spec.stride == (1, 1) \
        and spec.dilation == (1, 1)
    H, W, cin = x.shape
    cout = w.shape[3]
    return _activate(_matmul_bias(x.reshape(H * W, cin).to(dtype),
                                  w.reshape(cin, cout).to(dtype), b, dtype),
                     spec).reshape(H, W, cout)


def _matmul_bias(a, w, b, dtype, out=None):
    """a @ w (+ b, added in the product's float32 epilogue), into ``out``
    when given."""
    if b is None:
        return torch.matmul(a, w, out=out)
    return torch.addmm(b.to(dtype), a, w, out=out)


def use_im2col(spec: ConvSpec, cin: int) -> bool:
    """Small-cin stems (cin*k^2 <= 64, stride 1, SAME) run as one im2col
    matmul, as in the JAX package."""
    kh, kw = spec.kernel
    return (cin * kh * kw <= 64 and spec.stride == (1, 1)
            and spec.dilation == (1, 1) and spec.padding == "SAME")


def im2col_conv(xp: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                spec: ConvSpec, compute_dtype=torch.float32,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 conv of an ALREADY zero-padded HWC input ``xp``
    ((H + kh - 1, W + kw - 1, cin), a view is fine) as one
    (H*W, kh*kw*cin) @ (kh*kw*cin, cout) matmul, written into ``out`` (a
    contiguous (H, W, cout) tensor in the compute dtype) when given."""
    dtype = torch_dtype(compute_dtype)
    kh, kw = spec.kernel
    cin, cout = w.shape[2], w.shape[3]
    H, W = xp.shape[0] - kh + 1, xp.shape[1] - kw + 1
    xp = xp.to(dtype)
    patches = torch.cat([xp[dy:dy + H, dx:dx + W] for dy in range(kh)
                         for dx in range(kw)], dim=-1)
    y = _matmul_bias(patches.reshape(H * W, kh * kw * cin),
                     w.to(dtype).reshape(kh * kw * cin, cout), b, dtype,
                     out=None if out is None else out.view(H * W, cout))
    return _activate(y, spec).reshape(H, W, cout)


def dense_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               spec: ConvSpec, compute_dtype=torch.float32) -> torch.Tensor:
    """Dense conv of one HWC frame, output HWC in the compute dtype.

    Small-cin stems go through ``im2col_conv``; everything else through
    ``F.conv2d`` in channels-last layout (the HWC tensor permuted to NCHW
    is channels-last in memory, the weights are made so), whose output
    permuted back is a contiguous HWC tensor. The bias is added in the
    conv's float32 epilogue (the JAX package adds it after rounding to the
    compute dtype: at most one rounding apart)."""
    dtype = torch_dtype(compute_dtype)
    kh, kw = spec.kernel
    H, W, _ = x.shape
    if use_im2col(spec, w.shape[2]):
        plo_h, phi_h = (kh - 1) // 2, kh // 2
        plo_w, phi_w = (kw - 1) // 2, kw // 2
        xp = F.pad(x.to(dtype), (0, 0, plo_w, phi_w, plo_h, phi_h))
        return im2col_conv(xp, w, b, spec, dtype)
    if spec.padding == "SAME":
        ph = same_pads(H, kh, spec.stride[0], spec.dilation[0])
        pw = same_pads(W, kw, spec.stride[1], spec.dilation[1])
    elif spec.padding == "VALID":
        ph = pw = (0, 0)
    else:
        ph = (spec.padding[0],) * 2
        pw = (spec.padding[1],) * 2
    xn = x.to(dtype).permute(2, 0, 1)[None]
    pad = (ph[0], pw[0])
    if ph[0] != ph[1] or pw[0] != pw[1]:  # asymmetric SAME: pad by hand
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1])).contiguous(
            memory_format=torch.channels_last)
        pad = (0, 0)
    wn = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(xn, wn, None if b is None else b.to(dtype),
                 stride=spec.stride, padding=pad, dilation=spec.dilation)
    return _activate(y[0].permute(1, 2, 0), spec)


def dense_pool(x: torch.Tensor, spec: PoolSpec) -> torch.Tensor:
    """Max pool of one HWC frame: VALID, SAME or explicit symmetric
    padding, every pad -inf (the reference's ``lax.reduce_window`` with a
    -inf init). SAME pads as XLA does, the odd pixel of an even total at
    the end, so it is padded by hand: ``F.max_pool2d`` pads symmetrically
    only. An aligned VALID pool is one reduction over a free reshape."""
    (kh, kw), (sh, sw) = spec.window, spec.stride
    H, W, C = x.shape
    if spec.padding == "VALID" and (kh, kw) == (sh, sw):
        Ho, Wo = H // kh, W // kw
        return x[:Ho * kh, :Wo * kw].reshape(Ho, kh, Wo, kw, C).amax(
            dim=(1, 3))
    xn = x.permute(2, 0, 1)[None]
    pad = (0, 0)
    if spec.padding == "SAME":
        ph, pw = same_pads(H, kh, sh, 1), same_pads(W, kw, sw, 1)
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    elif spec.padding != "VALID":
        pad = tuple(spec.padding)
    y = F.max_pool2d(xn, kernel_size=spec.window, stride=spec.stride,
                     padding=pad)
    return y[0].permute(1, 2, 0)


def upsample(x: torch.Tensor, spec: UpsampleSpec) -> torch.Tensor:
    """Nearest or bilinear upsampling of one HWC frame by an integer
    scale. Bilinear is the reference's ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, and at the border the one input
    pixel in reach takes the whole weight, which is
    ``F.interpolate(align_corners=False)``'s clamp of the source index."""
    if spec.method == "nearest":
        return x.repeat_interleave(spec.scale[0], 0).repeat_interleave(
            spec.scale[1], 1)
    h, w, _ = x.shape
    y = F.interpolate(x.permute(2, 0, 1)[None],
                      size=(h * spec.scale[0], w * spec.scale[1]),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous()


def dense_apply(specs: Sequence, params: Sequence, x: torch.Tensor,
                cfg: Optional[PipelineConfig] = None) -> torch.Tensor:
    """Full dense forward of one HWC frame (the baseline path)."""
    dtype = torch_dtype(cfg.compute_dtype) if cfg else torch.float32
    for spec, p in zip(specs, params):
        if isinstance(spec, ConvSpec):
            x = dense_conv(x, p[0], p[1], spec, dtype)
        elif isinstance(spec, PoolSpec):
            x = dense_pool(x, spec)
        elif isinstance(spec, UpsampleSpec):
            x = upsample(x, spec)
        else:
            raise TypeError(spec)
    return x


def dense_flops(specs: Sequence, in_shape: Tuple[int, int, int]) -> int:
    """MAC*2 count of the dense forward (conv layers only)."""
    total = 0
    h, w, c = in_shape
    for spec, shape in zip(specs, out_shapes(specs, in_shape)):
        if isinstance(spec, ConvSpec):
            kh, kw = spec.kernel
            total += 2 * shape[0] * shape[1] * spec.features * kh * kw * c
        h, w, c = shape
    return total
