"""Weights for the port: the ``w{i}``/``b{i}`` npz format of the JAX
package's ``checkpoint.load_npz_params``, and the carry-across from numpy
HWIO parameters (what ``cbinfer_tpu`` holds, as numpy arrays) to the port's
tensors."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ConvSpec
from .network import resolve_device, torch_dtype


def params_from_numpy(specs: Sequence, params_np: Sequence, device="cuda",
                      dtype=torch.float32) -> List:
    """numpy HWIO ``(w, b)`` per conv layer (``None`` elsewhere) -> the
    port's params: ``w`` HWIO in ``dtype``, ``b`` float32 (the kernels add
    the bias in float32, as the JAX package's Pallas kernels do), both on
    ``device``. Pass the compute dtype as ``dtype`` so no per-frame cast is
    needed."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    out: List[Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]] = []
    for spec, p in zip(specs, params_np):
        if not isinstance(spec, ConvSpec):
            out.append(None)
            continue
        w, b = p
        w = torch.from_numpy(np.asarray(w, np.float32).copy())
        if w.shape[:2] != tuple(spec.kernel) or w.shape[3] != spec.features:
            raise ValueError(f"weight {tuple(w.shape)} does not match {spec}")
        bt = None
        if b is not None:
            bt = torch.from_numpy(np.asarray(b, np.float32).copy()).to(dev)
        out.append((w.to(dev, dtype), bt))
    return out


def load_npz_params(path: str, params_like: Sequence, specs: Sequence
                    ) -> List:
    """Load a flat ``w{i}``/``b{i}`` npz into a params list shaped like
    ``params_like`` (the port's params; their device and weight dtype are
    kept). Raises on missing keys and on shape mismatch, like the JAX
    package's loader."""
    flat = np.load(path)
    params_np = []
    device = dtype = None
    for i, p in enumerate(params_like):
        if p is None:
            params_np.append(None)
            continue
        device, dtype = p[0].device, p[0].dtype
        w = flat[f"w{i}"]
        if tuple(w.shape) != tuple(p[0].shape):
            raise ValueError(
                f"{path}: w{i} shape {w.shape} != model shape "
                f"{tuple(p[0].shape)} (checkpoint trained at a different "
                "width/architecture?)")
        b = None
        if f"b{i}" in flat:
            if p[1] is None:
                raise ValueError(f"{path}: b{i} present for a BIAS-FREE "
                                 "layer")
            b = flat[f"b{i}"]
            if tuple(b.shape) != tuple(p[1].shape):
                raise ValueError(f"{path}: b{i} shape {b.shape} != model "
                                 f"shape {tuple(p[1].shape)}")
        elif p[1] is not None:
            raise ValueError(f"{path}: missing b{i} for a layer with bias")
        params_np.append((w, b))
    if device is None:
        return list(params_like)
    return params_from_numpy(specs, params_np, device, dtype)
