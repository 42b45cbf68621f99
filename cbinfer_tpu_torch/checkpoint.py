"""Weights and state for the port: the ``w{i}``/``b{i}`` npz format of the
JAX package's ``checkpoint.load_npz_params`` and the ``w:{node}``/
``b:{node}`` one of its DAG nets, the carry-across from numpy HWIO
parameters (what ``cbinfer_tpu`` holds, as numpy arrays) to the port's
tensors, a mid-video checkpoint of params plus the per-layer caches
(``save`` / ``restore``, so a stream resumes without a cold start), and the
tuner's threshold files in the JAX package's JSON format."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ConvSpec
from .layers import CBLayerState
from .network import resolve_device, torch_dtype


def _tensor_pair(w, b, dev, dtype):
    """numpy ``(w, b)`` -> ``w`` in ``dtype``, ``b`` float32, on ``dev``."""
    w = torch.from_numpy(np.asarray(w, np.float32).copy())
    bt = None
    if b is not None:
        bt = torch.from_numpy(np.asarray(b, np.float32).copy()).to(dev)
    return w.to(dev, dtype), bt


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
        shape = np.shape(w)
        if shape[:2] != tuple(spec.kernel) or shape[3] != spec.features:
            raise ValueError(f"weight {shape} does not match {spec}")
        out.append(_tensor_pair(w, b, dev, dtype))
    return out


def graph_params_from_numpy(nodes: Sequence, params_np: Dict[str, Any],
                            device="cuda", dtype=torch.float32
                            ) -> Dict[str, Any]:
    """The DAG twin of ``params_from_numpy``: numpy HWIO ``(w, b)`` by conv
    node name (what ``cbinfer_tpu.graph.init_graph_params`` returns, as
    numpy arrays) -> the port's params dict, ``w`` in ``dtype`` and ``b``
    float32 on ``device``. Raises on a missing conv node or a weight that
    does not fit its node's spec."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    out: Dict[str, Any] = {}
    for n in nodes:
        if not isinstance(n.spec, ConvSpec):
            continue
        if n.name not in params_np:
            raise ValueError(f"no params for conv node {n.name!r}")
        w, b = params_np[n.name]
        shape = np.shape(w)
        if shape[:2] != tuple(n.spec.kernel) or shape[3] != n.spec.features:
            raise ValueError(f"weight {shape} of node {n.name!r} does not "
                             f"match {n.spec}")
        out[n.name] = _tensor_pair(w, b, dev, dtype)
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


def save_npz_graph_params(path: str, params: Dict[str, Any]) -> None:
    """Flat npz of a DAG's params dict, keys ``w:{node}`` / ``b:{node}``
    (the JAX package's format; float32 numpy arrays)."""
    flat = {}
    for name, (w, b) in params.items():
        flat[f"w:{name}"] = w.detach().float().cpu().numpy()
        if b is not None:
            flat[f"b:{name}"] = b.detach().float().cpu().numpy()
    np.savez(path, **flat)


def load_npz_graph_params(path: str, params_like: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """Load a ``w:{node}``/``b:{node}`` npz into a params dict shaped like
    ``params_like`` (the port's graph params; their device and weight dtype
    are kept). Raises, naming the file, on a missing node, a missing or
    extra bias, and a shape mismatch, like the JAX package's loader."""
    flat = np.load(path)
    out: Dict[str, Any] = {}
    for name, p in params_like.items():
        if p is None:
            out[name] = None
            continue
        if f"w:{name}" not in flat:
            raise ValueError(f"{path}: missing w:{name} (checkpoint from "
                             "a different topology?)")
        w = flat[f"w:{name}"]
        if tuple(w.shape) != tuple(p[0].shape):
            raise ValueError(
                f"{path}: w:{name} shape {w.shape} != model shape "
                f"{tuple(p[0].shape)} (checkpoint trained at a different "
                "width?)")
        b = None
        if f"b:{name}" in flat:
            if p[1] is None:
                raise ValueError(f"{path}: b:{name} present for a "
                                 "bias-free node")
            b = flat[f"b:{name}"]
            if tuple(b.shape) != tuple(p[1].shape):
                raise ValueError(f"{path}: b:{name} shape {b.shape} != "
                                 f"model shape {tuple(p[1].shape)}")
        elif p[1] is not None:
            raise ValueError(f"{path}: missing b:{name} for a node with "
                             "bias")
        out[name] = _tensor_pair(w, b, p[0].device, p[0].dtype)
    return out


def _plain(tree):
    """A state or params tree with every ``CBLayerState`` as a dict of its
    tensors: what ``torch.load(weights_only=True)`` reads back."""
    if isinstance(tree, CBLayerState):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _like(saved, like, in_place: bool):
    """``saved`` (plain, as loaded) in the structure of ``like``: a
    ``CBLayerState`` where ``like`` has one; with ``in_place`` every tensor
    is copied into ``like``'s and ``like``'s objects are returned."""
    if isinstance(like, torch.Tensor):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint tensor {tuple(saved.shape)} != "
                             f"{tuple(like.shape)}")
        if in_place:
            return like.copy_(saved)
        return saved.to(like.device, like.dtype)
    if isinstance(like, CBLayerState):
        fields = {f.name: _like(saved[f.name], getattr(like, f.name),
                                in_place)
                  for f in dataclasses.fields(like)}
        return like if in_place else CBLayerState(**fields)
    if isinstance(like, (list, tuple)):
        if len(saved) != len(like):
            raise ValueError(f"checkpoint holds {len(saved)} entries where "
                             f"{len(like)} are expected")
        out = type(like)(_like(s, v, in_place) for s, v in zip(saved, like))
        return like if in_place else out
    if isinstance(like, dict):
        out = {k: _like(saved[k], v, in_place) for k, v in like.items()}
        return like if in_place else out
    return saved


def save(path: str, params: Any, state: Optional[Any] = None,
         extra: Optional[dict] = None) -> None:
    """Save params (+ optional streaming state, + an ``extra`` dict of
    plain values, e.g. the stream's frame position) to the file ``path``
    with ``torch.save``: a stream resumes mid-video from it."""
    ckpt = {"params": _plain(params)}
    if state is not None:
        ckpt["state"] = _plain(state)
    if extra is not None:
        ckpt["extra"] = extra
    torch.save(ckpt, path)


def restore(path: str, like: Optional[dict] = None,
            in_place: bool = False) -> dict:
    """Restore a checkpoint dict ({'params', 'state'?, 'extra'?}) written
    by ``save``, through ``torch.load(weights_only=True)``.

    Without ``like`` the caches come back as plain dicts of tensors on the
    CPU (a checkpoint saved on the card loads anywhere). Pass ``like``
    (e.g. {'params': params, 'state': net.init_state()}) to get its
    structure back (``CBLayerState`` caches) on its tensors' devices and
    dtypes; shapes must match. ``in_place=True`` copies into ``like``'s
    tensors instead of making new ones, so a ``FrameStepper``'s captured
    graphs stay valid (``like={'state': stepper.state}``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if like is None:
        return ckpt
    out = dict(ckpt)
    for k, v in like.items():
        if k not in ckpt:
            raise KeyError(f"{path}: no {k!r} in the checkpoint")
        out[k] = _like(ckpt[k], v, in_place)
    return out


def save_thresholds(path: str, thresholds, metadata: Optional[dict] = None):
    """Persist a tuner result's tau vector as plain JSON (the JAX
    package's format, byte for byte)."""
    with open(path, "w") as f:
        json.dump({"thresholds": [float(t) for t in thresholds],
                   "metadata": metadata or {}}, f, indent=2)


def load_thresholds(path: str):
    with open(path) as f:
        d = json.load(f)
    return d["thresholds"]
