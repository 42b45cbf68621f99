"""A configuration's net as nodes, and each node's function, in plain
PyTorch.

A configuration gives its net either as ``layers`` (a chain: layer i
reads layer i - 1, the first the frame; weights ``w{i}``, ``b{i}``) or as
``nodes`` (a DAG in topological order: each node names its ``inputs``,
``"input"`` being the frame; weights ``w:{name}``, ``b:{name}``). Both
come out of ``nodes_of`` as one list of node dicts with the keys
``name``, ``inputs``, ``kind`` (``conv``, ``pool`` or ``concat``),
``kernel``, ``dilation``, ``features``, ``activation``, ``window``,
``cb``, ``forward``, ``stem``, ``kernels``, ``wkey`` and ``bkey``.

Convs are stride 1 with SAME padding (the low pad of an odd kernel's
``(k - 1) * dilation``, the same on both sides), pools are VALID max pools
whose stride is their window, a concat joins its inputs along channels.
Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

def _node(d: dict, name: str, inputs, wkey: str, bkey: str) -> dict:
    n = {"name": name, "inputs": list(inputs), "wkey": wkey, "bkey": bkey,
         "kind": d["kind"], "kernel": int(d.get("kernel", 1)),
         "dilation": int(d.get("dilation", 1)),
         "features": d.get("features"), "activation": d.get("activation"),
         "window": int(d.get("window", 1)), "cb": bool(d.get("cb", False)),
         "forward": bool(d.get("forward", False)),
         "stem": bool(d.get("stem", False)),
         "kernels": list(d.get("kernels", []))}
    if n["kind"] not in ("conv", "pool", "concat"):
        raise ValueError(f"node {name!r}: unknown kind {n['kind']!r}")
    if n["kind"] == "conv" and n["kernel"] % 2 == 0:
        raise ValueError(f"node {name!r}: SAME needs an odd kernel")
    return n


def nodes_of(config: dict) -> List[dict]:
    """The configuration's net as nodes in topological order."""
    if ("layers" in config) == ("nodes" in config):
        raise ValueError("a configuration gives either layers or nodes")
    if "layers" in config:
        return [_node(d, str(i), [str(i - 1) if i else "input"], f"w{i}",
                      f"b{i}") for i, d in enumerate(config["layers"])]
    out, seen = [], {"input"}
    for d in config["nodes"]:
        name = d["name"]
        if name in seen or not set(d["inputs"]) <= seen:
            raise ValueError(f"node {name!r}: a repeated name or an input "
                             "that comes later")
        out.append(_node(d, name, d["inputs"], f"w:{name}", f"b:{name}"))
        seen.add(name)
    return out


def output_name(config: dict, nodes: List[dict]) -> str:
    return config.get("output_node", nodes[-1]["name"])


def shapes(nodes: List[dict], in_shape) -> Dict[str, Tuple[int, int, int]]:
    """Logical (H, W, C) of every node's output, and of ``"input"``."""
    out = {"input": tuple(int(v) for v in in_shape)}
    for n in nodes:
        h, w, c = out[n["inputs"][0]]
        if n["kind"] == "concat":
            c = sum(out[i][2] for i in n["inputs"])
        elif n["kind"] == "conv":
            c = int(n["features"])
        else:
            h, w = h // n["window"], w // n["window"]
        out[n["name"]] = (h, w, c)
    return out


def fused_consumers(nodes: List[dict]) -> Dict[str, str]:
    """producer -> consumer of each conv that lists ``B6`` (the tile conv
    that runs its consumer's detect): the first later CB conv that reads
    the producer alone and detects (not a forward layer)."""
    out = {}
    for i, n in enumerate(nodes):
        if "B6" not in n["kernels"]:
            continue
        for c in nodes[i + 1:]:
            if (c["inputs"] == [n["name"]] and c["kind"] == "conv"
                    and c["cb"] and not c["forward"]):
                out[n["name"]] = c["name"]
                break
        else:
            raise ValueError(f"node {n['name']!r} lists B6 but no CB conv "
                             "reads it alone")
    return out


def conv_weights(node: dict, weights, q, device):
    """(w as OIHW float32 rounded by ``q``, bias float32) of a conv node
    from the numpy HWIO weights."""
    import numpy as np
    w = torch.from_numpy(np.asarray(weights[node["wkey"]], np.float32))
    b = weights.get(node["bkey"])
    w = q(w.to(device)).permute(3, 2, 0, 1).contiguous()
    if b is not None:
        b = torch.from_numpy(np.asarray(b, np.float32)).to(device)
    return w, b


def apply(node: dict, x: torch.Tensor, params: Optional[tuple] = None
          ) -> torch.Tensor:
    """A conv or pool node's function of a (C, H, W) float32 input (a
    concat's inputs are joined by the caller)."""
    if node["kind"] == "pool":
        k = node["window"]
        return F.max_pool2d(x[None], k, k)[0]
    w, b = params
    d = node["dilation"]
    y = F.conv2d(x[None], w, b, padding=(node["kernel"] - 1) * d // 2,
                 dilation=d)[0]
    if node["activation"] == "relu":
        y = torch.relu(y)
    return y


def out_changed(d: torch.Tensor, node: dict) -> torch.Tensor:
    """Output pixels whose window holds a changed input pixel."""
    m = d.float()[None, None]
    if node["kind"] == "pool":
        k = node["window"]
        return F.max_pool2d(m, k, k)[0, 0] > 0
    k, dil = node["kernel"], node["dilation"]
    ones = torch.ones((1, 1, k, k), device=d.device)
    return F.conv2d(m, ones, padding=(k - 1) * dil // 2,
                    dilation=dil)[0, 0] > 0
