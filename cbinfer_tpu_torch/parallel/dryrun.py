"""Multi-stream dry run, the port's twin of the JAX package's
``__graft_entry__.dryrun_multichip``: one stream per device of an
``n_devices`` mesh, three sub-runs, each asserting the output shapes and
that frame 0, a cold start, computes every tile.

  1. the scene flagship (w32, 32x64, 4x4 tiles) with the JAX package's
     plain-backend stem (``dense_cached``), one frame per stream through
     ``net.apply`` on the stream's device: the twin of its vmapped apply;
  2. the exact flagship (the sparse ``patch_stem`` stem, the kernel path,
     8x8 tiles) through ``MultiStreamRunner.run_clip``, two frames per
     stream;
  3. the OpenPose DAG ``pose_graph`` (w8, 32x64, 4x4 tiles) through the
     same runner.

The tiles and sizes are the JAX package's dry run's: on the card the
4x4 tiles run the stem detect at cells of 4 and the pools re-detecting,
and the DAG's three pools leave maps of 4x8, which the sparse detect takes
as partial hint tiles.

    python -c "from cbinfer_tpu_torch.parallel import dryrun_multistream as d; d(1)"

(``d(8, device="cpu")`` runs it on the CPU with the plain versions.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import PipelineConfig, TileConfig
from ..convert import convert_flagship
from ..graph import convert_graph_flagship, init_graph_params
from ..models import get_model
from ..models.pose import pose_graph
from ..network import init_params
from .streams import (MultiStreamRunner, make_stream_mesh, on_device,
                      shard_streams, stream_state)

H, W = 32, 64


def pipeline_config(device, tile: int = 8) -> PipelineConfig:
    """The sub-runs' pipeline: ``tile`` x ``tile`` tiles, capacity 0.5,
    bf16 on the card (float32 on the CPU), on ``device``."""
    dtype = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    return PipelineConfig(tile=TileConfig(tile, tile, 0.5),
                          compute_dtype=dtype, cache_dtype=dtype,
                          device=str(device))


def _first_cb(stats):
    return next(s for s in (stats.values() if isinstance(stats, dict)
                            else stats) if s)


def _cold_start(stats, what: str) -> None:
    """Frame 0 of every stream computed every tile (stats leaves (T, S))."""
    s0 = _first_cb(stats)
    computed, n_tiles = s0["computed_tiles"][0], s0["n_tiles"][0]
    if not torch.equal(computed, n_tiles):
        raise AssertionError(f"{what}: frame 0 computed {computed.tolist()} "
                             f"of {n_tiles.tolist()} tiles")


def dryrun_multistream(n_devices: int, device="cuda") -> Dict[str, tuple]:
    """Run the three sub-runs on ``n_devices`` streams over the first
    ``n_devices`` devices of ``device``'s kind (raises if the machine has
    fewer); returns each sub-run's output shape."""
    mesh = make_stream_mesh(n_devices, device)
    cfg, cfg4 = pipeline_config(mesh[0]), pipeline_config(mesh[0], 4)
    dtype = torch.bfloat16 if mesh[0].type == "cuda" else torch.float32
    streams = len(mesh)
    specs = get_model("scene", num_classes=8, width=32)
    params = init_params(specs, (H, W, 3), 0, mesh[0], dtype)
    shapes = {}

    # 1: the plain-backend stem, one frame per stream through net.apply
    net = convert_flagship(specs, (H, W, 3), cfg4,
                           extra_overrides={0: "dense_cached"})
    replicas = shard_streams(mesh, params, batched=False)
    x = np.random.default_rng(0).random((streams, H, W, 3), np.float32)
    ys = []
    for s, dev in enumerate(mesh):
        with on_device(dev):
            y, _, stats = net.apply(replicas[s], stream_state(net, dev),
                                    torch.from_numpy(x[s]).to(dev))
        s0 = _first_cb(stats)
        if int(s0["computed_tiles"]) != int(s0["n_tiles"]):
            raise AssertionError(f"plain stem, stream {s}: frame 0 computed "
                                 f"{int(s0['computed_tiles'])} of "
                                 f"{int(s0['n_tiles'])} tiles")
        ys.append(y.to(mesh[0]))
    y = torch.stack(ys)
    if y.shape[0] != streams:
        raise AssertionError(f"plain stem: y {tuple(y.shape)}")
    shapes["plain_stem"] = tuple(y.shape)
    print(f"dryrun_multistream OK (plain stem): {streams} streams over "
          f"{n_devices} devices, y.shape={tuple(y.shape)}")

    # 2: the kernel path through the runner
    netk = convert_flagship(specs, (H, W, 3), cfg)
    clip = np.random.default_rng(1).random((streams, 2, H, W, 3), np.float32)
    runner = MultiStreamRunner(netk, params, n_streams=streams, mesh=mesh)
    ys, stats = runner.run_clip(clip)
    if tuple(ys.shape[:2]) != (streams, 2):
        raise AssertionError(f"kernel path: ys {tuple(ys.shape)}")
    _cold_start(stats, "kernel path")
    shapes["kernel_path"] = tuple(ys.shape)
    print(f"dryrun_multistream OK (kernel path): {streams} streams, "
          f"y.shape={tuple(ys.shape)}")

    # 3: the concat DAG through the same runner
    nodes, out = pose_graph(width=8)
    netg = convert_graph_flagship(nodes, (H, W, 3), cfg4, output=out)
    paramsg = init_graph_params(nodes, (H, W, 3), 2, mesh[0], dtype)
    runner_g = MultiStreamRunner(netg, paramsg, n_streams=streams, mesh=mesh)
    ysg, statsg = runner_g.run_clip(clip)
    if tuple(ysg.shape[:2]) != (streams, 2):
        raise AssertionError(f"pose_graph: ys {tuple(ysg.shape)}")
    _cold_start(statsg, "pose_graph")
    shapes["pose_graph"] = tuple(ysg.shape)
    print(f"dryrun_multistream OK (pose_graph DAG): {streams} streams, "
          f"y.shape={tuple(ysg.shape)}")
    print(f"dryrun_multistream OK: {streams} streams over {n_devices} "
          f"devices, 3 sub-runs (plain stem, kernel path, pose_graph DAG)")
    return shapes

