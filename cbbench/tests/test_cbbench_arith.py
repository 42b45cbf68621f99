"""The frozen arithmetic, the frames and the trace binning, on the CPU."""

import math

import pytest
import torch

from cbbench import costs, frames, spec, trace


def _dense_flops(cfg):
    h, w, c = cfg["in_shape"]
    total = 0
    for layer in cfg["layers"]:
        if layer["kind"] == "pool":
            h, w = h // layer["window"], w // layer["window"]
            continue
        total += h * w * costs.flops_per_pixel(layer["kernel"], c,
                                               layer["features"])
        c = layer["features"]
    return total


def test_scene_dense_work_is_278_gflop_a_frame():
    cfg = spec.config("scene_w128")
    assert _dense_flops(cfg) / 1e9 == pytest.approx(278.4, abs=0.05)
    assert cfg["dense_gflop_per_frame"] == pytest.approx(
        _dense_flops(cfg) / 1e9, abs=0.05)


def test_bound_of_one_tile_conv_launch_by_hand():
    # 10 tiles of 8x8 outputs of a 3x3 conv, 256 -> 256 channels, bf16;
    # the tiles in a row, so their windows cover 10 rows of (80 + 2) px
    fl = 10 * 64 * costs.flops_per_pixel(3, 256, 256)
    assert fl == 10 * 64 * 2 * 9 * 256 * 256
    tiles = torch.zeros((4, 16), dtype=torch.bool)
    tiles[1, 2:12] = True
    px = costs.tiles_to_pixels(tiles, 8, 8, 32, 128)
    cover = int(costs.window_cover(px, 3, 1, 1, 32, 128))
    assert cover == 10 * 82
    nbytes = costs.b2_delta_conv(cover, 256, 640, 256, 2, 9 * 256 * 256, 10)
    assert nbytes == 820 * 512 + 640 * 512 + 9 * 256 * 256 * 2 + 1024 + 40
    # operations bound it: 7.55e9 flops / 989e12 against 1.93e6 bytes
    assert costs.bound_s(fl, nbytes) == pytest.approx(fl / 989e12)
    assert costs.bound_s(0.0, nbytes) == pytest.approx(nbytes / 3.35e12)
    t = costs.bound_s(torch.tensor(float(fl)), torch.tensor(float(nbytes)))
    assert float(t) == pytest.approx(fl / 989e12)


def test_window_cover_at_the_edge_and_under_a_pool():
    px = torch.zeros((8, 8), dtype=torch.bool)
    px[:8, :8] = True  # one tile at the corner: its window is 10x10
    assert int(costs.window_cover(px, 3, 1, 1, 8, 8)) == 100
    # a 2x2 pool's 8x8 out tile reads its 16x16 input block
    assert int(costs.window_cover(px, 2, 2, 0, 16, 16)) == 256


def test_tile_or_keeps_partial_tiles():
    m = torch.zeros((10, 17), dtype=torch.bool)
    m[9, 16] = True
    t = costs.tile_or(m, 8, 8)
    assert t.shape == (2, 3) and bool(t[1, 2]) and int(t.sum()) == 1


def test_launch_sums_stay_on_the_device():
    lz = costs.Launches("cpu")
    lz.add("B2", 1e9, 1e6)
    lz.add("B2", torch.tensor(2e9), torch.tensor(3e6))
    fl, nb, bound, n = lz.host()["B2"]
    assert (fl, nb, n) == (3e9, 4e6, 2)
    assert bound == pytest.approx(1e9 / 989e12 + 2e9 / 989e12)


VIDEO = {"scene_seed": 7, "n_sprites": 4, "sprite_size": 8, "speed": 4.0,
         "noise_std": 0.002}


def test_frames_are_a_function_of_the_seed():
    seed = 2**31 + 77  # past 32 signed bits
    a = frames.make_ring(VIDEO, 6, seed, 32, 64, "cpu", block=4)
    b = frames.make_ring(VIDEO, 6, seed, 32, 64, "cpu", block=4)
    c = frames.make_ring(VIDEO, 6, seed + 1, 32, 64, "cpu", block=4)
    assert a.shape == (6, 32, 64, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_a_fixed_scene_varies_only_by_noise_and_mirror():
    v = dict(VIDEO, noise_std=0.0)
    a = frames.make_ring(v, 3, 4, 32, 64, "cpu")    # no mirror
    b = frames.make_ring(v, 3, 8, 32, 64, "cpu")    # no mirror
    c = frames.make_ring(v, 3, 5, 32, 64, "cpu")    # mirrored rows
    assert torch.equal(a, b)
    assert torch.equal(torch.flip(a, [1]), c)
    del v["scene_seed"]  # then the seed draws the scene too
    assert not torch.equal(frames.make_ring(v, 3, 4, 32, 64, "cpu"),
                           frames.make_ring(v, 3, 8, 32, 64, "cpu"))


def test_graded_and_panned_frames():
    v = dict(VIDEO, distinct_classes=True, light_drift=0.1,
             light_period=192.0, noise_smooth_std=0.012,
             noise_smooth_scale=16, color_drift=0.05, color_period=96.0,
             pan=[4.0, 8.0])
    r = frames.make_ring(v, 5, 3, 32, 64, "cpu", block=2)
    assert r.shape == (5, 32, 64, 3) and torch.isfinite(r).all()
    assert not torch.equal(r[0], r[1])


def test_rings_hold_whole_refresh_intervals():
    for name in [w["name"] for w in spec.bench()["workloads"]]:
        cell = spec.cell(name)
        cfg = spec.config(cell["config"])
        assert cell["ring_frames"] % cfg["refresh_every_frames"] == 0


def test_trace_binning_of_a_synthetic_event_list():
    acts = [trace.Activity(n, s, e) for n, s, e in [
        ("void (anonymous namespace)::delta_conv_wg_kernel<64>(bf16*)",
         0.0, 2.0),
        ("void (anonymous namespace)::delta_conv_detect_wg_kernel<32>()",
         2.0, 5.0),
        ("void (anonymous namespace)::stem_conv_kernel<__nv_bfloat16, 3>()",
         5.0, 6.0),
        ("void (anonymous namespace)::pool_fused_kernel<bf16, uint4, 2>()",
         6.0, 6.5),
        ("void at::native::radixSortKVInPlace<-2, -1, 32, 32, int>()",
         7.0, 8.0),
        ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>()",
         8.0, 8.5),
        ("void at::native::unrolled_elementwise_kernel<copy>()", 9.0, 10.0),
        ("Memcpy DtoD (Device -> Device)", 9.5, 10.5),
    ]]
    assert [a.kernel for a in acts] == ["B2", "B6", "B5", "B3", None, None,
                                        None, None]
    st = trace.by_stage(acts)
    assert st["delta_conv"] == pytest.approx(6.0)
    assert st["fused_pool"] == pytest.approx(0.5)
    assert "compact" not in st  # a sort is glue, as any other activity
    assert st["glue"] == pytest.approx(3.5)
    assert trace.by_kernel(acts) == pytest.approx(
        {"B2": 2.0, "B6": 3.0, "B5": 1.0, "B3": 0.5})
    assert trace.union((a.start, a.end) for a in acts) == pytest.approx(9.5)
    gaps = trace.idle_gaps(acts, [("cudaGraphLaunch", 6.4, 7.2)], 0.0, 11.0)
    assert [g[1] for g in gaps] == pytest.approx([0.5, 0.5, 0.5])
    assert gaps[0][0].startswith("cudaGraphLaunch")
    assert trace.top_ops(acts, 2)[0][1] == pytest.approx(3.0)


def test_detect_kernels_bin_apart_from_conv_kernels():
    assert set(costs.CONV_KERNELS) == {"B2", "B5", "B6"}
    assert set(costs.DETECT_KERNELS) == {"B1", "B3", "B4", "B7", "B8", "B9"}
    for stem, kid in trace.STEM_KERNEL.items():
        assert trace.port_kernel(f"void ns::{stem}_kernel<int>()") == kid
    assert trace.port_kernel("void ns::delta_conv_detect_kernel()") == "B6"
    assert trace.port_kernel("nvjet_tst_32x512_64x3") is None
    assert math.isclose(costs.PEAK_BF16_FLOPS / costs.PEAK_BYTES,
                        295.2, rel_tol=1e-3)


def test_the_counter_counts_fused_conv_detect_and_a_redetecting_pool():
    # a fused conv + consumer detect (B6, its consumer a conv, as the
    # program fuses) and a re-detecting pool (B1, B8), the paths of a deep
    # net that the scene cells do not take, counted from each node's
    # changed pixels as the judged pass hands them over
    from cbbench import netdef
    layers = [
        {"kind": "conv", "features": 8, "kernel": 3, "activation": "relu",
         "cb": True, "stem": True, "kernels": ["B4", "B5"]},
        {"kind": "conv", "features": 8, "kernel": 3, "activation": "relu",
         "cb": True, "kernels": ["B1", "B6"]},
        {"kind": "conv", "features": 8, "kernel": 3, "activation": "relu",
         "cb": True, "kernels": ["B2"]},
        {"kind": "pool", "window": 2, "cb": True, "forward": False,
         "kernels": ["B1", "B8"]},
        {"kind": "conv", "features": 4, "kernel": 1, "activation": None,
         "cb": False, "kernels": []}]
    nodes = netdef.nodes_of({"layers": layers})
    shapes = [(3, 32, 64), (8, 32, 64), (8, 32, 64), (8, 32, 64),
              (8, 16, 32)]
    counter = costs.Counter(nodes, 0.375, 2, "cpu")
    for n, shape in zip(nodes, shapes):  # the refresh: all dense
        counter.node(n["name"], shape, None, True)
    assert counter.launches.host() == {}
    counter.start()
    for i, (n, shape) in enumerate(zip(nodes, shapes)):
        d = None
        if n["cb"]:  # one 8x8 tile's worth of change, widening per layer
            d = torch.zeros(shape[1:], dtype=torch.bool)
            d[8 - i:16 + i, 16 - i:24 + i] = True
        counter.node(n["name"], shape, d, False)
    got = counter.launches.host()
    assert {"B4", "B5", "B6", "B1", "B2", "B8"} <= set(got)
    assert got["B6"][0] > 0 and got["B8"][1] > 0
    assert got["B6"][3] == 1 and got["B8"][3] == 1 and got["B2"][3] == 1


def test_the_join_takes_the_maps_the_run_kept(monkeypatch):
    # a graph captured after the profiled pass (the judged pass's) whose
    # map fits the start of a replay with other scopes would leave it
    # unattributed; the run keeps the maps as they were when the pass ended
    import types
    from cbbench import stages
    k = "void ns::{}_kernel<int>()"
    kept = {"nodes": [("refresh/L0_conv/detect", "kernel",
                       k.format("stem_detect")),
                      ("refresh/L0_conv/patch_conv", "kernel",
                       k.format("stem_conv"))]}
    later = {"nodes": [("L0_conv/detect", "kernel", k.format("stem_detect"))]}
    acts = [trace.Activity(kept["nodes"][0][2], 0.0, 1.0),
            trace.Activity(kept["nodes"][1][2], 1.0, 3.0)]
    ctx = types.SimpleNamespace(slice=types.SimpleNamespace(
        acts=acts, host=[], t0=0.0, t1=3.0, frames=1), maps=[kept])
    monkeypatch.setattr(stages, "program_maps", lambda: [kept, later])
    stages._CACHE.clear()
    assert stages.stage_seconds(stages.of_ctx(ctx))["refresh"] \
        == pytest.approx(3.0)
    ctx.maps = None  # the maps as the program keeps them afterwards
    stages._CACHE.clear()
    j = stages.of_ctx(ctx)
    assert stages.stage_seconds(j)["refresh"] == 0.0
    assert j.unattributed_s() == pytest.approx(3.0)
