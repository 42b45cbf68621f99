#!/usr/bin/env python3
"""Same-call A/B of the list-walking kernels (B1 ``cb_detect_sparse``, B3
``cb_pool_fused``, B8 ``cb_delta_pool``, B5 ``cb_stem_conv``, B9
``cb_accept_tiles``) and of the full-map detects (B4 ``cb_stem_detect``,
B7 ``cb_detect_full``) built from two or more source trees, on one card,
in turns.

    mkdir -p build/parent
    git archive d4b4d4c cbinfer_tpu_torch | tar -x -C build/parent
    python3 scripts/torch_detect_ab.py \\
        --csrc build/parent/cbinfer_tpu_torch/csrc --csrc cbinfer_tpu_torch/csrc

Each ``--csrc`` directory holds ``detect_sparse.cu``, ``pool_fused.cu``,
``delta_pool.cu``, ``stem_conv.cu``, ``accept_tiles.cu``,
``stem_detect.cu`` and ``detect_full.cu`` (and the headers they include).
Each tree's interface is read from its sources: tau a float or a device
pointer (B1, B4, B7); B1 and B9 given the map's width (ragged maps) or the
hint grid's; B4 given its mask's cell or not; B7 given x's channel count
or not. A case that needs what a tree lacks (a ragged map, a cell of 4, a
narrow x) runs on the trees that have it only. Of the walkers, two C
interfaces of each are known, and each tree gets its own: one block per
list entry up to
the capacity, or per tile for B5 (a grid of ``n_blocks``), or a grid sized
to the card that walks the list (``walk_grid`` with the ``BLOCKS_PER_SM``
of the tree's own ``../ops/kernels/*.py`` where it has them, else this
checkout's; B9's over its (tile, part) pairs, split by this checkout's
``part_split`` at the tree's own ``PART_UNITS``); a B5 that takes its
channel split (``int cc, int lanes, int cs``) gets this checkout's
``lane_split``; B4 either takes the cell grid's window and one thread a
pixel, or its block plan and load width (``int vec16, int bw``: this
checkout's ``block_plan`` and ``vec16``); B7 either launches a block per
8 rows x 32 pixels, or takes the grid of its wide path's walk over the
8x8-pixel tiles (``int cx, int grid``: ``walk_grid`` at the tree's
``BLOCKS_PER_SM``). Every tree's kernels are built
with nvcc (sm_90a) and run on the same seeded bf16 inputs at the
steady-frame shapes and list lengths that ``chip_smoke.py`` records on the
scene flagship, on ``hintless``, on pose and on ``pose_fwd``, plus one
all-tiles case each (for B5 the capacity overflow, which walks every tile;
for B4 tau = -1, which marks every pixel), B7 on ``hintless``'s first
pool, and the geometries of ragged maps, a 3-channel stem and a cell of
4: per-launch device ms by CUDA
events, L2 flushed, the outputs restored and the mask and npix zeroed
before each launch, the trees taking turns (A B .. B A) for ``--rounds``
rounds; ``ms_per_launch`` is the kernel alone, ``ms_per_call`` the kernel
after the zero-fills its tree's wrapper makes (one for a list walker of B1
and B3, for B4 with a block plan and for B7 with a walk, one per output
before; B5, B8 and B9 make none), as ``chip_smoke.py`` times a call.
Each case reports whether every tree's outputs (cache or out cache, mask,
npix) equal the first
tree's bit for bit, and for B5 the largest distance in bf16 ulps from the
first tree's and from this checkout's plain version, and whether the
first tree's equal the plain version. Prints the card's name and power
limit, then one JSON line per case. Needs a CUDA GPU and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from cbinfer_tpu_torch.ops.geometry import conv_tile_geometry  # noqa: E402
from cbinfer_tpu_torch.ops import flat4  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import sm_count, walk_grid  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import accept as KA  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import delta_pool as KDP  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import detect_full as KDF  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import detect_sparse as KD  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import pool_fused as KP  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import stem_conv as KSC  # noqa: E402
from cbinfer_tpu_torch.ops.kernels import stem_detect as KSD  # noqa: E402
from cbinfer_tpu_torch.ops.kernels.build import ARCH, nvcc_path  # noqa: E402

TAU = 0.15  # the scene net's tuned taus
NEG_FILL = -3.0e38  # a pool storage's margin (layers.NEG_FILL)
STEM_CAPACITY = 0.375  # of the stem tiles, as the paths configure it
# (kernel, case, map, channels (B5: cout; B7 narrow: x's), the layer's
# geometry, listed entries; for B5 past the capacity an overflow, which
# walks every tile; for B4 and B7 the changed pixels of the frame pair, -1
# for tau = -1[, what a tree must take to run the case])
CASES = [
    ("B1", "flagship 360x640 C128 (spec 2)", (360, 640), 128, "conv", 62),
    ("B1", "flagship 180x320 C256 (spec 4)", (180, 320), 256, "conv", 31),
    ("B1", "flagship 180x320 C256 (spec 5)", (180, 320), 256, "conv", 36),
    ("B1", "pose 720x1280 C64", (720, 1280), 64, "conv", 1041),
    ("B1", "pose 360x640 C64", (360, 640), 64, "conv", 601),
    ("B1", "pose 180x320 C128", (180, 320), 128, "conv", 301),
    ("B1", "pose 180x320 C256 on a pool", (180, 320), 256, "pool", 97),
    ("B1", "pose 90x160 C256", (90, 160), 256, "conv", 14),
    ("B1", "all tiles 360x640 C128", (360, 640), 128, "conv", 3600),
    ("B3", "flagship 720x1280 C128 (spec 1)", (720, 1280), 128, "pool", 92),
    ("B3", "flagship 360x640 C256 (spec 3)", (360, 640), 256, "pool", 46),
    ("B3", "pose 720x1280 C64", (720, 1280), 64, "pool", 878),
    ("B3", "pose 360x640 C128", (360, 640), 128, "pool", 429),
    ("B3", "all blocks 720x1280 C128", (720, 1280), 128, "pool", 7200),
    ("B8", "hintless 720x1280 C128 (spec 1)", (720, 1280), 128, "pool", 62),
    ("B8", "hintless 360x640 C256 (spec 3)", (360, 640), 256, "pool", 31),
    ("B8", "pose 180x320 C256", (180, 320), 256, "pool", 14),
    ("B8", "all tiles 720x1280 C128", (720, 1280), 128, "pool", 3600),
    ("B5", "flagship 720x1280 cout 128", (720, 1280), 128, "stem", 69),
    ("B5", "pose 720x1280 cout 64", (720, 1280), 64, "stem", 599),
    ("B5", "overflow 720x1280 cout 128", (720, 1280), 128, "stem", 1351),
    ("B5", "overflow 720x1280 cout 64", (720, 1280), 64, "stem", 1351),
    ("B9", "pose_fwd 90x160 C128 (bottom row listed)", (90, 160), 128,
     "accept", 30),
    ("B9", "pose_fwd 90x160 C256 (bottom row listed)", (90, 160), 256,
     "accept", 30),
    ("B9", "all tiles 90x160 C256", (90, 160), 256, "accept", 240),
    ("B9", "all tiles 180x320 C128 (longer than the grid)", (180, 320), 128,
     "accept", 900),
    ("B4", "flagship 720x1280x3 steady frame", (720, 1280), 3, "full", 1794),
    ("B4", "pose 720x1280x3 steady frame", (720, 1280), 3, "full", 5116),
    ("B4", "tau = -1 720x1280x3", (720, 1280), 3, "full", -1),
    ("B7", "hintless 720x1280 C128 (spec 1)", (720, 1280), 128, "fullmap",
     46080),
    ("B7", "tau = -1 720x1280 C128", (720, 1280), 128, "fullmap", -1),
    ("B1", "probe 15x20 C256 (480x640, ragged)", (15, 20), 256, "conv", 6,
     "ragged"),
    ("B1", "probe 33x60 C256 (1080p, ragged)", (33, 60), 256, "conv", 20,
     "ragged"),
    ("B9", "all tiles 33x60 C256 (ragged)", (33, 60), 256, "accept", 40,
     "ragged"),
    ("B4", "flagship 720x1280x3 at cells of 4", (720, 1280), 3, "full4",
     1794, "cell4"),
    ("B7", "cin-3 stem 720x1280x3 (storage 8)", (720, 1280), 3, "narrow",
     46080, "narrow"),
]
WRAPPERS = {"B1": ("detect_sparse", KD), "B3": ("pool_fused", KP),
            "B8": ("delta_pool", KDP), "B5": ("stem_conv", KSC),
            "B9": ("accept_tiles", KA), "B4": ("stem_detect", KSD),
            "B7": ("detect_full", KDF)}


def _constant(csrc, wrapper, name, default):
    """The integer ``name = N`` of the tree's own wrapper module, else
    ``default``."""
    path = os.path.join(csrc, os.pardir, "ops", "kernels", wrapper)
    if os.path.exists(path):
        with open(path) as f:
            m = re.search(rf"^{name} = (\d+)", f.read(), re.M)
        if m:
            return int(m.group(1))
    return default


class Tree:
    """One source tree's B1, B3, B8, B5, B9 and B4 behind one calling
    convention each."""

    # a phrase of each walking kernel's C interface (B4: the block plan's)
    WALKS = {"B1": r"int cap,\s+int grid", "B3": r"int cap,\s+int grid",
             "B8": r"int cap,\s+int grid",
             "B5": r"int n_tiles,\s+int capacity",
             "B9": r"int cap,\s+int grid", "B4": r"int vec16,\s+int bw",
             "B7": r"int cx,\s+int grid"}
    # phrases of the interfaces that take a geometry: a case needing one
    # runs on the trees whose source has it
    TAKES = {("B1", "ragged"): r"int C,\s+int W,",
             ("B9", "ragged"): r"int H,\s+int W,",
             ("B4", "cell4"): r"int bw,\s+int cell",
             ("B7", "narrow"): r"int C,\s+int cx,"}

    def __init__(self, csrc, out_dir, tag):
        self.walks, self.per_sm, procs, libs = {}, {}, [], {}
        self.tau_ptr, self.takes = {}, {}
        for kind, (name, mod) in WRAPPERS.items():
            with open(os.path.join(csrc, f"{name}.cu")) as f:
                src = f.read()
            self.walks[kind] = bool(kind in self.WALKS
                                    and re.search(self.WALKS[kind], src))
            self.tau_ptr[kind] = bool(re.search(r"const float\* tau", src))
            for (k, need), phrase in self.TAKES.items():
                if k == kind:
                    self.takes[need] = bool(re.search(phrase, src))
            if kind == "B5":  # takes its channel split from the caller
                self.split = bool(re.search(r"int cc,\s+int lanes", src))
            wrapper = mod.__name__.rsplit(".", 1)[1] + ".py"
            self.per_sm[kind] = _constant(csrc, wrapper, "BLOCKS_PER_SM",
                                          getattr(mod, "BLOCKS_PER_SM", 0))
            if kind == "B9":
                self.part_units = _constant(csrc, wrapper, "PART_UNITS",
                                            KA.PART_UNITS)
            so = os.path.join(out_dir, f"lib{name}_{tag}.so")
            procs.append(subprocess.Popen(
                [nvcc_path(), ARCH, "-std=c++17", "-O3", "-shared",
                 "-Xcompiler", "-fPIC", "-o", so,
                 os.path.join(csrc, f"{name}.cu")]))
            libs[kind] = so
        for p in procs:
            if p.wait():
                raise RuntimeError(f"nvcc failed on {csrc}")
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

        def grid(kind):
            return [i, i] if self.walks[kind] else [i]

        def tau(kind):
            return [vp if self.tau_ptr[kind] else ctypes.c_float]
        self.fn = {
            "B1": ("cb_detect_sparse", [vp] * 6 + grid("B1") + tau("B1")
                   + [i] * 4 + [ll, ll] + [i] * 10 + [vp]),
            "B3": ("cb_pool_fused", [vp] * 5 + grid("B3") + [i] * 7
                   + [ll, ll, vp]),
            "B8": ("cb_delta_pool", [vp] * 4 + grid("B8") + [i] * 10
                   + [ll, ll, vp]),
            "B5": ("cb_stem_conv", [vp] * 6 + [i] * 7 + grid("B5")
                   + [i] * (3 * self.split) + [ll, ll, vp]),
            "B9": ("cb_accept_tiles", [vp] * 4 + grid("B9") + [i, i]
                   + [ll] * 3 + [i, i] + [i] * (3 * self.walks["B9"])
                   + [vp]),
            "B4": ("cb_stem_detect", [vp] * 4 + tau("B4") + [i] * 4
                   + [ll] + [i] * (4 if self.walks["B4"] else 10)
                   + [i] * self.takes["cell4"] + [vp]),
            "B7": ("cb_detect_full", [vp] * 4 + tau("B7")
                   + [i] * (4 + self.takes["narrow"] + self.walks["B7"])
                   + [ll, ll] + [i] * 10 + [vp]),
        }
        for kind, (name, argtypes) in self.fn.items():
            f = getattr(ctypes.CDLL(libs[kind]), name)
            f.argtypes, f.restype = argtypes, i
            self.fn[kind] = f

    def grid(self, kind, cap, walk=None):
        """The grid arguments of a launch over a list of ``cap`` entries
        (B5: ``walk`` blocks of 8 items cover every tile; B9: ``walk``
        parts a tile)."""
        sms = sm_count(torch.cuda.current_device())
        if kind == "B5":
            return [walk_grid(walk, sms, self.per_sm[kind])
                    if self.walks[kind] else cap]
        if not self.walks[kind]:
            return [cap]
        if kind == "B9":
            return [cap, walk_grid(cap * walk, sms, self.per_sm[kind])]
        return [cap, walk_grid(cap, sms, self.per_sm[kind])]


def make_case(kind, hw, C, geom, n, gen):
    """Seeded inputs of one case: a dict of x, the buffer the kernel updates
    in place (``st``), the list, its count, the geometry, the list's
    capacity, and for B5 the weights and bias."""
    h, w = hw
    bf = torch.bfloat16
    dev = "cuda"
    case = {}
    if geom in ("fullmap", "narrow"):  # B7: x against the layer's cache
        if geom == "fullmap":  # a 2x2 pool's storage, "-inf" margins
            g = conv_tile_geometry((h, w, C), (2, 2), (2, 2), (1, 1),
                                   "VALID", 8, 8)
            cs, fill = C, NEG_FILL
        else:  # a cin-3 conv's storage at the channel grid, zero margins
            g = conv_tile_geometry((h, w, 8), (3, 3), (1, 1), (1, 1),
                                   "SAME", 8, 8)
            cs, fill = 8, 0.0
        prev = torch.randn(h, w, C, device=dev, generator=gen).to(bf)
        x = prev.clone()
        if n > 0:  # n pixels move by 0.5 on every channel
            moved = torch.randperm(h * w, device=dev, generator=gen)[:n]
            x.view(-1, C)[moved] += 0.5
        st = torch.full(g.store_shape[:2] + (cs,), fill, dtype=bf,
                        device=dev)
        st[g.store_lo_h:g.store_lo_h + h, g.store_lo_w:g.store_lo_w + w,
           C:] = 0
        st[g.store_lo_h:g.store_lo_h + h, g.store_lo_w:g.store_lo_w + w,
           :C] = prev
        case.update(x=x, st=st, g=g, cap=h * w,
                    tau=TAU if n >= 0 else -1.0, idx=None, count=None)
        return case
    if geom in ("full", "full4"):  # B4: a float32 frame pair, the stem cache
        g = conv_tile_geometry((h, w, C), (3, 3), (1, 1), (1, 1), "SAME",
                               8, 32)
        case["cell"] = cell = 4 if geom == "full4" else flat4.CELL
        prev = torch.rand(h, w, C, device=dev, generator=gen).to(bf).float()
        # sensor noise below tau on every pixel, n pixels moved above it
        x = prev + (torch.rand(h, w, C, device=dev, generator=gen) - 0.5) \
            * 0.02
        if n > 0:
            moved = torch.randperm(h * w, device=dev, generator=gen)[:n]
            x.view(-1, C)[moved] += 0.5
        st = torch.zeros(g.store_shape, dtype=bf, device=dev)
        st[g.store_lo_h:g.store_lo_h + h,
           g.store_lo_w:g.store_lo_w + w] = prev.to(bf)
        case.update(x=x, st=st, g=g, cap=h * w,
                    tau=TAU if n >= 0 else -1.0,
                    mask_hw=(h // cell, w // cell), idx=None, count=None)
        return case
    if geom == "accept":  # B9: the producer's padded out cache
        g = conv_tile_geometry((h, w, C), (1, 1), (1, 1), (1, 1), "SAME",
                               8, 8)
        cw = -(-w // 8)
        cap = -(-h // 8) * cw
        x = torch.randn(g.out_h_pad, g.out_w_pad, C, device=dev,
                        generator=gen).to(bf)
        st = torch.randn(g.store_shape[:2] + (C,), device=dev,
                         generator=gen).to(bf)
        # every tile, or the clamped bottom row's first and last tile
        # among those listed
        bottom = torch.tensor([cap - cw, cap - 1], device=dev)
        rest = torch.randperm(cap - cw, device=dev, generator=gen)[:n - 2]
        idx = (torch.arange(cap, device=dev) if n == cap
               else torch.cat([rest, bottom]).sort().values).to(torch.int32)
        idx = torch.cat([idx, torch.full((cap - n,), cap, dtype=torch.int32,
                                         device=dev)])
        count = torch.tensor(n, dtype=torch.int32, device=dev)
        case.update(x=x, st=st, idx=idx, count=count, g=g, cap=cap)
        return case
    if geom == "stem":
        g = conv_tile_geometry((h, w, 3), (3, 3), (1, 1), (1, 1), "SAME",
                               8, 32)
        cap = int(STEM_CAPACITY * g.n_tiles)
        x = torch.zeros(g.store_shape, dtype=bf, device=dev)
        x[g.store_lo_h:g.store_lo_h + h, g.store_lo_w:g.store_lo_w + w] = \
            torch.rand(h, w, 3, device=dev, generator=gen).to(bf)
        case["w"] = (torch.randn(3, 3, 3, C, device=dev, generator=gen)
                     * 0.2).to(bf)
        case["b"] = torch.randn(C, device=dev, generator=gen)
        st = torch.randn(g.out_h_pad, g.out_w_pad, C, device=dev,
                         generator=gen).to(bf)
        listed = min(n, cap)
    else:
        if geom == "conv":
            g = conv_tile_geometry((h, w, C), (3, 3), (1, 1), (1, 1), "SAME",
                                   8, 8)
        else:
            g = conv_tile_geometry((h, w, C), (2, 2), (2, 2), (1, 1),
                                   "VALID", 8, 8)
        listed = n
        if kind == "B1":
            cap = -(-h // 8) * -(-w // 8)
            prev = torch.randn(h, w, C, device=dev, generator=gen)
            # a quarter of the pixels move by 0.05..0.5 on every channel
            move = (torch.rand(h, w, 1, device=dev, generator=gen) < 0.25) \
                * torch.empty(h, w, C, device=dev).uniform_(
                    0.05, 0.5, generator=gen)
            x = (prev + move).to(bf)
            st = torch.zeros(g.store_shape, dtype=bf, device=dev)
            st[g.store_lo_h:g.store_lo_h + h,
               g.store_lo_w:g.store_lo_w + w] = prev.to(bf)
        elif kind == "B3":
            cap = (h // 8) * (w // 16)
            x = torch.randn(h, w, C, device=dev, generator=gen).to(bf)
            st = torch.randn(g.out_h_pad, g.out_w_pad, C, device=dev,
                             generator=gen).to(bf)
        else:  # B8: the pool's padded storage, "-inf" margins
            cap = g.n_tiles
            x = torch.full(g.store_shape, NEG_FILL, dtype=bf, device=dev)
            x[g.store_lo_h:g.store_lo_h + h,
              g.store_lo_w:g.store_lo_w + w] = torch.randn(
                  h, w, C, device=dev, generator=gen).to(bf)
            st = torch.randn(g.out_h_pad, g.out_w_pad, C, device=dev,
                             generator=gen).to(bf)
    # compaction lists ids in row-major order
    idx = torch.randperm(cap, device=dev, generator=gen)[:listed].sort() \
        .values.to(torch.int32)
    idx = torch.cat([idx, torch.full((cap - listed,), cap, dtype=torch.int32,
                                     device=dev)])
    count = torch.tensor(n, dtype=torch.int32, device=dev)
    case.update(x=x, st=st, idx=idx, count=count, g=g, cap=cap)
    return case


def _ulps(a, b):
    """Largest distance of two bf16 tensors in bf16 ulps."""
    def ordered(t):
        v = t.view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)
    return int((ordered(a) - ordered(b)).abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="B1,B3,B8,B5,B9,B4,B7",
                    help="comma-separated kernels whose cases run")
    ap.add_argument("--flush", choices=("write", "read"), default="write",
                    help="evict L2 before each launch by writing 64 MiB "
                    "(as chip_smoke.py does: L2 is left dirty, so a launch "
                    "also pays for writing back what it evicts) or by "
                    "reading them (L2 left clean)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    tmp = os.path.join(REPO, "build", "detect_ab")  # git-ignored
    os.makedirs(tmp, exist_ok=True)
    trees = [Tree(c, tmp, str(k)) for k, c in enumerate(args.csrc)]
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    kinds = args.kernels.split(",")
    taus = {}

    def tau_arg(tree, kind, v):
        """tau as the tree's kernel takes it: a float, or the address of a
        float32 on the card."""
        if not tree.tau_ptr[kind]:
            return v
        if v not in taus:
            taus[v] = torch.full((), v, dtype=torch.float32, device="cuda")
        return taus[v].data_ptr()

    for kind, name, hw, C, geom, n, *need in CASES:
        active = [j for j, t in enumerate(trees)
                  if not need or t.takes[need[0]]]
        if kind not in kinds or not active:
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        case = make_case(kind, hw, C, geom, n, gen)
        x, st0, idx, count, g, cap = (case[k] for k in (
            "x", "st", "idx", "count", "g", "cap"))
        st = st0.clone()
        mh, mw = case.get("mask_hw", (g.tiles_h, g.tiles_w))
        out = torch.zeros((mh * mw + 1,), dtype=torch.int32, device="cuda")
        mask = out[:mh * mw].view(torch.float32).view(mh, mw)
        npix = out[mh * mw:]
        if kind == "B5":  # blocks of 8 items
            walk = KSC.walk_blocks(g, C)
        elif kind == "B9":  # parts of a tile (16-byte units)
            walk = {t: KA.part_split(8 * C * 2 // 16, t.part_units)
                    for t in trees}
        else:
            walk = None

        def b7_walk(tree):
            """B7's walk over the 8x8-pixel tiles (the wide path's grid)."""
            return walk_grid(-(-g.in_h // 8) * -(-g.in_w // 8),
                             sm_count(torch.cuda.current_device()),
                             tree.per_sm[kind])

        def launch(j):
            tree = trees[j]
            fn = tree.fn[kind]
            if kind == "B1":
                sh, sw = g.stride
                err = fn(
                    x.data_ptr(), st.data_ptr(), idx.data_ptr(),
                    count.data_ptr(), mask.data_ptr(), npix.data_ptr(),
                    *tree.grid(kind, cap), tau_arg(tree, kind, TAU), 1,
                    g.in_h, C,
                    g.in_w if tree.takes["ragged"] else g.in_w // 8,
                    x.shape[1] * C, st.shape[1] * C, g.store_lo_h,
                    g.store_lo_w, g.tiles_h, g.tiles_w, g.th * sh,
                    g.tw * sw, g.pad_lo_h, g.pad_lo_w, g.win_h, g.win_w,
                    stream)
            elif kind == "B3":
                err = fn(
                    x.data_ptr(), st.data_ptr(), idx.data_ptr(),
                    count.data_ptr(), mask.data_ptr(),
                    *tree.grid(kind, cap), 1, C, g.in_w // 16, 8, 16, 2,
                    g.tiles_w, x.shape[1] * C, g.out_w_pad * C, stream)
            elif kind == "B8":
                (kh, kw), (sh, sw) = g.kernel, g.stride
                err = fn(
                    x.data_ptr(), idx.data_ptr(), count.data_ptr(),
                    st.data_ptr(), *tree.grid(kind, cap), 1, C, g.tiles_w,
                    g.th, g.tw, kh, kw, sh, sw, g.dx0, x.shape[1] * C,
                    g.out_w_pad * C, stream)
            elif kind == "B9":
                x_row, s_row = x.shape[1] * C * 2, st.shape[1] * C * 2
                split = list(walk[tree]) if tree.walks[kind] else []
                err = fn(
                    x.data_ptr(), st.data_ptr(), idx.data_ptr(),
                    count.data_ptr(), *tree.grid(kind, cap, walk[tree][0]),
                    g.in_h,
                    g.in_w if tree.takes["ragged"] else g.in_w // 8,
                    x_row, s_row,
                    g.store_lo_h * s_row + g.store_lo_w * C * 2, 8 * C * 2,
                    1, *split, stream)
            elif kind == "B4":
                s_row = st.shape[1] * C
                if tree.walks[kind]:
                    plan = [int(KSD.vec16(
                        x.data_ptr(), st.data_ptr(), s_row * 2,
                        (g.store_lo_h * s_row + g.store_lo_w * C) * 2)),
                        KSD.block_plan(g.in_h, g.in_w)[0]]
                else:  # the cell grid's window: 8x8 cells, 3x3 SAME
                    plan = [mh, mw, 8, 8, 1, 1, 10, 10]
                cell = [case["cell"]] if tree.takes["cell4"] else []
                err = fn(
                    x.data_ptr(), st.data_ptr(), mask.data_ptr(),
                    npix.data_ptr(), tau_arg(tree, kind, case["tau"]), 1,
                    g.in_h, g.in_w, C, s_row, g.store_lo_h, g.store_lo_w,
                    *plan, *cell, stream)
            elif kind == "B7":
                sh, sw = g.stride
                cs = st.shape[-1]
                cx = [C] if tree.takes["narrow"] else []
                walk = [b7_walk(tree)] if tree.walks[kind] else []
                err = fn(
                    x.data_ptr(), st.data_ptr(), mask.data_ptr(),
                    npix.data_ptr(), tau_arg(tree, kind, case["tau"]), 1,
                    g.in_h, g.in_w, cs, *cx, *walk, x.shape[1] * C,
                    st.shape[1] * cs, g.store_lo_h, g.store_lo_w, g.tiles_h,
                    g.tiles_w, g.th * sh, g.tw * sw, g.pad_lo_h, g.pad_lo_w,
                    g.win_h, g.win_w, stream)
            else:  # B5
                n_tiles = [g.n_tiles] if tree.walks[kind] else []
                split = list(KSC.lane_split(C)) if tree.split else []
                err = fn(
                    x.data_ptr(), idx.data_ptr(), count.data_ptr(),
                    case["w"].data_ptr(), case["b"].data_ptr(),
                    st.data_ptr(), *tree.grid(kind, g.n_tiles, walk), 1, 3,
                    C, *split, g.tiles_w, *n_tiles, cap, g.dx0, 1,
                    x.shape[1] * 3, g.out_w_pad * C, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} at launch")

        def fill(j):
            """The zero-fills of tree j's wrapper: one for a list walker
            of B1 and B3, for B4 with a block plan and for B7 with a walk
            (mask and npix share a buffer), else one per output; none for
            B5, B8 and B9."""
            if kind in ("B5", "B8", "B9"):
                return
            if trees[j].walks[kind]:
                out.zero_()
            else:
                mask.zero_()
                if kind in ("B1", "B4", "B7"):
                    npix.zero_()

        def restore():
            st.copy_(st0)
            out.zero_()

        outs = []
        for j in active:
            restore()
            launch(j)
            torch.cuda.synchronize()
            outs.append((st.clone(), mask.clone(), npix.clone()))
        same = [all(torch.equal(a, b) for a, b in zip(o, outs[0]))
                for o in outs]
        ulps = changed = None
        if kind == "B1":
            sp, mp, pp = KD.detect_sparse_plain(x, st0.clone(), TAU, idx,
                                                count, g)
            plain = (torch.equal(outs[0][0], sp) and torch.equal(
                outs[0][1], mp) and torch.equal(outs[0][2], pp))
            changed = int(pp)
        elif kind == "B3":
            sp, mp = KP.detect_pool_fused_plain(x, st0.clone(), idx, count,
                                                g)
            plain = (torch.equal(outs[0][0], sp)
                     and torch.equal(outs[0][1], mp))
        elif kind == "B8":
            sp = KDP.delta_pool_plain(x, idx, st0.clone(), g, count=count)
            plain = torch.equal(outs[0][0], sp)
        elif kind == "B9":
            sp = KA.accept_tiles_plain(x, st0.clone(), idx, count, g)
            plain = torch.equal(outs[0][0], sp)
        elif kind in ("B4", "B7"):
            sp, mp, pp = (
                KSD.stem_detect_plain(x, st0.clone(), case["tau"], g,
                                      case["cell"]) if kind == "B4"
                else KDF.detect_full_plain(x, st0.clone(), case["tau"], g))
            plain = (torch.equal(outs[0][0], sp) and torch.equal(
                outs[0][1], mp) and torch.equal(outs[0][2], pp))
            changed = int(pp)
        else:
            sp = KSC.stem_conv_plain(x, idx, count, case["w"], case["b"],
                                     st0.clone(), g, "relu", torch.bfloat16,
                                     capacity=cap)
            plain = torch.equal(outs[0][0], sp)
            ulps = {"to_first": [_ulps(o[0], outs[0][0]) for o in outs],
                    "to_plain": [_ulps(o[0], sp) for o in outs]}

        def time_one(j, with_fill):
            total = 0.0
            for _ in range(args.reps):
                restore()
                if args.flush == "write":
                    flush.zero_()
                else:
                    flush.view(torch.int64).sum()
                torch.cuda._sleep(2_000_000)
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                if with_fill:
                    fill(j)
                launch(j)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / args.reps

        def grid_of(tree):
            if kind == "B4":
                return (KSD.block_plan(g.in_h, g.in_w)[1]
                        if tree.walks[kind]
                        else -(-g.in_w // 32) * -(-g.in_h // 8))
            if kind == "B7":
                if not tree.walks[kind]:  # 8 rows x 32 pixels a block
                    return -(-g.in_w // 32) * -(-g.in_h // 8)
                if geom == "narrow":  # 8 rows x 256 pixels a block
                    return -(-g.in_w // 256) * -(-g.in_h // 8)
                return b7_walk(tree)
            if kind == "B9":
                return tree.grid(kind, cap, walk[tree][0])[-1]
            return tree.grid(kind, cap, walk)[-1]

        order = active
        series = {args.csrc[j]: [] for j in active}
        calls = {args.csrc[j]: [] for j in active}
        for r in range(args.rounds):
            for j in (order if r % 2 == 0 else order[::-1]):
                series[args.csrc[j]].append(time_one(j, False))
                calls[args.csrc[j]].append(time_one(j, True))
        print(json.dumps({
            "kernel": kind, "case": name, "flush": args.flush,
            "channels": C, "listed": n,
            "of": cap, "changed_pixels": changed,
            "grids": [grid_of(trees[j]) for j in active],
            "bit_identical_to_first": same, "first_equals_plain": plain,
            "max_ulps": ulps, "ms_per_launch": series,
            "ms_per_call": calls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
