"""Device activities of a profiled slice, read in memory from
``torch.profiler`` (CUPTI), binned by kernel name.

The binning is a frozen copy of ``scripts/torch_profile_trace.py``'s
(``KERNEL_STAGE``, ``port_kernel``, ``kernel_stage``): the port's kernel
functions are named ``<source stem>[_variant]_kernel``, and every other
device activity is glue, the compaction kernel ``compact_tiles`` among
them (it has no stem here). The stems are listed here, not read from
the program's registry, so a later change to the program cannot rebin.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# source stem of a kernel file -> the kernel's id in the kernel table
STEM_KERNEL = {
    "detect_sparse": "B1", "delta_conv": "B2", "pool_fused": "B3",
    "stem_detect": "B4", "stem_conv": "B5", "delta_conv_detect": "B6",
    "detect_full": "B7", "delta_pool": "B8", "accept_tiles": "B9",
    "tma_window": "P",
}
# kernel id -> stage, as the profile script bins the port's kernels
KERNEL_STAGE = {
    "B1": "detect", "B7": "detect", "B4": "detect", "B9": "detect",
    "B2": "delta_conv", "B6": "delta_conv", "B5": "delta_conv",
    "B8": "delta_pool", "B3": "fused_pool", "P": "glue",
}


MARK = "cbbench_slice"  # the host range around the profiled pass


class Activity:
    __slots__ = ("name", "start", "end", "kernel", "stage")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end
        self.kernel = port_kernel(name)
        self.stage = kernel_stage(name)

    @property
    def dur(self) -> float:
        return self.end - self.start


def port_kernel(fn_name: str) -> Optional[str]:
    """The kernel id a CUDA kernel function belongs to (the longest stem
    it starts with, ending in ``_kernel``), or None."""
    words = fn_name.split("<")[0].rsplit("::", 1)[-1].split("(")[0].split()
    fn = words[-1] if words else ""
    if not fn.endswith("_kernel"):
        return None
    hits = [st for st in STEM_KERNEL if fn.startswith(st)]
    return STEM_KERNEL[max(hits, key=len)] if hits else None


def kernel_stage(name: str) -> str:
    """A device activity's stage: the port's kernels by id, everything
    else ``glue``."""
    k = port_kernel(name)
    return "glue" if k is None else KERNEL_STAGE[k]


def device_activities(prof) -> Tuple[List[Activity], List[Tuple]]:
    """(device activities, host events) of a finished profiler, in
    seconds on the profiler's clock: kernels, copies and fills on the
    card; the host's operators and runtime calls as (name, start, end)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if not str(e.device_type()).endswith("CUDA"):
            host.append((e.name(), start, end))
        elif not e.is_user_annotation() and e.name() != MARK:
            # a range's copy on the device's timeline is no activity
            dev.append(Activity(e.name(), start, end))
    dev.sort(key=lambda a: a.start)
    return dev, host


def union(spans) -> float:
    """Length of the union of (start, end) spans."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def by_stage(acts: List[Activity]) -> Dict[str, float]:
    """Device seconds per stage (activity durations summed)."""
    out: Dict[str, float] = defaultdict(float)
    for a in acts:
        out[a.stage] += a.dur
    return dict(out)


def by_kernel(acts: List[Activity]) -> Dict[str, float]:
    """Device seconds per port kernel id."""
    out: Dict[str, float] = defaultdict(float)
    for a in acts:
        if a.kernel is not None:
            out[a.kernel] += a.dur
    return dict(out)


def top_ops(acts: List[Activity], n: int = 10) -> List[List]:
    """The device operations that took most time, by name."""
    out: Dict[str, float] = defaultdict(float)
    for a in acts:
        out[a.name[:100]] += a.dur
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(acts: List[Activity], host: List[Tuple], t0: float, t1: float,
              n: int = 10) -> List[List]:
    """The longest stretches of [t0, t1] with nothing on the device, each
    named by the host event that began last before the gap began (what
    the host was doing)."""
    gaps, cur = [], t0
    for a in acts:
        if a.start > cur:
            gaps.append((cur, a.start))
        cur = max(cur, a.end)
    if t1 > cur:
        gaps.append((cur, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = sorted(host, key=lambda h: h[1])
    out = []
    for s, e in gaps[:n]:
        before = [h for h in hs if h[1] <= s and h[2] >= s]
        name = before[-1][0] if before else "host idle"
        out.append([f"{name[:80]} @ {s - t0:.6f}s", e - s])
    return out
