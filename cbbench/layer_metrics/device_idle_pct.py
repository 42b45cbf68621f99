"""Share of the profiled pass's wall time in which nothing ran on the
card (the union of the device activities against the pass's span)."""

from cbbench import trace


def read(ctx):
    s = ctx.slice
    if s is None or not s.acts:
        return None
    busy = trace.union((max(a.start, s.t0), min(a.end, s.t1))
                       for a in s.acts)
    return 100.0 * (1.0 - busy / (s.t1 - s.t0))
