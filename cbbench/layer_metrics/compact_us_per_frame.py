"""Device microseconds per frame of the stream compaction's sorts over
the profiled pass (``trace.kernel_stage`` == ``compact``)."""

from cbbench import trace


def read(ctx):
    s = ctx.slice
    if s is None or not s.acts:
        return None
    return trace.by_stage(s.acts).get("compact", 0.0) / s.frames * 1e6
