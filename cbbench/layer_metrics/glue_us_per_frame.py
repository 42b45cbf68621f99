"""Device microseconds per frame of every activity that is neither one of
the port's CUDA kernels nor the compaction's sorts: elementwise work,
copies, fills, reductions, cuBLAS, over the profiled pass."""

from cbbench import trace


def read(ctx):
    s = ctx.slice
    if s is None or not s.acts:
        return None
    return trace.by_stage(s.acts).get("glue", 0.0) / s.frames * 1e6
