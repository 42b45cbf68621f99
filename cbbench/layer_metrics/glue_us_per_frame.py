"""Device microseconds per frame of every activity that is not one of the
port's CUDA kernels by stem (``trace.STEM_KERNEL``): elementwise work,
copies, fills, reductions, cuBLAS and the compaction kernel
``compact_tiles``, over the profiled pass."""

from cbbench import trace


def read(ctx):
    s = ctx.slice
    if s is None or not s.acts:
        return None
    return trace.by_stage(s.acts).get("glue", 0.0) / s.frames * 1e6
