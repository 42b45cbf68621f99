"""Device microseconds per frame of the graph replays' nodes in no stage and
outside ``refresh``: layer glue between stages, dense layers (the
classifier's cuBLAS), ``out_map``, ``stats``, over every frame of the
profiled pass (``stages``: each activity by the stage map of the graph it
came from)."""

from cbbench import stages


def read(ctx):
    j = stages.of_ctx(ctx)
    if j is None or not j.replays:
        return None
    return stages.stage_seconds(j)["none"] / ctx.slice.frames * 1e6
