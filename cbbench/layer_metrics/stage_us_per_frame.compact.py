"""Device microseconds per frame of the graph replays' nodes under ``compact``
(the compaction kernel and its glue), outside ``refresh``, over every frame
of the profiled pass (``stages``: each activity by the stage map of the
graph it came from)."""

from cbbench import stages


def read(ctx):
    j = stages.of_ctx(ctx)
    if j is None or not j.replays:
        return None
    return stages.stage_seconds(j)["compact"] / ctx.slice.frames * 1e6
