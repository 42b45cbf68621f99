"""Share of the profiled pass's device-idle time that lies inside a graph
replay (between its first activity's start and its last one's end), not
between replays: the gaps between a graph's own nodes against the host's
gaps between calls (``stages``)."""

from cbbench import stages


def read(ctx):
    j = stages.of_ctx(ctx)
    if j is None or not j.replays:
        return None
    inside, idle = j.idle_in_replays(ctx.slice.t0, ctx.slice.t1)
    return 100.0 * inside / idle if idle > 0 else None
