"""Device microseconds per frame of the graph replays' nodes of OpenPose's
front and first stage (the nodes ``bb_*``, the VGG-19 front to F, and
``s1_*``), outside ``refresh``, over every frame of the profiled pass
(``stages``: each activity by the stage map of the graph it came from,
its node the first scope of its layer path, ``stages.layer_of``). None
where no activity lies under such a node."""

from cbbench import stages

PREFIXES = ("bb_", "s1_")


def read(ctx):
    j = stages.of_ctx(ctx)
    if j is None or not j.replays:
        return None
    got = j.seconds(lambda p: "" if stages.bucket(p) == stages.REFRESH
                    else stages.layer_of(p).split("/")[0])
    mine = [v for k, v in got.items() if k.startswith(PREFIXES)]
    return sum(mine) / ctx.slice.frames * 1e6 if mine else None
