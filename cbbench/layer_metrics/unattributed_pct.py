"""Share of the profiled pass's device time (summed activities) that the
join explains neither by a node of a stage map nor by a ``runner.copy_in``
or ``runner.copy_out`` span, the runner's copies outside the graphs
(``stages``)."""

from cbbench import stages


def read(ctx):
    j = stages.of_ctx(ctx)
    if j is None or not j.replays:
        return None
    return 100.0 * j.unattributed_s() / j.total()
