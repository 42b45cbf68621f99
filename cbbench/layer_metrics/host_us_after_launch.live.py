"""Host microseconds from the end of a ``FrameStepper.__call__``'s graph
launch (``runner.replay``) to the end of the call (``runner.call``: the
copy out and the return, which overlap the card), the mean over the
profiled pass's calls (the program's spans, ``stages.host_calls``)."""

from cbbench import stages


def read(ctx):
    s = ctx.slice
    if ctx.entry != "live" or s is None:
        return None
    calls = stages.host_calls(s.host)
    if not calls:
        return None
    return sum(a for _, a in calls) / len(calls) * 1e6
