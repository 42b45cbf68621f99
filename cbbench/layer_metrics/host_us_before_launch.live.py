"""Host microseconds from the start of a ``FrameStepper.__call__``
(``runner.call``) to the start of its graph launch (``runner.replay``):
the key, the frame's copy in, the Python between; the mean over the
profiled pass's calls (the program's spans, ``stages.host_calls``). The
launch is left out: the profiler's device tracing inflates it."""

from cbbench import stages


def read(ctx):
    s = ctx.slice
    if ctx.entry != "live" or s is None:
        return None
    calls = stages.host_calls(s.host)
    if not calls:
        return None
    return sum(b for b, _ in calls) / len(calls) * 1e6
