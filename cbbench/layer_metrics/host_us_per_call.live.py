"""Host microseconds a ``FrameStepper.__call__`` takes to return, before
the synchronise, the mean over the window's frames."""


def read(ctx):
    if ctx.entry != "live" or not ctx.host_call_s:
        return None
    return sum(ctx.host_call_s) / len(ctx.host_call_s) * 1e6
