"""Host microseconds a ``scan_video_jit`` call takes to return (it only
enqueues a replay), the mean over the window's calls."""


def read(ctx):
    if ctx.entry != "chunk" or not ctx.host_call_s:
        return None
    return sum(ctx.host_call_s) / len(ctx.host_call_s) * 1e6
