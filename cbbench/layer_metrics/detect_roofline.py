"""The detect and pool kernels' share of their roofline over the profiled
pass (B1, B3, B4, B7, B8, B9): the sum of each launch's bound (bytes from
the reference's counts) over the sum of their device time."""

from cbbench import costs, trace


def read(ctx):
    s = ctx.slice
    if s is None or ctx.ref_launches is None:
        return None
    spent = trace.by_kernel(s.acts)
    t = sum(spent.get(k, 0.0) for k in costs.DETECT_KERNELS)
    if t <= 0:
        return None
    bound = sum(ctx.ref_launches[k][2] for k in costs.DETECT_KERNELS
                if k in ctx.ref_launches)
    return 100.0 * bound / t
