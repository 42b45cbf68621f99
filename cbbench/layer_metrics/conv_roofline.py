"""The tile convs' share of their roofline over the profiled pass: the
sum of each launch's bound (operations and bytes from the reference's
changed-tile counts, ``costs.py``) over the sum of their device time, for
B2, B5 and B6."""

from cbbench import costs, trace


def read(ctx):
    s = ctx.slice
    if s is None or ctx.ref_launches is None:
        return None
    spent = trace.by_kernel(s.acts)
    t = sum(spent.get(k, 0.0) for k in costs.CONV_KERNELS)
    if t <= 0:
        return None
    bound = sum(ctx.ref_launches[k][2] for k in costs.CONV_KERNELS
                if k in ctx.ref_launches)
    return 100.0 * bound / t
