"""The whole step's share of the card's bf16 peak over the profiled pass:
the operations the pass's frames need under CB (the changed tiles the
reference counts, a refresh frame's dense work, the dense classifier or
heads), over the pass's wall time, over 989 TFLOP/s. Effective
operations, never dense-equivalent ones."""

from cbbench import costs


def read(ctx):
    s = ctx.slice
    if s is None or ctx.ref_flops is None or not s.acts:
        return None
    return 100.0 * ctx.ref_flops / (s.t1 - s.t0) / costs.PEAK_BF16_FLOPS
