"""The compositor backward's share of its roofline: the least time of the
profiled views' backward launches (``splatbench/counts``: bytes over 3.35
TB/s against operations over 67 TFLOP/s, per view) over the device time of
the kernels named ``composite_bwd`` in the profiled steps."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.views:
        return None
    t = p.device_s(lambda n: "composite_bwd" in n)
    if t <= 0:
        return None
    c = ctx.counts
    return 100.0 * sum(c.bound_s(*c.composite_bwd(f)) for f in ctx.views) / t
