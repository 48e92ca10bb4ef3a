"""The compositor forward's share of its roofline: the least time of the
profiled frames' forward launches (``splatbench/counts``) over the device
time of the kernels named ``composite_fwd`` in the profiled frames."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.views:
        return None
    t = p.device_s(lambda n: "composite_fwd" in n)
    if t <= 0:
        return None
    c = ctx.counts
    return 100.0 * sum(c.bound_s(*c.composite_fwd(f)) for f in ctx.views) / t
