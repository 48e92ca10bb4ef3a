"""The SSIM pair's share of its roofline: the least time of the profiled
views' SSIM forward and backward (28 B and 387 operations per image
element; ``splatbench/counts``) over the device time of the kernels named
``ssim_fwd`` and ``ssim_bwd`` in the profiled steps."""


def read(ctx):
    p = ctx.profile
    if p is None or not ctx.views:
        return None
    t = p.device_s(lambda n: "ssim_fwd" in n or "ssim_bwd" in n)
    if t <= 0:
        return None
    c = ctx.counts
    return 100.0 * sum(c.bound_s(*c.ssim_pair(f)) for f in ctx.views) / t
