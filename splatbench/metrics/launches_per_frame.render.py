"""Device operations (kernels, copies, sets) per frame in the profiled
steps: what the host launches for one frame."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    return len(p.device) / p.steps
