"""Device operations (kernels, copies, sets) per step in the profiled
steps: what the host launches for one step."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    return len(p.device) / p.steps
