"""Device milliseconds per step of the NCCL all-reduce kernels in the
profiled steps, by name (their time includes a card's wait for the others
inside the collective)."""


def read(ctx):
    p = ctx.profile
    if p is None or ctx.world < 2:
        return None
    s = p.device_s(lambda n: "nccl" in n.lower() and "allreduce" in n.lower())
    return 1e3 * s / p.steps if s > 0 else None
