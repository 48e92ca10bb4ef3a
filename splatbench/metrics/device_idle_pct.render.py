"""The share of the profiled steps' wall time in which no operation ran
on the device: 100 x (1 - the union of the device operations' intervals /
the window from the first profiled call to the closing synchronisation)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s() / p.window_s)
