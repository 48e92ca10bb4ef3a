"""Host milliseconds of a densify event: the mean over the window's events
of the benchmark's own span around each (``trainer.densify_step`` from its
call to the host's read of its overflow). Nothing to read in a window
without events."""


def read(ctx):
    if not ctx.densify_s:
        return None
    return 1e3 * sum(ctx.densify_s) / len(ctx.densify_s)
