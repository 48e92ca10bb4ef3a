"""The allocator's peak over the measured window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
in GiB; over ranks, the fullest card's."""

AGGREGATE = "max"


def read(ctx):
    if not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2 ** 30
