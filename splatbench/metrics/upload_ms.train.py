"""Host milliseconds per step of the per-iteration upload of the view's
images (``parallel/dp.py:camera_inputs``, from pageable host memory), from
the benchmark's own span around each call over the whole window."""


def read(ctx):
    if not ctx.steps or not ctx.upload_s:
        return None
    return 1e3 * ctx.upload_s / ctx.steps
