"""The whole step's share of the card's float32 peak: the counted float32
operations of the profiled steps on this card (preprocess of every splat,
compositor forward and backward per contributing pair and the SSIM pair
per image element of its views, as the reference's walk counts them, and
Adam over every parameter; ``splatbench/counts``) over the profiled
window's seconds x 67 TFLOP/s. The card's power limit is in the result's
``device``."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or not ctx.views or p.window_s <= 0:
        return None
    c = ctx.counts
    ops = sum(c.train_view_ops(f, ctx.n_splats) for f in ctx.views)
    ops += c.adam_ops(ctx.n_splats) * p.steps
    return 100.0 * ops / (p.window_s * c.F32_OPS_PER_S)
