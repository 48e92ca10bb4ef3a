"""The whole frame's share of the card's float32 peak: the counted
float32 operations of the profiled frames (preprocess forward of every
splat and the compositor forward per contributing pair, as the
reference's walk counts them; ``splatbench/counts``) over the profiled
window's seconds x 67 TFLOP/s."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or not ctx.views or p.window_s <= 0:
        return None
    c = ctx.counts
    ops = sum(c.render_view_ops(f, ctx.n_splats) for f in ctx.views)
    return 100.0 * ops / (p.window_s * c.F32_OPS_PER_S)
