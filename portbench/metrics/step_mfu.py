"""Share of the card's f32 peak that the whole step reaches: the
algorithmic operations of its LW and SW solves over the traced window's
time a step. Bounds every kernel's roofline share from above in what it
can claim end to end."""

from portbench.work import PEAK_F32_OPS_PER_S


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    ops = ctx.work["lw"][0] + ctx.work["sw"][0]
    return 100.0 * ops * ctx.steps / (ctx.trace.window_ns / 1e9) / PEAK_F32_OPS_PER_S
