"""Columns solved per second: columns x steps completed over the whole
window's wall time, closed by the final synchronisation."""


def read(ctx):
    return ctx.ncol * ctx.steps / ctx.window_s
