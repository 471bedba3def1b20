"""Device milliseconds a step of the ops the program launches that are not
its own kernels: the plain-torch prologue and composition."""

from portbench.tracing import plain_ops


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    ops = plain_ops(ctx.trace, ctx.kernels)
    return sum(e - s for _, s, e, _ in ops) / 1e6 / ctx.steps
