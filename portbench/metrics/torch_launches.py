"""Device ops a step that the program launches and that are not its own
kernels: the plain-torch prologue and composition, counted."""

from portbench.tracing import plain_ops


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return len(plain_ops(ctx.trace, ctx.kernels)) / ctx.steps
