"""Share of the traced window in which no device op runs: the union of the
profiler's device intervals against the window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
