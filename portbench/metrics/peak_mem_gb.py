"""Peak device memory allocated during the window (reset after warm-up):
what the solver takes from a host model's memory, in GB (1e9 bytes)."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
