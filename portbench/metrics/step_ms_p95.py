"""95th percentile (nearest rank) of the time per step over every step of
the window, from the CUDA events recorded between steps."""

import math


def read(ctx):
    times = sorted(ctx.step_ms)
    return times[math.ceil(0.95 * len(times)) - 1] if times else None
