"""Share of the traced window in which the idlest card runs no op: for each
card that ran ops, the union of its device intervals against the window,
and the largest idle share of them. On one card it is ``device_idle_pct``;
on a mesh it shows a card that waits on the one host thread feeding all."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    busy = ctx.trace.card_busy_ns()
    if not busy:
        return None
    return 100.0 * (1.0 - min(busy.values()) / ctx.trace.window_ns)
