"""Host milliseconds a step spends in ``advance_step`` and
``update_fluxes`` (the API layer's enqueue), averaged over the traced
window's steps; read under the profiler, so it carries part of its cost."""


def read(ctx):
    if ctx.trace is None or not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
