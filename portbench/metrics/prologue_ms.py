"""Device milliseconds a step of the ops launched inside the megakernel
route's per-wave prologue (the program's spans ``rrtmgp.lw.inputs`` and
``rrtmgp.sw.inputs``): pt and eta interpolation, minor scalings, the
Rayleigh factor. None where the trace holds neither span,
or where it keeps no launches."""

from portbench.program_spans import program_ops, spans

SPANS = ("rrtmgp.lw.inputs", "rrtmgp.sw.inputs")


def read(ctx):
    if ctx.trace is None or not any(name in SPANS for _, _, name in spans(ctx.trace)):
        return None
    ops = program_ops(ctx.trace)
    if ops is None:
        return None
    return sum(e - s for _, s, e, _, p in ops if p in SPANS) / 1e6 / ctx.steps
