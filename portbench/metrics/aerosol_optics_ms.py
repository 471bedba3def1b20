"""Device milliseconds a step of the ops launched inside the aerosol optics
of both waves (the program's spans ``rrtmgp.lw.aerosols`` and
``rrtmgp.sw.aerosols``: the aerosol_bands kernel K5, the active mask, the
properties and the SW delta scaling). None where the trace holds neither
span (no aerosols)."""

from portbench.program_spans import program_ops, spans

SPANS = ("rrtmgp.lw.aerosols", "rrtmgp.sw.aerosols")


def read(ctx):
    if ctx.trace is None or not any(name in SPANS for _, _, name in spans(ctx.trace)):
        return None
    ops = program_ops(ctx.trace)
    if ops is None:
        return None
    return sum(e - s for _, s, e, _, p in ops if p in SPANS) / 1e6 / ctx.steps
