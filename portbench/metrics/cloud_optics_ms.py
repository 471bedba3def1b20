"""Device milliseconds a step of the ops launched inside the cloud band
optics of both waves (the program's spans ``rrtmgp.lw.clouds`` and
``rrtmgp.sw.clouds``: the table gathers, the SW delta scaling). None where
the trace holds neither span (clear sky)."""

from portbench.program_spans import program_ops, spans

SPANS = ("rrtmgp.lw.clouds", "rrtmgp.sw.clouds")


def read(ctx):
    if ctx.trace is None or not any(name in SPANS for _, _, name in spans(ctx.trace)):
        return None
    ops = program_ops(ctx.trace)
    if ops is None:
        return None
    return sum(e - s for _, s, e, _, p in ops if p in SPANS) / 1e6 / ctx.steps
