"""Host synchronisations a step inside the program's ``rrtmgp.*`` spans:
synchronising CUDA calls (``cu*Synchronize`` host events) and
device-to-host copies (``Memcpy DtoH`` device ops) launched there; a read
of a tensor on the host (``.item()``, ``.cpu()``) counts as its copy and
its synchronisation. A step that a CUDA graph could capture reads 0.
None where the trace holds no program span, or where it keeps no
launches."""

from portbench.program_spans import innermost, program_ops, spans


def read(ctx):
    trace = ctx.trace
    nested = [] if trace is None else spans(trace)
    if not nested:
        return None
    calls = [s for s, _, name in trace.host if name.startswith("cu") and name.endswith("Synchronize")]
    ops = program_ops(trace)
    if ops is None:
        return None
    copies = [op for op in ops if op[4] is not None and op[0].startswith("Memcpy DtoH")]
    return (sum(p is not None for p in innermost(nested, calls)) + len(copies)) / ctx.steps
