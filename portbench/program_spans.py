"""The program's own spans in a reduced trace (``tracing.Trace``): the
``rrtmgp.*`` ranges that ``rrtmgp_tpu_torch`` opens while a profiler records
(``rrtmgp_tpu_torch.utils.profiling.span``), and each device op put down to
the innermost of them that was open when the host launched it.

The spans are host events of ``Trace.host``, as are the runtime calls that
launch device work. The reduction links each op to the call that launched
it by correlation id (``Trace.launches``), whatever the order in which the
ops ran or the trace listed them, and whichever card they ran on; an op
whose call the trace does not hold is put down to no span, as the
reduction puts it down to no harness span.
"""

from __future__ import annotations

PREFIX = "rrtmgp."


def spans(trace) -> list:
    """(start, end, name) of the program's spans, outer first."""
    return sorted(((s, e, n) for s, e, n in trace.host if n.startswith(PREFIX)), key=lambda p: (p[0], -p[1]))


def launches(trace):
    """For each op of ``trace.device`` the start of the runtime call that
    launched it (None for an op whose call the trace lacks); None where the
    trace keeps no launches (one built by hand)."""
    return trace.launches if len(trace.launches) == len(trace.device) else None


def innermost(nested: list, times: list) -> list:
    """For each time (or None), the name of the innermost of the nested
    spans ((start, end, name), sorted by start, outer first) open at it, or
    None: one sweep in time order with a stack of the open spans."""
    out = [None] * len(times)
    stack, j = [], 0
    for t, i in sorted((t, i) for i, t in enumerate(times) if t is not None):
        while j < len(nested) and nested[j][0] <= t:
            while stack and stack[-1][1] < nested[j][0]:
                stack.pop()
            stack.append(nested[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def program_ops(trace):
    """The window's device ops as (name, start, end, span, program):
    ``program`` the innermost program span open when the host launched the
    op, None where it was launched outside them. None where the trace keeps
    no launches (``launches``)."""
    launch = launches(trace)
    if launch is None:
        return None
    w0, w1 = trace.window
    return [(n, max(s, w0), min(e, w1), sp, p)
            for (n, s, e, sp), p in zip(trace.device, innermost(spans(trace), launch)) if e > w0 and s < w1]
