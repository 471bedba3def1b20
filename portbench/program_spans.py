"""The program's own spans in a reduced trace (``tracing.Trace``): the
``rrtmgp.*`` ranges that ``rrtmgp_tpu_torch`` opens while a profiler records
(``rrtmgp_tpu_torch.utils.profiling.span``), and each device op put down to
the innermost of them that was open when the host launched it.

The spans are host events of ``Trace.host``, as are the runtime calls that
launch device work; of an op's launch ``Trace.device`` keeps only the
harness span it fell in. The ops of a window run on one stream in the order
the host launched them, one op to each launching runtime call, so the k-th
launch of the trace is the k-th op to start on the device. ``launches``
pairs them so, and checks each pair against the harness span that the
reduction linked the op to; where that does not hold, the readers of
device time by program span leave their metrics out rather than guess.
"""

from __future__ import annotations

import bisect

from portbench import tracing

PREFIX = "rrtmgp."
#: what a runtime call's name holds when it puts one op on the device
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")


def spans(trace) -> list:
    """(start, end, name) of the program's spans, outer first."""
    return sorted(((s, e, n) for s, e, n in trace.host if n.startswith(PREFIX)), key=lambda p: (p[0], -p[1]))


def _launch_calls(trace) -> list:
    """Start times of the runtime calls that launch device ops, in order;
    a call made inside another (the runtime's own driver call) is the
    outer call's launch, not one of its own."""
    out, reach = [], None
    for s, e, n in trace.host:
        if n.startswith("cu") and any(w in n for w in LAUNCH_WORDS):
            if reach is not None and s <= reach:
                continue
            out.append(s)
            reach = e
    return out


def launches(trace):
    """For each op of ``trace.device`` the start of the runtime call that
    launched it, paired in order; None where the pairing does not hold: the
    trace's launches and ops differ in number, or a paired launch fell
    outside the harness span that the reduction linked the op to."""
    calls = _launch_calls(trace)
    order = sorted(range(len(trace.device)), key=lambda i: trace.device[i][1])
    if len(calls) != len(order):
        return None
    harness = sorted((s, e, n[len(tracing.PREFIX):]) for s, e, n in trace.host
                     if n.startswith(tracing.PREFIX) and n[len(tracing.PREFIX):] in tracing.STEP_SPANS)
    starts = [s for s, _, _ in harness]

    def harness_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return harness[i][2] if i >= 0 and harness[i][1] >= t else None

    launch = [None] * len(order)
    for i, t in zip(order, calls):
        if harness_at(t) != trace.device[i][3]:
            return None
        launch[i] = t
    return launch


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
    op, None where it was launched outside them. None where the launches do
    not pair with the ops (``launches``)."""
    launch = launches(trace)
    if launch is None:
        return None
    w0, w1 = trace.window
    return [(n, max(s, w0), min(e, w1), sp, p)
            for (n, s, e, sp), p in zip(trace.device, innermost(spans(trace), launch)) if e > w0 and s < w1]
