"""Host milliseconds a step of the program's own work at its API layer:
the time inside the program's spans ``rrtmgp.update_lw_fluxes`` and
``rrtmgp.update_sw_fluxes`` less the time in CUDA API calls
(``cu*`` host events) within them, where the host waits on the card's
queue; what is left is Python, dispatch and the profiler's own per-op
bookkeeping (read under the profiler, so it carries part of its cost, as
``host_enqueue_ms`` does). None where the trace holds neither span."""

import bisect

from portbench.program_spans import spans as program_spans

SPANS = ("rrtmgp.update_lw_fluxes", "rrtmgp.update_sw_fluxes")


def _waited(host: list, s: int, e: int) -> int:
    """Nanoseconds of (s, e) covered by ``cu*`` host events."""
    lo, hi = bisect.bisect_left(host, (s,)), bisect.bisect_right(host, (e, float("inf"), ""))
    ns, reach = 0, s
    for hs, he, name in host[lo:hi]:
        if name.startswith("cu"):
            a, b = max(hs, reach), min(he, e)
            if b > a:
                ns, reach = ns + b - a, b
    return ns


def read(ctx):
    if ctx.trace is None:
        return None
    spans = [(s, e) for s, e, name in program_spans(ctx.trace) if name in SPANS]
    if not spans:
        return None
    return sum(e - s - _waited(ctx.trace.host, s, e) for s, e in spans) / 1e6 / ctx.steps
