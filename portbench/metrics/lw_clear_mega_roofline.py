"""Share of its roofline that the lw_clear_mega kernel reaches: the least time of
the LW solve on the card (its algorithmic operations at the f32 peak or its
inputs, tables and fluxes at the memory rate, the larger) over the
kernel's device time a step. None where the step does not launch it."""

from portbench.tracing import kernel_ns
from portbench.work import least_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    ns = kernel_ns(ctx.trace, "lw_clear_mega_kernel")
    if not ns:
        return None
    return 100.0 * least_seconds(*ctx.work["lw"]) * ctx.steps / (ns / 1e9)
