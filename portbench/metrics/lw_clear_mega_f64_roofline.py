"""Share of its roofline that the f64 build of the lw_clear_mega kernel (K7)
reaches: the least time of the LW solve on the card (its algorithmic
operations at the f64 peak or its inputs, tables and fluxes, counted from
the f64 tensors, at the memory rate, the larger) over the device time a
step of the kernel's ``double`` instantiations, one a column chunk. None
where the step launches no ``double`` one (every f32 cell)."""

from portbench.tracing import base_name, short_name
from portbench.work import PEAK_F64_OPS_PER_S, least_seconds

KERNEL = "lw_clear_mega_kernel"


def is_double(name: str) -> bool:
    """Whether a device op is an instantiation of the kernel on ``double``
    (its first template argument)."""
    head = short_name(name)
    return base_name(name) == KERNEL and "<" in head and head.split("<", 1)[1].split(",")[0].strip() == "double"


def read(ctx):
    if ctx.trace is None:
        return None
    ns = sum(e - s for n, s, e, _ in ctx.trace.in_window() if is_double(n))
    if not ns:
        return None
    return 100.0 * least_seconds(*ctx.work["lw"], PEAK_F64_OPS_PER_S) * ctx.steps / (ns / 1e9)
