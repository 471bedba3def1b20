"""Profiling and benchmarking utilities (counterpart of
``rrtmgp_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of the host and, on a card,
the device (CUDA kernels by name, the port's hand-written ones among them)
as a Chrome trace viewable in Perfetto; ``span`` names a stretch of the
program in that trace; ``benchmark`` runs a synchronised timing loop and
reports median/min as the JAX package's does; ``device_memory_stats``
reads the caching allocator's statistics.

The program's spans (host ranges on the profiler's own clock, beside the
device activity) record only while a profiler runs; with none running a
span costs one check. A radiation step opens, on the megakernel route (the
default for f32 on the card)::

    rrtmgp.update_lw_fluxes      RRTMGPSolver.update_lw_fluxes: chunking,
    |                            the mesh split, the clear-sky diagnostics
    `- rrtmgp.lw                 solve_lw, one solve: its self time is the
       |                         night masks, net flux and scaling
       |- rrtmgp.lw.inputs       pt and eta interpolation, minor scalings
       |- rrtmgp.lw.clouds       the cloud_bands kernel
       |- rrtmgp.lw.aerosols     the aerosol_bands kernel and properties
       |- rrtmgp.lw.planck       the planck_band kernel, every set at once
       `- rrtmgp.lw.solve        lw_clear_mega (each angle, their sum) or
                                 lw2_mega
    rrtmgp.update_sw_fluxes
    `- rrtmgp.sw                 solve_sw
       |- rrtmgp.sw.clouds       the cloud_bands kernel, delta-scaled
       |- rrtmgp.sw.aerosols
       |- rrtmgp.sw.inputs       pt and eta interpolation, Rayleigh factor
       `- rrtmgp.sw.solve        sw_clear_mega

``clouds`` and ``aerosols`` open only where the solver has clouds and
aerosols. The two-kernel, sweep and torch routes open ``rrtmgp.lw`` and
``rrtmgp.sw`` without children.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time

import torch

from ..states import tree_leaves

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is recording, else a
    shared context that does nothing.

    The range is a function-scope one, as an operator's own: it shows on
    the host thread above the operators and launches it holds. A
    ``record_function`` range is a user annotation instead, which the
    profiler also copies onto the device timeline over the kernels it
    launched, so that each span would stand among the device's operations
    as if it were one."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a profiler trace of the enclosed block: CPU activity, and
    CUDA activity where there is a card. On exit the Chrome trace is written
    to ``log_dir/trace.json`` (``log_dir`` None: a directory of that name
    in the temporary directory). Yields ``log_dir``.

    The program's spans (the module docstring's tree) record inside it and
    show in Perfetto as named ranges on the host thread, each above the
    operations and kernel launches it holds."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rrtmgp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _done(out) -> None:
    """Wait for ``out``: synchronise the card and read one element of the
    first tensor back to the host."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    leaves = tree_leaves(out if isinstance(out, tuple) else (out,))
    if leaves:
        leaves[0].reshape(-1)[:1].cpu()


def benchmark(fn, *args, n_iters: int = 10, warmup: int = 1, label: str = ""):
    """Median/min wall-time of ``fn(*args)`` with full device sync: the
    card synchronised before each call and after it, with a read-back of
    its first output tensor to the host.

    Returns dict(label, median_s, min_s, n_iters), the keys of the JAX
    package's ``benchmark``.
    """
    for _ in range(warmup):
        _done(fn(*args))
    times = []
    for _ in range(n_iters):
        _done(None)
        t0 = time.perf_counter()
        _done(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "label": label,
        "median_s": statistics.median(times),
        "min_s": min(times),
        "n_iters": n_iters,
    }


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each visible card, by device name
    ("cuda:0", ...); {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
