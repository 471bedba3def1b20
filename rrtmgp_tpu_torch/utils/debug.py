"""Debug-mode helpers (counterpart of ``rrtmgp_tpu/utils/debug.py``): the
port's analogue of the reference's quality gates.

- ``strict_mode``: raise ``FloatingPointError`` on the first NaN an
  operation produces inside the block, as ``jax.debug_nans`` does: a
  dispatch mode checks every floating output of every operation, and the
  CUDA kernel wrappers, whose kernels write their outputs through raw
  pointers where no operation sees them, check their outputs too
  (``check_kernel_outputs``, called by ``ops._build.check``); autograd's
  anomaly detection is on as well.
- ``assert_compiles_once``: fail when the block compiles again what it
  should compile at most once. The port has no tracer: its compilations
  are the nvcc build of the kernel library (``ops._build.build``) and the
  build of a lookup's staged kernel tables (``GasLookup.kernel_tables``),
  both reported through ``note_compile``.
- ``check_window``: True always; the port reads whole tables, it has no
  table windows.

Each check costs a device synchronisation per operation: for debugging,
not for production runs.
"""

from __future__ import annotations

import contextlib

import torch

#: the logs of the ``assert_compiles_once`` blocks open now
_COMPILE_LOGS: list[list[str]] = []
#: ``strict_mode(nans=True)`` blocks open now
_NAN_BLOCKS = [0]
#: operations whose output holds no computed value (uninitialised storage)
_NO_VALUE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_", "set_"}


def _has_nan(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any())


class _NanCheck(torch.utils._python_dispatch.TorchDispatchMode):
    """Raise on the first floating output of an operation that holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _NO_VALUE:
            return out
        if any(_has_nan(t) for t in torch.utils._pytree.tree_leaves(out)):
            raise FloatingPointError(f"strict_mode: {func} produced a NaN")
        return out


def check_kernel_outputs(name: str, outputs) -> None:
    """Inside ``strict_mode``: raise ``FloatingPointError`` if a kernel
    output holds a NaN (the kernel wrote it where no operation sees it)."""
    if _NAN_BLOCKS[0] and any(_has_nan(t) for t in outputs):
        raise FloatingPointError(f"strict_mode: the {name} kernel wrote a NaN")


@contextlib.contextmanager
def strict_mode(nans: bool = True, leaks: bool = True):
    """Raise ``FloatingPointError`` on the first NaN produced inside the
    block, by an operation or a kernel, with autograd's anomaly detection
    on. ``leaks`` is kept for the JAX package's signature and does nothing:
    torch has no tracers to leak. ``nans=False`` makes the block a plain
    block."""
    if not nans:
        yield
        return
    _NAN_BLOCKS[0] += 1
    try:
        with torch.autograd.set_detect_anomaly(True), _NanCheck():
            yield
    finally:
        _NAN_BLOCKS[0] -= 1


def note_compile(kind: str, key: str) -> None:
    """Record a compilation (``kind`` "nvcc" or "kernel_tables"; ``key``
    what was compiled) in every ``assert_compiles_once`` block open now."""
    for log in _COMPILE_LOGS:
        log.append(f"{kind} {key}")


@contextlib.contextmanager
def assert_compiles_once(fn_name: str = ""):
    """Fail if the enclosed block compiles the same thing twice: the kernel
    library (an nvcc build) or one lookup's kernel tables (the same band
    set, g-points, dtype and device) more than once, the analogue of the
    reference's zero-allocation hot path. Yields the log of the block's
    compilations, one line each; with ``fn_name`` only lines containing it
    count. Raises ``AssertionError`` when the block ends."""
    log: list[str] = []
    _COMPILE_LOGS.append(log)
    try:
        yield log
    finally:
        _COMPILE_LOGS.remove(log)
    counted = [line for line in log if fn_name in line]
    repeated = sorted({line for line in counted if counted.count(line) > 1})
    if repeated:
        raise AssertionError(f"compiled more than once in the block: {repeated} (log: {log})")


def check_window(lkp, as_, window: int) -> bool:
    """True: the port reads whole tables, so every layer's rows always fit
    (``RRTMGPSolver.check_window`` likewise). Kept for the JAX package's
    signature, where the force-mode megakernel window can be violated."""
    return True
