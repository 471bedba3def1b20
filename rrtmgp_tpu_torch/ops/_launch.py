"""Argument plumbing shared by the kernel wrappers: raw pointers and the
current stream for the ctypes calls, the checks a wrapper makes before it
hands a tensor to a kernel, the checks and pointer lists of the gas-optics
inputs (``MegaInputs``) and tables (``KernelTables``) that the megakernels
and the materialized-optics kernel share, and the launch plans of the
kernels that run one thread per g-point (``gpoint_plan``, sized by the
kernel's own limit of threads a block, ``max_threads``), and the plan of the
band Planck kernel over the temperature sets of one launch
(``sets_plan``)."""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape/dtype on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    """The tensor's CUDA device; raises for any device other than CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on CUDA, "
                         "the plain version on CPU")
    return t.device


KERNEL_DTYPES = (torch.float32, torch.float64)


def kernel_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 or float64")
    return t.dtype


TABLE_ELEMENTS = 2**31  # the kernels index a table with 32-bit offsets


def check_table_size(name: str, t: torch.Tensor) -> None:
    """Raise unless the table ``t`` has fewer than 2^31 elements, as the
    kernels that stage 32-bit table offsets (csrc/gather.cuh) need."""
    if t.numel() >= TABLE_ELEMENTS:
        raise ValueError(f"{name}: {t.numel()} elements; the kernels index the tables with 32-bit offsets "
                         "(fewer than 2^31 elements)")


def check_optics_inputs(inp, tabs, dev, shortwave: bool, dtype: torch.dtype = torch.float32) -> tuple:
    """Check the gas-optics inputs (MegaInputs) and tables (KernelTables) of
    a kernel built for ``dtype`` (any number of g-points from 1); returns
    (nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib)."""
    lkp = tabs.lkp
    nlay, ncol = inp.nlay, inp.ncol
    ngpt, nbnd = lkp.n_gpt, lkp.n_bnd
    if ngpt < 1:
        raise ValueError(f"n_gpt={ngpt}: the kernels take 1 g-point or more")
    real, i32 = dtype, torch.int32
    lc, lcb = (nlay, ncol), (nlay, ncol, nbnd)
    for name, shape, dtype in (
        ("jtemp", lc, i32), ("ftemp", lc, real), ("jpress_base", lc, i32),
        ("fpress", lc, real), ("tropo_lower", lc, torch.bool), ("col_dry", lc, real),
        ("jeta1", lcb, i32), ("feta1", lcb, real), ("col_mix1", lcb, real),
        ("jeta2", lcb, i32), ("feta2", lcb, real), ("col_mix2", lcb, real),
        ("minor_scaling", (tabs.n_minor, nlay, ncol), real),
    ):
        require(getattr(inp, name), name, shape, dtype, dev)
    if shortwave:
        require(inp.ray_factor, "ray_factor", lc, real, dev)
    ntemp, neta = lkp.n_temp, lkp.n_eta
    npp = tabs.kmajor.shape[0]
    ncontrib = tabs.kminor.shape[-1]
    second = (2, ntemp, neta, ngpt) if shortwave else (npp, ntemp, neta, ngpt)
    for name in ("kmajor", "second", "kminor"):
        check_table_size(name, getattr(tabs, name))
    for name, shape, dtype in (
        ("kmajor", (npp, ntemp, neta, ngpt), real), ("second", second, real),
        ("kminor", (ntemp, neta, ncontrib), real), ("gpt2band", (ngpt,), i32),
        ("minor_start", (2, ngpt + 1), i32),
        ("minor_list", tuple(tabs.minor_list.shape), i32),
        ("minor_kbase", (tabs.n_minor,), i32), ("minor_band", (tabs.n_minor,), i32),
    ):
        require(getattr(tabs, name), name, shape, dtype, dev)
    return nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib


def optics_input_ptrs(inp) -> list:
    return [ptr(getattr(inp, k)) for k in (
        "jtemp", "ftemp", "jpress_base", "fpress", "tropo_lower", "col_dry",
        "jeta1", "feta1", "col_mix1", "jeta2", "feta2", "col_mix2", "minor_scaling",
    )]


def table_ptrs(tabs) -> list:
    return [ptr(getattr(tabs, k)) for k in (
        "kmajor", "second", "kminor", "gpt2band",
        "minor_start", "minor_list", "minor_kbase", "minor_band",
    )]


# ---------------------------------------------------------------------------
# Launch plans of the kernels that run one thread per g-point
# ---------------------------------------------------------------------------

WARP = 32
MAX_THREADS = 1024  # threads of one block on the device, the most any kernel may have


class LaunchPlan(NamedTuple):
    """How a kernel of one thread per g-point covers a column: ``n_groups``
    blocks (gridDim.y) of ``group`` threads, whole warps, with g-point g =
    blockIdx.y * group + threadIdx.x. With ``in_block`` the level sums are
    added in the block (shared memory), as the kernels do when a column is
    one block and its sums fit; without, each warp writes its partial to a
    device buffer (``level_partials``) and a second kernel adds a column's
    partials in warp order 0, 1, ..., which is g-point order, as the
    in-block sum does: the same bits."""

    group: int
    n_groups: int
    in_block: bool = True

    @property
    def grouped(self) -> bool:
        return self.n_groups > 1


def in_block_bytes(group: int, nlay: int, fields: int, itemsize: int) -> int:
    """Shared memory of a block's in-block level sums: one slot per field,
    level and warp."""
    return fields * (nlay + 1) * (group // WARP) * itemsize


def gpoint_plan(ngpt: int, nlay: int = 0, fields: int = 0, itemsize: int = 4, staged: int = 0,
                limit: int | None = None, max_threads: int = MAX_THREADS, per_thread: int = 0) -> LaunchPlan:
    """The plan of every kernel of one thread per g-point: up to
    ``max_threads`` g-points (the most threads a block of the kernel may
    have, ``max_threads(kernel, device)`` on the card) one block per column,
    beyond the fewest groups of at most that many threads, equal in whole
    warps. A column of one block adds its ``fields`` level sums of ``nlay +
    1`` levels (reals of ``itemsize`` bytes) in the block when they and the
    ``staged`` bytes the kernel keeps in shared memory of its own (and
    ``per_thread`` bytes for each thread of the block) fit the device's
    opt-in limit per block (``limit``, ``smem_limit(device)`` on the card);
    else in device memory, through the same warp-order sum. ``limit`` may
    be None only for a kernel without shared memory (no fields, nothing
    staged)."""
    if ngpt < 1:
        raise ValueError(f"n_gpt={ngpt}: the kernels take 1 g-point or more")
    most = min(max_threads, MAX_THREADS) // WARP * WARP
    if most < WARP:
        raise ValueError(f"gpoint_plan: a block of at most {max_threads} threads holds no warp")
    n_groups = math.ceil(ngpt / most)
    group = -(-math.ceil(ngpt / n_groups) // WARP) * WARP
    staged += per_thread * group
    if not (fields or staged):
        return LaunchPlan(group, n_groups, n_groups == 1)
    if limit is None:
        raise ValueError("gpoint_plan: a kernel with shared memory needs the device's limit")
    if staged > limit:
        raise ValueError(f"gpoint_plan: {staged} bytes staged per block, the device allows {limit}")
    fits = staged + in_block_bytes(group, nlay, fields, itemsize) <= limit
    return LaunchPlan(group, n_groups, n_groups == 1 and fits)


#: each kernel's last plan, (plan, max_threads) by name, as ``kernel_plan``
#: made it: what a launch ran with (chip_smoke.py prints them)
LAST_PLANS: dict[str, tuple[LaunchPlan, int]] = {}


def kernel_plan(kernel: str, device: torch.device, ngpt: int, nlay: int = 0, fields: int = 0, itemsize: int = 4,
                staged: int = 0, variant: int = 0, per_thread: int = 0) -> LaunchPlan:
    """``gpoint_plan`` of the kernel ``kernel`` (instance ``variant``) on
    ``device``, with its block limit ``max_threads`` and, for a kernel with
    level sums or shared memory of its own, the device's shared-memory
    limit."""
    most = max_threads(kernel, device, variant)
    limit = smem_limit(device) if (fields or staged or per_thread) else None
    plan = gpoint_plan(ngpt, nlay, fields, itemsize, staged, limit, most, per_thread)
    LAST_PLANS[kernel] = (plan, most)
    return plan


@functools.cache
def _smem_optin(index: int) -> int:
    from . import _build

    value = ctypes.c_int(0)
    _build.check(_build.library().rrtmgp_smem_optin(index, ctypes.byref(value)), "cudaDeviceGetAttribute")
    return value.value


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def smem_limit(device: torch.device) -> int:
    """The most dynamic shared memory a block of ``device`` may opt in to
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), read once per device."""
    return _smem_optin(_index(device))


@functools.cache
def _max_threads(kernel: str, variant: int, index: int) -> int:
    from . import _build

    value = ctypes.c_int(0)
    _build.check(_build.library().rrtmgp_max_threads(kernel.encode(), variant, index, ctypes.byref(value)),
                 f"cudaFuncGetAttributes({kernel})")
    return value.value


def max_threads(kernel: str, device: torch.device, variant: int = 0) -> int:
    """The most threads a block of ``kernel`` (its wrapper's name) may have
    on ``device``: cudaFuncAttributes.maxThreadsPerBlock of the template
    instance ``variant`` (csrc/errors.cu ``rrtmgp_max_threads`` says what it
    encodes), the smaller of its two variants, level sums in the block and
    split, so that the plan holds whichever one it chooses. Read once per
    device and instance. A kernel of R registers a thread fits about 65536 / R
    threads a block."""
    return _max_threads(kernel, variant, _index(device))


def level_partials(plan: LaunchPlan, nf: int, nlev: int, ncol: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor | None:
    """The device buffer of the warp partials, (fields, levels, columns,
    warps of a column), or None when a column's sums stay in its block."""
    if plan.in_block:
        return None
    return torch.empty((nf, nlev, ncol, plan.n_groups * plan.group // WARP), dtype=dtype, device=device)


def cover_counts(plan: LaunchPlan, ncol: int, seeded: bool, device: torch.device) -> torch.Tensor | None:
    """Each block's count of cloudy g-points, (ncol, n_groups) int32, that a
    launch with its sums in device memory adds up to the McICA cloud cover;
    None otherwise."""
    if not seeded or plan.in_block:
        return None
    return torch.empty((ncol, plan.n_groups), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Launch plan of the band Planck kernel over several temperature sets
# ---------------------------------------------------------------------------

PLANCK_SETS = 3       # temperature sets of one launch (csrc/planck_band.cu kPlanckSets)
PLANCK_SPAN = 1024    # points a block covers, looping: the table is staged once per block
POINTS_LIMIT = 2**31  # the kernel indexes a set's points with 32-bit ints


class SetsPlan(NamedTuple):
    """How one launch of ``csrc/planck_band.cu`` covers 1-3 temperature
    sets: set k owns the blocks ``starts[k]`` to ``starts[k + 1] - 1``, its
    block ``starts[k] + m`` the points ``m * span`` to ``(m + 1) * span -
    1`` (the last block fewer). ``starts`` has ``PLANCK_SETS + 1`` entries,
    the last the grid; a set of 0 points, and every set past those given,
    owns no block."""

    starts: tuple
    span: int

    @property
    def grid(self) -> int:
        return self.starts[-1]


def sets_plan(sizes, span: int = PLANCK_SPAN) -> SetsPlan:
    """The plan of one launch over sets of ``sizes`` points (1 to
    ``PLANCK_SETS`` sets, each of 0 to 2^31 - 1 points)."""
    sizes = list(sizes)
    if not 1 <= len(sizes) <= PLANCK_SETS:
        raise ValueError(f"sets_plan: {len(sizes)} sets, one launch takes 1 to {PLANCK_SETS}")
    if span < 1:
        raise ValueError(f"sets_plan: span {span}, a block covers 1 point or more")
    starts = [0]
    for n in sizes:
        if not 0 <= n < POINTS_LIMIT:
            raise ValueError(f"sets_plan: a set of {n} points; the kernel takes 0 to {POINTS_LIMIT - 1}")
        starts.append(starts[-1] + -(-n // span))
    starts += [starts[-1]] * (PLANCK_SETS + 1 - len(starts))
    if starts[-1] >= POINTS_LIMIT:
        raise ValueError(f"sets_plan: {starts[-1]} blocks, more than a grid may have")
    return SetsPlan(tuple(starts), span)


def block_points(plan: SetsPlan, sizes, block: int) -> tuple[int, range]:
    """The set and the points of block ``block``, as the kernel finds them
    (``planck_block``): the last set that starts at or before the block."""
    k = max(i for i in range(PLANCK_SETS) if plan.starts[i] <= block)
    first = (block - plan.starts[k]) * plan.span
    return k, range(first, min(first + plan.span, sizes[k]))
