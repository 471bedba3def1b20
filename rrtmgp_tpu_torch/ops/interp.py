"""Materialized gas optics and row-layout band Planck emission: the optics
kernels of the two-kernel path, with their plain torch twins (counterpart of
``rrtmgp_tpu/ops/pallas_interp.py``).

- ``optics_fused``: tau and the Planck fraction (LW) or the Rayleigh
  single-scattering albedo (SW), each (nlay, ncol, ngpt), written to memory
  (replaces ``optics_fused``). It reads the ``MegaInputs`` and
  ``KernelTables`` the megakernels read. Its twin ``optics_fused_ref`` is the
  one plain definition of the gas optics on those inputs: the megakernels'
  twins (``ops.mega``) call it too.
- ``planck_band_rows``: band Planck emission (N, nbnd), the band index
  fastest (replaces ``planck_band_pallas``); ``planck_band_rows_sets`` the
  same for up to three temperature sets in one launch, as a solve calls it;
  ``ops.mega.planck_band`` / ``planck_band_sets`` are the same function
  with the bands leading (``planck_sets_launch`` launches both).
- ``interp_pt_eta``: one table's (pressure, temperature, eta) interpolation
  per (layer, column, g-point), times col_mix when given (replaces
  ``interp_pt_eta`` and ``interp_pt_eta_windowed``: the port reads whole
  tables, so the two are one function);
- ``interp_minor``: the minor-gas optical depth per (layer, column,
  g-point) (replaces ``interp_minor_merged``);
- ``optics_unfused``: ``optics_fused``'s function from three launches (the
  two tables through ``interp_pt_eta``, the minor gases through
  ``interp_minor``) and a few plain-torch passes, the counterpart of the JAX
  package's unfused optics (``pallas_windowed="off"``).

Each wrapper launches its CUDA kernel (``csrc/optics_fused.cu``,
``csrc/planck_band.cu``, ``csrc/interp_pt_eta.cu``, ``csrc/interp_minor.cu``)
for CUDA tensors and raises on anything the kernel does not take; for CPU
tensors it returns its twin. ``<wrapper>.launches`` counts the launches. The
kernels are f32.
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import (
    PLANCK_SETS,
    check_optics_inputs,
    check_table_size,
    cuda_device,
    gpoint_plan,
    kernel_dtype,
    kernel_plan,
    max_threads,
    optics_input_ptrs,
    ptr,
    require,
    sets_plan,
    smem_limit,
    stream,
    table_ptrs,
)
from .gas_optics import (
    compute_planck_fraction,
    compute_tau_major,
    minor_intervals,
    planck_bands,
    sw_tau_ssa,
    tau_minor_from_scalings,
    tau_rayleigh_from_factor,
)
from .mega_inputs import KernelTables, MegaInputs


def interp_minor_ref(inp: MegaInputs, tabs: KernelTables) -> torch.Tensor:
    """Plain twin of ``interp_minor``: ``ops.gas_optics``' minor-gas optical
    depth on the kernel's inputs. Any float dtype."""
    lkp = tabs.lkp
    scalings = [
        (side, itv, inp.minor_scaling[i])
        for i, (side, itv) in enumerate(minor_intervals(lkp))
    ]
    return tau_minor_from_scalings(lkp, scalings, inp.pt, inp.eta)


def tau_gas(inp: MegaInputs, tabs: KernelTables) -> torch.Tensor:
    """Major + minor optical depth (nlay, ncol, ngpt), not yet clamped."""
    tau = compute_tau_major(tabs.lkp, inp.col_dry, inp.pt, inp.eta)
    return tau.add_(interp_minor_ref(inp, tabs))


#: columns of one optics_fused block: its threads (one per g-point) walk
#: them, so the table lines that neighbouring columns share stay in L1
OPTICS_TILE = 16


def optics_fused_ref(inp: MegaInputs, tabs: KernelTables) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``optics_fused``: ``ops.gas_optics`` on the kernel's
    inputs. LW: (tau clamped at 0, Planck fraction). SW: (tau with Rayleigh
    clamped at 0, ssa = Rayleigh / tau where tau > 0 else 0). Any float
    dtype."""
    lkp = tabs.lkp
    if lkp.is_longwave:
        tau = tau_gas(inp, tabs).clamp_(min=0.0)
        return tau, compute_planck_fraction(lkp, inp.pt, inp.eta)
    tau_ray = tau_rayleigh_from_factor(lkp, inp.ray_factor, inp.pt, inp.eta)
    optics = sw_tau_ssa(tau_gas(inp, tabs), tau_ray)
    return optics.tau, optics.ssa


def optics_fused(inp: MegaInputs, tabs: KernelTables) -> tuple[torch.Tensor, torch.Tensor]:
    """Gas optics per (layer, column, g-point), each (nlay, ncol, ngpt) f32:
    (tau, Planck fraction) for a longwave lookup, (tau, ssa) for a shortwave
    one (``inp`` then carries the Rayleigh column amount)."""
    if inp.jtemp.device.type == "cpu":
        return optics_fused_ref(inp, tabs)
    dev = cuda_device(inp.jtemp, "optics_fused")
    shortwave = not tabs.lkp.is_longwave
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = check_optics_inputs(inp, tabs, dev, shortwave)
    tau = torch.empty((nlay, ncol, ngpt), dtype=torch.float32, device=dev)
    second = torch.empty_like(tau)
    plan = kernel_plan("optics_fused", dev, ngpt, variant=int(shortwave))
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_optics_fused(
            *optics_input_ptrs(inp), ptr(inp.ray_factor if shortwave else None), *table_ptrs(tabs),
            ptr(tau), ptr(second), nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, tabs.n_minor, int(shortwave),
            OPTICS_TILE, plan.group, plan.n_groups, stream(dev),
        )
    _build.check(err, "optics_fused", tau, second)
    optics_fused.launches += 1
    return tau, second


optics_fused.launches = 0


def optics_fused_design(tabs: KernelTables) -> dict:
    """How ``optics_fused`` launches for these tables (on the card): the
    block (one layer, ``tile`` columns, ``group`` threads, one per g-point,
    ``n_groups`` blocks per column tile, the block limit ``max_threads``)
    and its dynamic shared memory."""
    most = max_threads("optics_fused", tabs.kmajor.device, int(not tabs.lkp.is_longwave))
    plan = gpoint_plan(tabs.lkp.n_gpt, max_threads=most)
    smem = _build.library().rrtmgp_optics_fused_smem(OPTICS_TILE, tabs.lkp.n_bnd, tabs.n_minor)
    return dict(tile=OPTICS_TILE, group=plan.group, n_groups=plan.n_groups, smem=smem, max_threads=most)


PLANCK_MAX_BANDS = 256  # a block of the band Planck kernel stages the table with a thread per band or more


def planck_staged_bytes(nbnd: int, n_t: int, itemsize: int) -> int:
    """Shared memory of a band Planck block: the table transposed, (nbnd,
    n_t) with the row stride made odd (``csrc/planck_band.cu``)."""
    return nbnd * (n_t | 1) * itemsize


def temperature_sets(name: str, ts) -> tuple:
    """``ts`` as a tuple of 1 to 3 temperature sets; raises otherwise."""
    ts = tuple(ts)
    if not 1 <= len(ts) <= PLANCK_SETS:
        raise ValueError(f"{name}: {len(ts)} temperature sets, one launch takes 1 to {PLANCK_SETS}")
    return ts


def on_cpu(ts) -> bool:
    """Whether every tensor of ``ts`` lies on the CPU (the wrappers then run
    their twins)."""
    return all(t.device.type == "cpu" for t in ts)


def planck_sets_launch(name: str, ts, totplnk: torch.Tensor, t_min: float, t_delta: float, rows: bool) -> tuple:
    """One launch of ``csrc/planck_band.cu`` over the temperature sets ``ts``
    (1 to 3 CUDA tensors (N_k,)): their band Planck values, (N_k, nbnd)
    with ``rows`` (f32), else (nbnd, N_k) (f32 or f64). Raises on anything
    the kernel does not take; the caller counts the launch."""
    dev = cuda_device(ts[0], name)
    if any(t.dim() != 1 for t in ts) or totplnk.dim() != 2 or totplnk.shape[0] < 2:
        raise ValueError(f"{name}: t {[tuple(t.shape) for t in ts]}, totplnk {tuple(totplnk.shape)}")
    n_t, nbnd = totplnk.shape
    dtype = torch.float32 if rows else kernel_dtype(ts[0], name)
    for k, t in enumerate(ts):
        require(t, "t" if len(ts) == 1 else f"t[{k}]", (t.shape[0],), dtype, dev)
    require(totplnk, "totplnk", (n_t, nbnd), dtype, dev)
    if nbnd > PLANCK_MAX_BANDS:
        raise ValueError(f"{name}: {nbnd} bands, the kernel takes at most {PLANCK_MAX_BANDS}")
    staged = planck_staged_bytes(nbnd, n_t, totplnk.element_size())
    if staged > smem_limit(dev):
        raise ValueError(f"{name}: the table ({n_t} x {nbnd}) takes {staged} bytes of shared memory, more than "
                         f"a block of {dev} may have ({smem_limit(dev)})")
    sizes = [t.shape[0] for t in ts]
    plan = sets_plan(sizes)
    outs = tuple(torch.empty((n, nbnd) if rows else (nbnd, n), dtype=dtype, device=dev) for n in sizes)
    pad = PLANCK_SETS - len(ts)
    lib = _build.library()
    entry = (lib.rrtmgp_planck_band_rows if rows else
             lib.rrtmgp_planck_band if dtype == torch.float32 else lib.rrtmgp_planck_band_f64)
    with torch.cuda.device(dev):
        err = entry(ptr(totplnk), *map(ptr, ts), *[ptr(None)] * pad, *map(ptr, outs), *[ptr(None)] * pad,
                    *sizes, *[0] * pad, *plan.starts[1:], plan.span, nbnd, n_t, t_min, t_delta, stream(dev))
    _build.check(err, name, *outs)
    return outs


def planck_band_rows_ref(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Plain twin of ``planck_band_rows``: (N, nbnd) band Planck values at
    the temperatures ``t`` (N,)."""
    return planck_bands(totplnk, t, t_min, t_delta)


def planck_band_rows_sets(ts, totplnk: torch.Tensor, t_min: float, t_delta: float) -> tuple:
    """Band Planck emission (N_k, nbnd) f32 at each temperature set ``ts[k]``
    (N_k,), 1 to 3 sets, in one launch: linear interpolation of ``totplnk``
    (n_t, nbnd) on the uniform grid (t_min, t_delta); outside the grid the
    end values. Counts on ``planck_band_rows.launches``."""
    ts = temperature_sets("planck_band_rows", ts)
    if on_cpu(ts):
        return tuple(planck_band_rows_ref(t, totplnk, t_min, t_delta) for t in ts)
    outs = planck_sets_launch("planck_band_rows", ts, totplnk, t_min, t_delta, rows=True)
    planck_band_rows.launches += 1
    return outs


def planck_band_rows(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """``planck_band_rows_sets`` of the one set ``t``."""
    return planck_band_rows_sets((t,), totplnk, t_min, t_delta)[0]


planck_band_rows.launches = 0


def _band_ranges(gpt2band: torch.Tensor) -> list:
    """(band, g0, g1) of each run of equal bands in ``gpt2band``."""
    g2b = gpt2band.tolist()
    starts = [g for g in range(len(g2b)) if g == 0 or g2b[g] != g2b[g - 1]] + [len(g2b)]
    return [(g2b[g0], g0, g1) for g0, g1 in zip(starts[:-1], starts[1:])]


def interp_pt_eta_ref(table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band,
                      col_mix1=None, col_mix2=None) -> torch.Tensor:
    """Plain twin of ``interp_pt_eta``, written from ``ops.gas_optics``'
    ``_interp3d`` on the g-point-fastest table: per band, two gathered table
    rows per (pressure, temperature, eta) corner. A pressure node past the
    table's last slab is not read: its weight ``fpress`` is 0 by
    construction and it contributes ``fpress * 0``, as in the kernel. Any
    float dtype."""
    n_p, ntemp, neta, ngpt = table.shape
    tab = table.reshape(-1, ngpt)
    slab = ntemp * neta
    fp = fpress[..., None]
    ft = ftemp[..., None]
    jp = jpress.long()
    jt = jtemp.long()
    above = (jp + 1 < n_p)[..., None]
    jp_above = torch.where(jp + 1 < n_p, jp + 1, jp)  # a row that exists; its value is not used past the table
    pieces = []
    for band, g0, g1 in _band_ranges(gpt2band):
        tb = tab[:, g0:g1]
        out = 0.0
        for half in (0, 1):
            je = (jeta1 if half == 0 else jeta2)[..., band].long()
            fe = (feta1 if half == 0 else feta2)[..., band, None]
            row = (jp * ntemp + jt + half) * neta + je  # (nlay, ncol)
            row_above = row + (jp_above - jp) * slab
            node0 = (1.0 - fp) * tb[row] + fp * torch.where(above, tb[row_above], 0.0)
            node1 = (1.0 - fp) * tb[row + 1] + fp * torch.where(above, tb[row_above + 1], 0.0)
            val = node0 * (1.0 - fe) + node1 * fe
            if col_mix1 is not None:
                val = val * (col_mix1 if half == 0 else col_mix2)[..., band, None]
            out = out + (ft if half else 1.0 - ft) * val
        pieces.append(out)
    return torch.cat(pieces, dim=-1)


def interp_pt_eta_dims(dev, table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band,
                       col_mix1=None, col_mix2=None) -> tuple:
    """The checks ``interp_pt_eta`` makes before it hands its arguments to
    the kernel on ``dev``: a table of fewer than 2^31 elements (the kernel
    stages 32-bit offsets) with a cell to interpolate in, and contiguous
    inputs of the kernel's dtypes and shapes. Returns (nlay, ncol, ngpt,
    nbnd, npress, ntemp, neta)."""
    if table.dim() != 4 or jtemp.dim() != 2 or jeta1.dim() != 3:
        raise ValueError(f"interp_pt_eta: table {tuple(table.shape)}, jtemp {tuple(jtemp.shape)}, "
                         f"jeta1 {tuple(jeta1.shape)}")
    check_table_size("table", table)
    n_p, ntemp, neta, ngpt = table.shape
    (nlay, ncol), nbnd = jtemp.shape, jeta1.shape[2]
    if n_p < 1 or ntemp < 2 or neta < 2 or ngpt < 1:
        raise ValueError(f"interp_pt_eta: table {tuple(table.shape)} has no cell to interpolate in")
    f32, i32 = torch.float32, torch.int32
    lc, lcb = (nlay, ncol), (nlay, ncol, nbnd)
    require(table, "table", (n_p, ntemp, neta, ngpt), f32, dev)
    for name, t, shape, dtype in (
        ("jtemp", jtemp, lc, i32), ("ftemp", ftemp, lc, f32), ("jpress", jpress, lc, i32),
        ("fpress", fpress, lc, f32), ("jeta1", jeta1, lcb, i32), ("feta1", feta1, lcb, f32),
        ("jeta2", jeta2, lcb, i32), ("feta2", feta2, lcb, f32), ("gpt2band", gpt2band, (ngpt,), i32),
    ):
        require(t, name, shape, dtype, dev)
    if col_mix1 is not None:
        require(col_mix1, "col_mix1", lcb, f32, dev)
        require(col_mix2, "col_mix2", lcb, f32, dev)
    return nlay, ncol, ngpt, nbnd, n_p, ntemp, neta


#: columns of one interp_pt_eta block, as OPTICS_TILE for optics_fused
INTERP_TILE = 16


def interp_pt_eta_design(ngpt: int, nbnd: int, device: torch.device) -> dict:
    """How ``interp_pt_eta`` launches for ``ngpt`` g-points in ``nbnd``
    bands on ``device`` (the card): the block (one layer, ``tile`` columns,
    ``group`` threads, one per g-point, ``n_groups`` blocks per column tile,
    the block limit ``max_threads``) and its dynamic shared memory."""
    most = max_threads("interp_pt_eta", device)
    plan = gpoint_plan(ngpt, max_threads=most)
    smem = _build.library().rrtmgp_interp_pt_eta_smem(INTERP_TILE, nbnd)
    return dict(tile=INTERP_TILE, group=plan.group, n_groups=plan.n_groups, smem=smem, max_threads=most)


def interp_pt_eta(table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band,
                  col_mix1=None, col_mix2=None) -> torch.Tensor:
    """(nlay, ncol, ngpt) f32: trilinear interpolation of a g-point-fastest
    table (npress, ntemp, neta, ngpt) at the (layer, column) nodes ``jpress``
    (the lower pressure slab), ``jtemp`` with fractions ``fpress``,
    ``ftemp`` (each (nlay, ncol)) and the per-band eta nodes ``jeta1`` /
    ``feta1`` (lower temperature node) and ``jeta2`` / ``feta2`` (upper),
    each (nlay, ncol, nbnd), g-point g reading band ``gpt2band[g]``. Each
    temperature node's value is scaled by its ``col_mix1`` / ``col_mix2``
    (nlay, ncol, nbnd) when given (both or neither)."""
    if (col_mix1 is None) != (col_mix2 is None):
        raise ValueError("interp_pt_eta: give both col_mix1 and col_mix2, or neither")
    if jtemp.device.type == "cpu":
        return interp_pt_eta_ref(table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band,
                                 col_mix1, col_mix2)
    dev = cuda_device(jtemp, "interp_pt_eta")
    nlay, ncol, ngpt, nbnd, n_p, ntemp, neta = interp_pt_eta_dims(
        dev, table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band, col_mix1, col_mix2)
    plan = kernel_plan("interp_pt_eta", dev, ngpt)
    out = torch.empty((nlay, ncol, ngpt), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_interp_pt_eta(
            ptr(table), ptr(jtemp), ptr(ftemp), ptr(jpress), ptr(fpress), ptr(jeta1), ptr(feta1),
            ptr(col_mix1), ptr(jeta2), ptr(feta2), ptr(col_mix2), ptr(gpt2band), ptr(out),
            nlay, ncol, ngpt, nbnd, n_p, ntemp, neta, INTERP_TILE, plan.group, plan.n_groups,
            stream(dev),
        )
    _build.check(err, "interp_pt_eta", out)
    interp_pt_eta.launches += 1
    return out


interp_pt_eta.launches = 0


#: columns of one interp_minor block, as OPTICS_TILE for optics_fused
MINOR_TILE = 16


def interp_minor_design(tabs: KernelTables) -> dict:
    """How ``interp_minor`` launches for these tables (on the card): the
    block (one layer, ``tile`` columns, ``group`` threads, one per g-point,
    ``n_groups`` blocks per column tile, the block limit ``max_threads``)
    and its dynamic shared memory."""
    most = max_threads("interp_minor", tabs.kminor.device)
    plan = gpoint_plan(tabs.lkp.n_gpt, max_threads=most)
    smem = _build.library().rrtmgp_interp_minor_smem(MINOR_TILE, tabs.lkp.n_bnd, tabs.n_minor)
    return dict(tile=MINOR_TILE, group=plan.group, n_groups=plan.n_groups, smem=smem, max_threads=most)


def interp_minor(inp: MegaInputs, tabs: KernelTables) -> torch.Tensor:
    """Minor-gas optical depth (nlay, ncol, ngpt) f32 of ``MegaInputs``:
    per minor interval covering a g-point on the cell's troposphere side, a
    (temperature, eta) interpolation of its kminor rows times its scaling."""
    if inp.jtemp.device.type == "cpu":
        return interp_minor_ref(inp, tabs)
    dev = cuda_device(inp.jtemp, "interp_minor")
    dims = check_optics_inputs(inp, tabs, dev, not tabs.lkp.is_longwave)
    nlay, ncol, ngpt = dims[:3]
    plan = kernel_plan("interp_minor", dev, ngpt)
    out = torch.empty((nlay, ncol, ngpt), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_interp_minor(
            *optics_input_ptrs(inp), *table_ptrs(tabs)[2:], ptr(out), *dims, tabs.n_minor, MINOR_TILE,
            plan.group, plan.n_groups, stream(dev),
        )
    _build.check(err, "interp_minor", out)
    interp_minor.launches += 1
    return out


interp_minor.launches = 0


def optics_unfused(inp: MegaInputs, tabs: KernelTables) -> tuple[torch.Tensor, torch.Tensor]:
    """``optics_fused``'s function, unfused (the JAX package's
    ``pallas_windowed="off"`` optics): ``interp_pt_eta`` of kmajor with
    col_mix, times col_dry, plus ``interp_minor``; LW: clamped at 0, and
    ``interp_pt_eta`` of the Planck fraction without col_mix; SW: plus the
    Rayleigh optical depth, ``interp_pt_eta`` of the Rayleigh table at the
    troposphere side's slab with fpress = 0, without col_mix, times the
    Rayleigh column amount, then ``gas_optics.sw_tau_ssa``. The Rayleigh
    depth enters ssa unclamped, as on the XLA path (the JAX unfused optics
    clamps it; the tables make it positive). Three launches on CUDA tensors
    (their twins on CPU tensors); the same values as ``optics_fused`` bit for
    bit."""
    eta = (inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tabs.gpt2band)
    pt = (inp.jtemp, inp.ftemp)
    tau = interp_pt_eta(tabs.kmajor, *pt, inp.jpress_base, inp.fpress, *eta, inp.col_mix1, inp.col_mix2)
    tau = tau.mul_(inp.col_dry[..., None]).add_(interp_minor(inp, tabs))
    if tabs.lkp.is_longwave:
        return tau.clamp_(min=0.0), interp_pt_eta(tabs.second, *pt, inp.jpress_base, inp.fpress, *eta)
    side = (~inp.tropo_lower).to(torch.int32)  # the Rayleigh table's slab: 0 below the tropopause, 1 above
    ray = interp_pt_eta(tabs.second, *pt, side, torch.zeros_like(inp.fpress), *eta)
    optics = sw_tau_ssa(tau, ray.mul_(inp.ray_factor[..., None]))
    return optics.tau, optics.ssa
