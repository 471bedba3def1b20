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
  fastest (replaces ``planck_band_pallas``); ``ops.mega.planck_band`` is the
  same function with the bands leading.

Each wrapper launches its CUDA kernel (``csrc/optics_fused.cu``,
``csrc/planck_band.cu``) for CUDA tensors and raises on anything the kernel
does not take; for CPU tensors it returns its twin. ``<wrapper>.launches``
counts the launches. The kernels are f32.

The TPU kernels' generic table interpolation (``interp_pt_eta``,
``interp_pt_eta_windowed``) and merged minor-gas kernel
(``interp_minor_merged``) are not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import check_optics_inputs, cuda_device, optics_input_ptrs, ptr, require, stream, table_ptrs
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


def tau_gas(inp: MegaInputs, tabs: KernelTables) -> torch.Tensor:
    """Major + minor optical depth (nlay, ncol, ngpt), not yet clamped."""
    lkp = tabs.lkp
    scalings = [
        (side, itv, inp.minor_scaling[i])
        for i, (side, itv) in enumerate(minor_intervals(lkp))
    ]
    tau = compute_tau_major(lkp, inp.col_dry, inp.pt, inp.eta)
    return tau.add_(tau_minor_from_scalings(lkp, scalings, inp.pt, inp.eta))


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
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_optics_fused(
            *optics_input_ptrs(inp), ptr(inp.ray_factor if shortwave else None), *table_ptrs(tabs),
            ptr(tau), ptr(second), nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, int(shortwave),
            stream(dev),
        )
    _build.check(err, "optics_fused")
    optics_fused.launches += 1
    return tau, second


optics_fused.launches = 0


def planck_band_rows_ref(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Plain twin of ``planck_band_rows``: (N, nbnd) band Planck values at
    the temperatures ``t`` (N,)."""
    return planck_bands(totplnk, t, t_min, t_delta)


def planck_band_rows(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Band Planck emission (N, nbnd) f32 at temperatures ``t`` (N,), by
    linear interpolation of ``totplnk`` (n_t, nbnd) on the uniform grid
    (t_min, t_delta); outside the grid the end values."""
    if t.device.type == "cpu":
        return planck_band_rows_ref(t, totplnk, t_min, t_delta)
    dev = cuda_device(t, "planck_band_rows")
    if t.dim() != 1 or totplnk.dim() != 2 or totplnk.shape[0] < 2:
        raise ValueError(f"planck_band_rows: t {tuple(t.shape)}, totplnk {tuple(totplnk.shape)}")
    n = t.shape[0]
    n_t, nbnd = totplnk.shape
    require(t, "t", (n,), torch.float32, dev)
    require(totplnk, "totplnk", (n_t, nbnd), torch.float32, dev)
    out = torch.empty((n, nbnd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_planck_band_rows(
            ptr(t), ptr(totplnk), ptr(out), n, nbnd, n_t, t_min, t_delta, stream(dev))
    _build.check(err, "planck_band_rows")
    planck_band_rows.launches += 1
    return out


planck_band_rows.launches = 0
