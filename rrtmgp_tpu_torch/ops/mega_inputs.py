"""Inputs of the megakernels and of the materialized-optics kernel
(``ops.interp.optics_fused``), in plain torch (counterpart of the XLA
prologue ``mega_lw_inputs`` / ``mega_sw_inputs`` in
``rrtmgp_tpu/ops/gas_optics_pallas.py``).

Two containers:

- ``MegaInputs``: per-solve data the kernels read — per (layer, column) the
  pressure/temperature interpolation and ``col_dry``, per (layer, column,
  band) the eta interpolation, per minor interval its scaling (zeroed outside
  its troposphere side), and for SW the Rayleigh column amount;
- ``KernelTables``: one lookup's tables, in the lookup's dtype (f32, or f64
  for the f64 kernels), in g-point-fastest layouts, so that the threads of
  one column, one per g-point, read neighbouring addresses, plus the
  minor-interval index.

The TPU-only structure of the JAX prologue (bf16 hi/lo table splits,
per-layer table windows and their guards, 128-column padding) has no
counterpart here. Band Planck values are not part of the inputs: the solves
launch ``ops.mega.planck_band_sets`` once, at t_lay, t_lev and t_sfc for LW
no-scattering, and at t_lev and t_sfc only for LW two-stream (the JAX
prologue's ``need_lay=False``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.lookups import GasLookup, band_limits_to_gpt2band
from ..states import AtmosphericState, TensorContainer
from ..utils.debug import note_compile
from .gas_optics import (
    EtaInterp,
    PTInterp,
    compute_eta_interp,
    compute_pt_interp,
    minor_intervals,
    minor_scalings,
    rayleigh_factor,
)


@dataclasses.dataclass(frozen=True)
class MegaInputs(TensorContainer):
    """Per-solve kernel inputs. (nlay, ncol) and (nlay, ncol, nbnd) fields are
    the PTInterp / EtaInterp of ``ops.gas_optics``."""

    jtemp: torch.Tensor          # (nlay, ncol) int32
    ftemp: torch.Tensor          # (nlay, ncol)
    jpress_base: torch.Tensor    # (nlay, ncol) int32
    fpress: torch.Tensor         # (nlay, ncol)
    tropo_lower: torch.Tensor    # (nlay, ncol) bool
    col_dry: torch.Tensor        # (nlay, ncol)
    jeta1: torch.Tensor          # (nlay, ncol, nbnd) int32
    feta1: torch.Tensor
    col_mix1: torch.Tensor
    jeta2: torch.Tensor
    feta2: torch.Tensor
    col_mix2: torch.Tensor
    minor_scaling: torch.Tensor  # (n_minor, nlay, ncol), KernelTables' interval order
    ray_factor: torch.Tensor | None = None  # (nlay, ncol), SW only

    @property
    def pt(self) -> PTInterp:
        return PTInterp(self.jtemp, self.ftemp, self.jpress_base, self.fpress, self.tropo_lower)

    @property
    def eta(self) -> EtaInterp:
        return EtaInterp(
            self.jeta1, self.feta1, self.jeta2, self.feta2, self.col_mix1, self.col_mix2
        )

    @property
    def nlay(self) -> int:
        return self.jtemp.shape[0]

    @property
    def ncol(self) -> int:
        return self.jtemp.shape[1]


@dataclasses.dataclass(frozen=True)
class KernelTables(TensorContainer):
    """One lookup's tables as the kernels read them.

    kmajor (npress+1, ntemp, neta, ngpt); second = planck_fraction in the
    same layout (LW) or rayl as (2, ntemp, neta, ngpt) (SW); kminor
    (ntemp, neta, ncontrib) with the lower side's rows first.

    Minor intervals with a gas are numbered lower side first, in file order
    (the order of ``gas_optics.minor_scalings``). For interval i,
    ``minor_kbase[i] + g`` is g-point g's row of kminor and ``minor_band[i]``
    the band whose eta data it reads. The intervals of side s covering
    g-point g are ``minor_list[minor_start[s, g]:minor_start[s, g+1]]``.
    """

    lkp: GasLookup
    kmajor: torch.Tensor
    second: torch.Tensor
    kminor: torch.Tensor
    gpt2band: torch.Tensor     # (ngpt,) int32
    minor_start: torch.Tensor  # (2, ngpt+1) int32
    minor_list: torch.Tensor   # (n_entries,) int32
    minor_kbase: torch.Tensor  # (n_minor,) int32
    minor_band: torch.Tensor   # (n_minor,) int32

    @property
    def n_minor(self) -> int:
        return self.minor_kbase.shape[0]


def _minor_index(lkp: GasLookup):
    g2b = band_limits_to_gpt2band(lkp.bnd_lims_gpt, lkp.n_gpt)
    n_lower = lkp.kminor_lower.shape[0]
    intervals = minor_intervals(lkp)
    kbase = [itv.k0 - itv.gpt0 + (n_lower if side else 0) for side, itv in intervals]
    band = [int(g2b[itv.gpt0]) for _, itv in intervals]
    start = np.zeros((2, lkp.n_gpt + 1), np.int32)
    entries = []
    for side in (0, 1):
        for g in range(lkp.n_gpt):
            start[side, g] = len(entries)
            entries += [
                i for i, (s, itv) in enumerate(intervals)
                if s == side and itv.gpt0 <= g < itv.gpt1
            ]
        start[side, lkp.n_gpt] = len(entries)
    as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=lkp.device)
    return as_i32(start), as_i32(entries), as_i32(kbase), as_i32(band)


def build_kernel_tables(lkp: GasLookup) -> KernelTables:
    """Build the kernels' table layouts for one lookup, in the lookup's
    dtype (a few MB of permuted copies). Use ``lkp.kernel_tables``, which
    builds them once."""
    note_compile("kernel_tables", f"{'LW' if lkp.is_longwave else 'SW'} {lkp.n_gpt} g-points "
                                  f"{str(lkp.kmajor.dtype)[6:]} {lkp.device}")
    g_last = lambda t: t.permute(*range(1, t.ndim), 0).contiguous()  # g-point axis to the end
    if lkp.is_longwave:
        second = g_last(lkp.planck_fraction)
    else:
        second = lkp.rayl.permute(0, 2, 3, 1).contiguous()
    kminor = torch.cat([lkp.kminor_lower, lkp.kminor_upper], dim=0)
    start, entries, kbase, band = _minor_index(lkp)
    return KernelTables(
        lkp=lkp,
        kmajor=g_last(lkp.kmajor),
        second=second,
        kminor=g_last(kminor),
        gpt2band=torch.as_tensor(
            band_limits_to_gpt2band(lkp.bnd_lims_gpt, lkp.n_gpt), device=lkp.device
        ),
        minor_start=start,
        minor_list=entries,
        minor_kbase=kbase,
        minor_band=band,
    )


def _mega_inputs(lkp, as_, eta_node_mode, shortwave) -> MegaInputs:
    pt = compute_pt_interp(lkp, as_.p_lay, as_.t_lay)
    eta = compute_eta_interp(lkp, as_.vmr, pt, node_mode=eta_node_mode)
    scal = minor_scalings(lkp, as_.vmr, as_.col_dry, as_.p_lay, as_.t_lay, pt)
    nlay, ncol = pt.jtemp.shape
    if scal:
        minor = torch.stack([s for _, _, s in scal], dim=0)
    else:
        minor = as_.col_dry.new_zeros((0, nlay, ncol))
    ray = rayleigh_factor(lkp, as_.vmr, as_.col_dry) if shortwave else None
    c = lambda x: None if x is None else x.contiguous()
    return MegaInputs(
        **{k: c(v) for k, v in pt._asdict().items()},
        **{k: c(v) for k, v in eta._asdict().items()},
        col_dry=c(as_.col_dry), minor_scaling=c(minor), ray_factor=c(ray),
    )


def mega_lw_inputs(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> MegaInputs:
    """Inputs of ``ops.mega.lw_clear_mega`` and ``ops.mega.lw2_mega``."""
    return _mega_inputs(lkp, as_, eta_node_mode, shortwave=False)


def mega_sw_inputs(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> MegaInputs:
    """Inputs of ``ops.mega.sw_clear_mega`` (adds the Rayleigh column amount)."""
    return _mega_inputs(lkp, as_, eta_node_mode, shortwave=True)
