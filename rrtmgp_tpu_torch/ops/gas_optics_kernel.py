"""Gas optics through the materialized-optics kernels (counterpart of
``gas_optics_lw_raw`` / ``gas_optics_lw`` / ``gas_optics_sw`` in
``rrtmgp_tpu/ops/gas_optics_pallas.py``): the first half of the two-kernel
path. The plain-torch prologue (``ops.mega_inputs``, the inputs the
megakernels read) feeds ``ops.interp.optics_fused``, or with ``fused=False``
``ops.interp.optics_unfused`` (the table interpolation and minor-gas
kernels, the JAX package's ``pallas_windowed="off"`` optics; the same values
bit for bit); LW adds the band Planck values in row layout, every
temperature set in one launch (``ops.interp.planck_band_rows_sets``).
``gas_optics_lw_raw``
leaves the sources in banded form for
``ops.rte_kernels.lw_noscat_banded_reduced``, so no (nlay, ncol, ngpt) source
tensor exists; ``gas_optics_lw`` materializes them per g-point for the sweeps
that read sources (``lw_2stream_reduced``, ``lw_noscat_reduced``). On CPU
tensors the wrappers run their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..data.lookups import GasLookup
from ..states import AtmosphericState
from .gas_optics import LWOptics, SWOptics, planck_sources_from_bands
from .interp import optics_fused, optics_unfused, planck_band_rows_sets
from .mega_inputs import mega_lw_inputs, mega_sw_inputs


class RawLWOptics(NamedTuple):
    """LW optics with the Planck sources left in banded form: the Planck
    fraction per g-point and the band Planck values."""

    tau: torch.Tensor      # (nlay, ncol, ngpt)
    pfrac: torch.Tensor    # (nlay, ncol, ngpt)
    plk_lay: torch.Tensor | None  # (nlay, ncol, nbnd) band Planck at t_lay
    plk_lev: torch.Tensor  # (nlay+1, ncol, nbnd) band Planck at t_lev
    plk_sfc: torch.Tensor  # (ncol, nbnd) band Planck at t_sfc


def gas_optics_lw_raw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous", need_lay: bool = True,
    fused: bool = True,
) -> RawLWOptics:
    """LW gas optics for the source-fused sweep: tau, Planck fraction and
    band Planck values at layers (None without ``need_lay``), levels and the
    surface; tau and the Planck fraction from ``optics_fused``, or
    ``optics_unfused`` without ``fused``."""
    optics = optics_fused if fused else optics_unfused
    tau, pfrac = optics(mega_lw_inputs(lkp, as_, eta_node_mode), lkp.kernel_tables)
    nlay, ncol = as_.nlay, as_.ncol
    # every temperature set in one launch
    ts = (as_.t_lay, as_.t_lev, as_.t_sfc) if need_lay else (as_.t_lev, as_.t_sfc)
    *plk_lay, plk_lev, plk_sfc = planck_band_rows_sets(
        tuple(t.reshape(-1).contiguous() for t in ts), lkp.totplnk, lkp.t_planck_min, lkp.t_planck_delta
    )
    return RawLWOptics(
        tau=tau, pfrac=pfrac,
        plk_lay=plk_lay[0].reshape(nlay, ncol, -1) if need_lay else None,
        plk_lev=plk_lev.reshape(nlay + 1, ncol, -1),
        plk_sfc=plk_sfc,
    )


def gas_optics_lw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous",
    need_lay_source: bool = True, fused: bool = True,
) -> LWOptics:
    """LW gas optics with the Planck sources materialized per g-point: tau
    (nlay, ncol, ngpt) and layer, level and surface sources; same contract as
    ``ops.gas_optics.gas_optics_lw``. The optics kernel writes tau and the
    Planck fraction and the band Planck kernel the band values; the sources
    are formed from them in plain torch, as the JAX package forms them
    outside any kernel. Without ``need_lay_source`` the layer source is None
    and its Planck call is skipped (the two-stream sweep reads level sources
    only). ``fused``: as in ``gas_optics_lw_raw``."""
    raw = gas_optics_lw_raw(lkp, as_, eta_node_mode, need_lay=need_lay_source, fused=fused)
    sources = planck_sources_from_bands(
        lkp.kernel_tables.gpt2band.long(), raw.plk_lay, raw.plk_lev, raw.plk_sfc, raw.pfrac
    )
    return LWOptics(tau=raw.tau, sources=sources)


def gas_optics_sw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous", fused: bool = True
) -> SWOptics:
    """SW gas optics: tau with Rayleigh and the Rayleigh single-scattering
    albedo, each (nlay, ncol, ngpt); same contract as
    ``ops.gas_optics.gas_optics_sw``. ``fused``: as in
    ``gas_optics_lw_raw``."""
    optics = optics_fused if fused else optics_unfused
    tau, ssa = optics(mega_sw_inputs(lkp, as_, eta_node_mode), lkp.kernel_tables)
    return SWOptics(tau=tau, ssa=ssa)
