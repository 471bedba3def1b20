"""MERRA aerosol optics in plain torch (counterpart of
``rrtmgp_tpu/ops/aerosol_optics.py``).

Per (layer, column) and band, the 7 species families accumulate (tau,
tau*ssa, tau*ssa*g) where the species' mass is positive: dust (5 size bins),
sea salt (5 size bins x relative-humidity interpolation), sulfate,
hydrophilic black/organic carbon (RH interpolation) and hydrophobic black/
organic carbon (constant). Table lookups are gathers (the JAX package's
one-hot matrix products are TPU-only structure).

MERRA type indexing (0-based):
  0: dust1, 1: sea_salt1, 2: sulfate, 3: black_carbon_rh, 4: black_carbon,
  5: organic_carbon_rh, 6: organic_carbon, 7-10: dust2-5, 11-14: sea_salt2-5
"""

from __future__ import annotations

import torch

from ..data.lookups import AerosolLookup
from ..states import AerosolState

DUST_IDXS = (0, 7, 8, 9, 10)
SALT_IDXS = (1, 11, 12, 13, 14)
SULFATE_IDX = 2
BC_RH_IDX = 3
BC_IDX = 4
OC_RH_IDX = 5
OC_IDX = 6
N_SPECIES = 15


def locate_size_bin(size_bin_limits: torch.Tensor, aerosize: torch.Tensor) -> torch.Tensor:
    """First size bin whose [lo, hi] holds the size, else the last bin."""
    lo, hi = size_bin_limits[0], size_bin_limits[1]
    nbin = lo.shape[0]
    inside = (aerosize[..., None] >= lo) & (aerosize[..., None] <= hi)
    first = torch.argmax(inside.to(torch.uint8), dim=-1)
    return torch.where(inside.any(dim=-1), first, nbin - 1)


def rh_loc_factor(rh_levels: torch.Tensor, rh: torch.Tensor):
    """Location and factor of a non-uniform 1-D interpolation in relative
    humidity, clamped at the ends."""
    n = rh_levels.shape[0]
    idx = torch.searchsorted(rh_levels, rh.contiguous(), right=True)
    loc = torch.clamp(idx - 1, 0, n - 2)
    factor = (rh - rh_levels[loc]) / (rh_levels[loc + 1] - rh_levels[loc])
    return loc, torch.clamp(factor, 0.0, 1.0)


def aerosol_optics_bands(
    lkp: AerosolLookup, aero: AerosolState, rel_hum: torch.Tensor,
    active_species: tuple | None = None,
):
    """Cumulative aerosol (tau, tau*ssa, tau*ssa*g), each (nlay, ncol, nbnd).
    ``active_species`` (MERRA indices) skips the others, whose contribution
    is zero anyway where their mass is zero."""
    dtype = rel_hum.dtype
    mass, size = aero.aero_mass, aero.aero_size
    loc, factor = rh_loc_factor(lkp.rh_levels, rel_hum)
    fac = factor[..., None]
    omf = 1.0 - fac
    nbnd = lkp.dust.shape[-1]
    tau = rel_hum.new_zeros((*rel_hum.shape, nbnd))
    tau_ssa = torch.zeros_like(tau)
    tau_ssag = torch.zeros_like(tau)
    on = lambda i: active_species is None or i in active_species

    def add(vals, m):
        # vals: (3, nlay, ncol, nbnd) ext/ssa/asy
        nonlocal tau, tau_ssa, tau_ssag
        mm = m[..., None]
        t = torch.where(mm > 0.0, mm * vals[0], 0.0)
        ts = t * vals[1]
        tau = tau + t
        tau_ssa = tau_ssa + ts
        tau_ssag = tau_ssag + ts * vals[2]

    rh_interp = lambda tbl: tbl[:, loc].to(dtype) * omf + tbl[:, loc + 1].to(dtype) * fac
    for i in DUST_IDXS:
        if on(i):
            add(lkp.dust[:, locate_size_bin(lkp.size_bin_limits, size[i])].to(dtype), mass[i])
    for i in SALT_IDXS:
        if on(i):
            b = locate_size_bin(lkp.size_bin_limits, size[i])
            add(lkp.sea_salt[:, loc, b].to(dtype) * omf + lkp.sea_salt[:, loc + 1, b].to(dtype) * fac,
                mass[i])
    for tbl, i in ((lkp.sulfate, SULFATE_IDX), (lkp.black_carbon_rh, BC_RH_IDX),
                   (lkp.organic_carbon_rh, OC_RH_IDX)):
        if on(i):
            add(rh_interp(tbl), mass[i])
    for tbl, i in ((lkp.black_carbon, BC_IDX), (lkp.organic_carbon, OC_IDX)):
        if on(i):
            add(tbl.to(dtype)[:, None, None, :], mass[i])
    return tau, tau_ssa, tau_ssag
