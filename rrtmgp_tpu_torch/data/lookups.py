"""Lookup-table containers for RRTMGP gas, cloud and aerosol optics
(counterpart of ``rrtmgp_tpu/data/lookups.py``).

Dense coefficient tensors keep the JAX package's layout, g-point leading
(``kmajor (ngpt, npress+1, ntemp, neta)``). Index data (key species per band,
band g-point limits, minor-gas interval metadata) is static Python metadata.
The CUDA kernels read g-point-fastest copies of the tables
(``GasLookup.kernel_tables``), built once per lookup on first use.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..states import TensorContainer


class MinorInterval(NamedTuple):
    """Static metadata for one minor-gas absorption interval.

    ``gas``/``scaling_gas`` index the vmr table (0 = none); the g-point range
    is [gpt0, gpt1); ``k0`` is the row of this interval's first contributor
    in the kminor array.
    """

    gas: int
    scaling_gas: int
    scales_with_density: bool
    scale_by_complement: bool
    gpt0: int
    gpt1: int
    k0: int


@dataclasses.dataclass(frozen=True)
class GasLookup(TensorContainer):
    """Gas-optics lookup tables for one band set (LW or SW).

    Tensor fields:
      kmajor          (ngpt, npress+1, ntemp, neta)
      kminor_lower    (ncontrib_lower, ntemp, neta)
      kminor_upper    (ncontrib_upper, ntemp, neta)
      eta_half        (nbnd, 2, ntemp)   tropo axis: 0 = lower, 1 = upper
      planck_fraction (ngpt, npress+1, ntemp, neta)   LW only, else None
      totplnk         (n_t_plnk, nbnd)                LW only
      rayl            (2, ngpt, ntemp, neta)          SW only
      solar_src_scaled(ngpt,)                         SW only
    """

    kmajor: torch.Tensor
    kminor_lower: torch.Tensor
    kminor_upper: torch.Tensor
    eta_half: torch.Tensor
    planck_fraction: torch.Tensor | None
    totplnk: torch.Tensor | None
    rayl: torch.Tensor | None
    solar_src_scaled: torch.Tensor | None

    idx_h2o: int
    p_ref_tropo: float
    p_ref_min: float
    key_species: tuple
    bnd_lims_gpt: tuple
    minor_lower: tuple
    minor_upper: tuple
    gas_names: tuple
    n_eta: int
    n_press: int
    n_temp: int
    t_ref_min: float
    t_ref_delta: float
    ln_p_ref_max: float
    ln_p_ref_delta: float
    t_planck_min: float
    t_planck_delta: float
    solar_src_tot: float

    @property
    def n_gpt(self) -> int:
        return self.kmajor.shape[0]

    @property
    def n_bnd(self) -> int:
        return len(self.bnd_lims_gpt)

    @property
    def is_longwave(self) -> bool:
        return self.planck_fraction is not None

    @property
    def device(self) -> torch.device:
        return self.kmajor.device

    @functools.cached_property
    def key_species_index(self) -> tuple:
        """The bands' distinct key-species gas indices, sorted, and for each
        (slot, troposphere side) the position of each band's key species in
        that list, a tensor on the lookup's device. Built on first use and
        kept, so that a solve gathers the bands' VMRs without copying an
        index from the host, a copy that synchronises the host with the card
        (entries of a column split on separate cards would then run one
        after another)."""
        species = sorted({s for bnd in self.key_species for pair in bnd for s in pair})
        index = {
            (slot, tropo): torch.tensor([species.index(self.key_species[b][tropo][slot]) for b in range(self.n_bnd)],
                                        device=self.device)
            for slot in (0, 1) for tropo in (0, 1)
        }
        return tuple(species), index

    @functools.cached_property
    def kernel_tables(self):
        """The CUDA kernels' layouts of these tables, in their dtype
        (``ops.mega_inputs.KernelTables``), built on first use and owned by
        this lookup, so they live exactly as long as it does."""
        from ..ops.mega_inputs import build_kernel_tables

        return build_kernel_tables(self)


@dataclasses.dataclass(frozen=True)
class CloudLookup(TensorContainer):
    """Cloud optics table.

    liq (3, nsize_liq, nbnd): ext/ssa/asy vs liquid effective radius;
    ice (3, nsize_ice, nbnd, nrghice): the same for ice x roughness. The
    radius bounds are 0-dim tensors of the table's dtype, so the radius grid
    step is computed at the working precision, as in the JAX package.
    """

    liq: torch.Tensor
    ice: torch.Tensor
    bnd_lims_wn: torch.Tensor
    radliq_lwr: torch.Tensor
    radliq_upr: torch.Tensor
    radice_lwr: torch.Tensor
    radice_upr: torch.Tensor
    nsize_liq: int
    nsize_ice: int
    nrghice: int


@dataclasses.dataclass(frozen=True)
class AerosolLookup(TensorContainer):
    """MERRA aerosol table; (ext, ssa, asy) on the leading axis of each:

      dust              (3, nbin, nbnd)
      sea_salt          (3, nrh, nbin, nbnd)
      sulfate           (3, nrh, nbnd)
      black_carbon_rh   (3, nrh, nbnd)
      black_carbon      (3, nbnd)
      organic_carbon_rh (3, nrh, nbnd)
      organic_carbon    (3, nbnd)
    """

    size_bin_limits: torch.Tensor  # (2, nbin)
    rh_levels: torch.Tensor        # (nrh,)
    dust: torch.Tensor
    sea_salt: torch.Tensor
    sulfate: torch.Tensor
    black_carbon_rh: torch.Tensor
    black_carbon: torch.Tensor
    organic_carbon_rh: torch.Tensor
    organic_carbon: torch.Tensor
    bnd_lims_wn: torch.Tensor
    iband_550nm: int  # 0-based; -1 if absent
    n_bin: int
    n_rh: int


def band_limits_to_gpt2band(bnd_lims_gpt: tuple, n_gpt: int) -> np.ndarray:
    """Dense 0-based g-point -> band map from static band limits."""
    g2b = np.zeros((n_gpt,), dtype=np.int32)
    for ibnd, (g0, g1) in enumerate(bnd_lims_gpt):
        g2b[g0:g1] = ibnd
    return g2b
