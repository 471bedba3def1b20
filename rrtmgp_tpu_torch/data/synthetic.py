"""Synthetic lookup tables and clear-sky atmospheres for data-free runs
(counterpart of ``rrtmgp_tpu/data/synthetic.py``).

The tables have the exact structure of the rrtmgp-data files (shapes, index
conventions, metadata invariants, physical magnitudes). The numpy RNG code is
the JAX package's, line for line, so the same seed gives bitwise-equal arrays
in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import atmosphere_from_numpy, gas_lookup_from_numpy
from ..parameters import RRTMGPParameters
from ..states import AtmosphericState
from .lookups import GasLookup, MinorInterval

# Gas ordering mirrors rrtmgp-data g-files: h2o=1, co2=2, o3=3 (1-based).
GAS_NAMES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2")

_TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPE[np.dtype(dtype).type]


def synthetic_gas_lookup(
    longwave: bool = True,
    n_gpt: int = 16,
    n_bnd: int = 2,
    n_eta: int = 9,
    n_press: int = 59,
    n_temp: int = 14,
    n_t_plnk: int = 196,
    seed: int = 0,
    dtype=np.float64,
    device=None,
) -> GasLookup:
    """Structurally-faithful synthetic gas-optics lookup."""
    rng = np.random.default_rng(seed)
    if n_gpt % n_bnd != 0:
        raise ValueError(f"n_gpt={n_gpt} must be a multiple of n_bnd={n_bnd}")
    per_bnd = n_gpt // n_bnd
    bnd_lims_gpt = tuple((b * per_bnd, (b + 1) * per_bnd) for b in range(n_bnd))

    # reference grids (like the real files: 1 Pa .. 1.09 hPa, 160..355 K)
    p_ref = np.logspace(np.log10(109663.0), np.log10(1.005), n_press)
    t_ref = np.linspace(160.0, 355.0, n_temp)
    p_ref_tropo = 9948.4  # Pa, real file value

    # smooth positive absorption coefficients; magnitude such that
    # tau = k * col_dry ~ O(1) for col_dry ~ 5e21 molecules/cm^2
    def smooth4(shape, scale):
        base = rng.normal(size=shape)
        for axis in range(1, len(shape)):
            k = np.ones(3) / 3.0
            base = np.apply_along_axis(lambda m: np.convolve(m, k, mode="same"), axis, base)
        return scale * np.exp(0.5 * base)

    kmajor = smooth4((n_gpt, n_press + 1, n_temp, n_eta), 2e-22)
    # make optical depth increase with pressure slab (denser atmosphere)
    kmajor *= np.linspace(0.3, 1.5, n_press + 1)[None, :, None, None]

    # key species: even bands keyed by (h2o, co2), odd bands by (o3, co2)
    # lower / (o3, o3) upper — exercises the VmrGM paths
    key_species = []
    for b in range(n_bnd):
        if b % 2 == 0:
            key_species.append(((1, 2), (1, 2)))
        else:
            key_species.append(((3, 2), (3, 3)))
    key_species = tuple(key_species)

    vmr_ref = np.abs(rng.normal(1.0, 0.2, size=(2, len(GAS_NAMES) + 1, n_temp))) + 0.1
    eta_half = np.empty((n_bnd, 2, n_temp))
    for b in range(n_bnd):
        for t in range(2):
            g1, g2 = key_species[b][t]
            eta_half[b, t] = vmr_ref[t, g1] / vmr_ref[t, g2]

    # minor intervals: a few per side, covering whole bands
    def mk_minor():
        intervals = []
        k0 = 0
        specs = [
            # (gas, scaling_gas, dens, compl, band)
            (4, 0, True, False, 0),    # n2o scales with density
            (5, 1, True, True, 0),     # co scaled by complement of h2o
            (6, 0, False, False, min(1, n_bnd - 1)),  # ch4 plain
        ]
        rows = []
        for gas, sgas, dens, compl, band in specs:
            g0, g1 = bnd_lims_gpt[band]
            intervals.append(MinorInterval(gas, sgas, dens, compl, g0, g1, k0))
            ng = g1 - g0
            rows.append(smooth4((ng, n_temp, n_eta), 3e-24))
            k0 += ng
        return tuple(intervals), np.concatenate(rows, axis=0)

    minor_lower, kminor_lower = mk_minor()
    minor_upper, kminor_upper = mk_minor()

    planck_fraction = totplnk = rayl = solar_src_scaled = None
    t_planck_min = t_planck_delta = 0.0
    solar_src_tot = 0.0
    if longwave:
        pf = np.abs(smooth4((n_gpt, n_press + 1, n_temp, n_eta), 1.0))
        # fractions within each band sum to ~1 over g-points
        for g0, g1 in bnd_lims_gpt:
            pf[g0:g1] /= pf[g0:g1].sum(axis=0, keepdims=True)
        planck_fraction = pf
        t_planck = np.linspace(160.0, 355.0, n_t_plnk)
        t_planck_min, t_planck_delta = float(t_planck[0]), float(t_planck[1] - t_planck[0])
        # per-band fraction of sigma*T^4/pi (bands roughly equal share)
        sigma = 5.67e-8
        totplnk = np.stack(
            [(sigma * t_planck**4 / np.pi) / n_bnd * (0.8 + 0.4 * b / max(n_bnd - 1, 1)) for b in range(n_bnd)],
            axis=1,
        )
    else:
        rayl = smooth4((2, n_gpt, n_temp, n_eta), 1e-26)
        src = np.abs(rng.normal(1.0, 0.3, size=(n_gpt,))) + 0.2
        solar_src_tot = 1361.0
        solar_src_scaled = src / src.sum()

    arrays = dict(
        kmajor=kmajor, kminor_lower=kminor_lower, kminor_upper=kminor_upper,
        eta_half=eta_half, planck_fraction=planck_fraction, totplnk=totplnk,
        rayl=rayl, solar_src_scaled=solar_src_scaled,
    )
    meta = dict(
        idx_h2o=1,
        p_ref_tropo=p_ref_tropo,
        p_ref_min=float(p_ref.min()),
        key_species=key_species,
        bnd_lims_gpt=bnd_lims_gpt,
        minor_lower=minor_lower,
        minor_upper=minor_upper,
        gas_names=GAS_NAMES,
        n_eta=n_eta,
        n_press=n_press,
        n_temp=n_temp,
        t_ref_min=float(t_ref[0]),
        t_ref_delta=float(t_ref[1] - t_ref[0]),
        ln_p_ref_max=float(np.log(p_ref[0])),
        ln_p_ref_delta=float(np.log(p_ref[0]) - np.log(p_ref[1])),
        t_planck_min=t_planck_min,
        t_planck_delta=t_planck_delta,
        solar_src_tot=solar_src_tot,
    )
    return gas_lookup_from_numpy(arrays, meta, dtype=_torch_dtype(dtype), device=device)


def synthetic_atmosphere(
    ncol: int = 8,
    nlay: int = 42,
    ngas: int = len(GAS_NAMES),
    p_top: float = 1.2,
    seed: int = 7,
    dtype=np.float64,
    params: RRTMGPParameters = RRTMGPParameters(),
    device=None,
) -> AtmosphericState:
    """RFMIP-like synthetic clear-sky atmospheric state (level 0 = surface)."""
    rng = np.random.default_rng(seed)
    p0 = 101000.0 + rng.normal(0, 500, ncol)
    # log-spaced levels, surface -> TOA
    p_lev = np.exp(
        np.linspace(np.log(p0), np.full(ncol, np.log(p_top)), nlay + 1)
    )  # (nlay+1, ncol)
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])

    t_sfc = 288.0 + rng.normal(0, 5, ncol)
    # piecewise temperature: lapse to 210 K at tropopause (~100 hPa), then mild inversion
    frac = np.log(p_lay / p_lay[0:1])
    t_lay = np.clip(t_sfc[None, :] + 45.0 * frac / np.log(1e4 / 1e5), 205.0, 320.0)
    t_lev = np.clip(t_sfc[None, :] + 45.0 * np.log(p_lev / p_lev[0:1]) / np.log(1e4 / 1e5), 205.0, 320.0)

    vmr_h2o = 8e-3 * (p_lay / p_lay[0:1]) ** 2 + 3e-6
    vmr_o3 = 5e-8 + 8e-6 * np.exp(-((np.log(p_lay / 2500.0)) ** 2))
    vmr_gm = np.zeros(ngas + 1)
    for idx, val in ((2, 397e-6), (4, 3.2e-7), (5, 1.5e-7), (6, 1.8e-6), (7, 0.209), (8, 0.781)):
        if idx <= ngas:  # co2, n2o, co, ch4, o2, n2 (skip gases beyond this lookup)
            vmr_gm[idx] = val

    # col_dry in numpy, same formula as states.compute_col_gas
    dp = p_lev[:-1] - p_lev[1:]
    m_air = params.molmass_dryair + params.molmass_water * vmr_h2o
    col_dry = dp * params.avogad / (1.0e4 * m_air * params.grav)

    return atmosphere_from_numpy(
        p_lay=p_lay, t_lay=t_lay, p_lev=p_lev, t_lev=t_lev, t_sfc=t_sfc,
        col_dry=col_dry, vmr_h2o=vmr_h2o, vmr_o3=vmr_o3, vmr_gm=vmr_gm,
        dtype=_torch_dtype(dtype), device=device,
    )
