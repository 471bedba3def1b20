"""Synthetic gas, cloud and aerosol lookup tables and atmospheres for
data-free runs (counterpart of ``rrtmgp_tpu/data/synthetic.py``).

The tables have the exact structure of the rrtmgp-data files (shapes, index
conventions, metadata invariants, physical magnitudes). The numpy RNG code is
the JAX package's, line for line, so the same seed gives bitwise-equal arrays
in both packages.
"""

from __future__ import annotations

import numpy as np

from ..convert import (
    aerosol_lookup_from_numpy,
    atmosphere_from_numpy,
    cloud_lookup_from_numpy,
    gas_lookup_from_numpy,
    torch_dtype,
)
from ..parameters import RRTMGPParameters
from ..states import AtmosphericState
from .lookups import AerosolLookup, CloudLookup, GasLookup, MinorInterval

# Gas ordering mirrors rrtmgp-data g-files: h2o=1, co2=2, o3=3 (1-based).
GAS_NAMES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2")


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
    return gas_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)


def synthetic_cloud_lookup(
    n_bnd: int = 2, nsize_liq: int = 25, nsize_ice: int = 25, nrghice: int = 3,
    seed: int = 3, dtype=np.float64, device=None,
) -> CloudLookup:
    """Synthetic cloud optics table with the real files' structure."""
    rng = np.random.default_rng(seed)
    ext_l = np.abs(rng.normal(0.1, 0.02, (nsize_liq, n_bnd))) + 0.02   # m^2/g
    ssa_l = np.clip(rng.normal(0.6, 0.1, (nsize_liq, n_bnd)), 0.05, 0.999)
    asy_l = np.clip(rng.normal(0.85, 0.05, (nsize_liq, n_bnd)), 0.0, 0.99)
    ext_i = np.abs(rng.normal(0.05, 0.01, (nsize_ice, n_bnd, nrghice))) + 0.01
    ssa_i = np.clip(rng.normal(0.55, 0.1, (nsize_ice, n_bnd, nrghice)), 0.05, 0.999)
    asy_i = np.clip(rng.normal(0.8, 0.05, (nsize_ice, n_bnd, nrghice)), 0.0, 0.99)
    arrays = dict(
        liq=np.stack([ext_l, ssa_l, asy_l]),
        ice=np.stack([ext_i, ssa_i, asy_i]),
        bnd_lims_wn=np.linspace(10.0, 3000.0, 2 * n_bnd).reshape(2, n_bnd),
        radliq_lwr=np.asarray(2.5), radliq_upr=np.asarray(21.5),
        radice_lwr=np.asarray(10.0), radice_upr=np.asarray(90.0),
    )
    meta = dict(nsize_liq=nsize_liq, nsize_ice=nsize_ice, nrghice=nrghice)
    return cloud_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)


def synthetic_aerosol_lookup(
    n_bnd: int = 2, n_bin: int = 5, n_rh: int = 7, seed: int = 4, dtype=np.float64, device=None,
) -> AerosolLookup:
    """Synthetic MERRA aerosol table with the real files' structure."""
    rng = np.random.default_rng(seed)

    def props(shape):
        ext = np.abs(rng.normal(0.3, 0.05, shape)) + 0.05   # m^2/g-ish
        ssa = np.clip(rng.normal(0.7, 0.1, shape), 0.05, 0.999)
        asy = np.clip(rng.normal(0.6, 0.1, shape), 0.0, 0.95)
        return np.stack([ext, ssa, asy])

    bins = np.array([[0.1, 1.0, 2.0, 3.0, 6.0], [1.0, 2.0, 3.0, 6.0, 10.0]])
    arrays = dict(
        size_bin_limits=bins,
        rh_levels=np.linspace(0.0, 0.99, n_rh),
        dust=props((n_bin, n_bnd)),
        sea_salt=props((n_rh, n_bin, n_bnd)),
        sulfate=props((n_rh, n_bnd)),
        black_carbon_rh=props((n_rh, n_bnd)),
        black_carbon=props((n_bnd,)),
        organic_carbon_rh=props((n_rh, n_bnd)),
        organic_carbon=props((n_bnd,)),
        bnd_lims_wn=np.array([[2600.0, 16000.0], [16000.0, 50000.0]]).T.reshape(2, -1)[:, :n_bnd],
    )
    meta = dict(iband_550nm=min(1, n_bnd - 1), n_bin=n_bin, n_rh=n_rh)
    return aerosol_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)


def synthetic_atmosphere(
    ncol: int = 8,
    nlay: int = 42,
    ngas: int = len(GAS_NAMES),
    p_top: float = 1.2,
    seed: int = 7,
    dtype=np.float64,
    params: RRTMGPParameters = RRTMGPParameters(),
    with_clouds: bool = False,
    with_aerosols: bool = False,
    device=None,
) -> AtmosphericState:
    """RFMIP-like synthetic atmospheric state (level 0 = surface), with
    optional clouds (cloud fraction 0 or 1, every third column clear) and
    MERRA aerosols in the layers below 800 hPa."""
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

    cloud_state = None
    if with_clouds:
        cld_frac = np.zeros((nlay, ncol))
        in_cloud = (p_lay > 10000.0) & (p_lay < 90000.0) & (np.arange(ncol)[None, :] % 3 != 2)
        cld_frac[in_cloud] = 1.0
        t_mask = t_lay > 263.0
        cloud_state = dict(
            cld_r_eff_liq=np.where(in_cloud & t_mask, 12.0, 0.0),
            cld_r_eff_ice=np.where(in_cloud & ~t_mask, 35.0, 0.0),
            cld_path_liq=np.where(in_cloud & t_mask, 60.0, 0.0),
            cld_path_ice=np.where(in_cloud & ~t_mask, 80.0, 0.0),
            cld_frac=cld_frac,
            ice_rgh=2,
        )

    aerosol_state = None
    rel_hum = None
    if with_aerosols:
        n_aero = 15
        mass = np.zeros((n_aero, nlay, ncol))
        size = np.zeros((n_aero, nlay, ncol))
        low = p_lay > 80000.0
        mass[0, :, :] = np.where(low, 1e-5, 0.0)   # dust1
        size[0, :, :] = np.where(low, 0.5, 0.0)
        mass[1, :, :] = np.where(low, 2e-5, 0.0)   # sea_salt1
        size[1, :, :] = np.where(low, 0.8, 0.0)
        mass[2, :, :] = np.where(low, 5e-6, 0.0)   # sulfate
        mass[4, :, :] = np.where(low, 1e-6, 0.0)   # black carbon (phobic)
        aerosol_state = dict(aero_size=size, aero_mass=mass)
        # numpy mirror of states.compute_relative_humidity
        mwd = params.molmass_water / params.molmass_dryair
        mmr_h2o = vmr_h2o * mwd
        q_tmp = np.maximum(1e-7, mmr_h2o / (1.0 + mmr_h2o))
        es_tmp = np.exp((17.67 * (t_lay - 273.16)) / (t_lay - 29.65))
        rel_hum = np.maximum(0.01 * (0.263 * p_lay * q_tmp) / es_tmp, 0.0)

    return atmosphere_from_numpy(
        p_lay=p_lay, t_lay=t_lay, p_lev=p_lev, t_lev=t_lev, t_sfc=t_sfc,
        col_dry=col_dry, vmr_h2o=vmr_h2o, vmr_o3=vmr_o3, vmr_gm=vmr_gm,
        rel_hum=rel_hum, cloud_state=cloud_state, aerosol_state=aerosol_state,
        dtype=torch_dtype(dtype), device=device,
    )
