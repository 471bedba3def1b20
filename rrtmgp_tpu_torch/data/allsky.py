"""All-sky (cloudy / cloudy-with-aerosols) example input reader (counterpart
of ``rrtmgp_tpu/data/allsky.py``).

Builds an AtmosphericState with cloud and aerosol states from the
``rrtmgp-allsky-{lw,sw}[-no-aerosols].nc`` example files, as RRTMGP.jl's
``test/read_all_sky_with_aerosols.jl`` does: the example's column 1 is tiled
to ``ncol`` columns; idealized clouds (path 10 g/m^2, mid-range effective
radii) fill layers between 100 and 900 hPa in 2 of every 3 dataset columns;
gases beyond h2o/o3 are global-mean constants from the RRTMGP Fortran
example; aerosol type/size/mass columns are scattered into the 15-species
MERRA axis.

The same file carries the Fortran reference fluxes (lw_flux_up, ...);
``load_reference_fluxes`` returns them surface-first for golden tests.
"""

from __future__ import annotations

import numpy as np

from ..convert import atmosphere_from_numpy, default_device, torch_dtype
from ..parameters import RRTMGPParameters
from ..states import AtmosphericState
from .lookups import CloudLookup, GasLookup
from .netcdf import Dataset
from .rfmip import state_tensors

# global-mean VMRs hard-coded in the RRTMGP Fortran all-sky example
# (RRTMGP.jl test/read_all_sky_with_aerosols.jl:77-82)
_GM_VMR = {
    "co2": 348e-6,
    "ch4": 1650e-9,
    "n2o": 306e-9,
    "n2": 0.7808,
    "o2": 0.2095,
    "co": 0.0,
}

# file aero_type values are the reference's 1-based MERRA indices; ours are
# 0-based: idx = v - 1.
_N_AERO = 15


def _lev_leading(a: np.ndarray, n: int) -> np.ndarray:
    """Normalize a 2D (lev|lay, col)-or-transposed array to n-leading."""
    if a.shape[0] != n:
        a = a.T
    if a.shape[0] != n:
        raise ValueError(f"shape {a.shape}: no axis of {n} levels or layers leads")
    return a


def load_allsky_atmosphere(
    path: str,
    lkp: GasLookup,
    lkp_cld: CloudLookup,
    ncol: int = 128,
    cldfrac: float = 1.0,
    with_aerosols: bool = True,
    dtype=np.float64,
    params: RRTMGPParameters = RRTMGPParameters(),
    device=None,
) -> tuple[AtmosphericState, int]:
    """Returns (AtmosphericState, ncol_ds), the state's tensors of ``dtype``
    on ``device`` (None: the card when there is one). The state carries
    cloud (and, when requested, aerosol) sub-states; BCs are the example's
    constants (sfc_emis 0.98, sfc_alb 0.06, cos_zenith 0.86, toa_flux =
    solar total).
    """
    dtype = torch_dtype(dtype)
    device = default_device() if device is None else device
    ds = Dataset(path)
    nlay = int(ds.dims["lay"])
    nlev = nlay + 1

    var = lambda k: np.asarray(ds[k], np.float64)
    p_lev1 = _lev_leading(var("p_lev"), nlev)[:, 0]
    bot_at_1 = p_lev1[0] > p_lev1[-1]
    flip = (lambda x: x) if bot_at_1 else (lambda x: x[::-1])

    col1 = lambda k, n: flip(_lev_leading(var(k), n)[:, :1])  # (n, 1)
    p_lev = np.repeat(col1("p_lev", nlev), ncol, axis=1)
    p_lay = np.repeat(col1("p_lay", nlay), ncol, axis=1)
    t_lev = np.repeat(col1("t_lev", nlev), ncol, axis=1)
    t_lay = np.repeat(col1("t_lay", nlay), ncol, axis=1)
    t_sfc = t_lev[0].copy()
    vmr_h2o = np.repeat(col1("h2o", nlay), ncol, axis=1)
    vmr_o3 = np.repeat(col1("o3", nlay), ncol, axis=1)

    names = list(lkp.gas_names)
    vmr_gm = np.zeros(len(names) + 1)
    for gas, val in _GM_VMR.items():
        if gas in names:
            vmr_gm[names.index(gas) + 1] = val

    aerosol_state = None
    if with_aerosols:
        # (nlay, ncol_ds) file columns, scattered into the 15-species axis
        a_type = flip(_lev_leading(var("aero_type"), nlay)).astype(np.int64)
        a_size = flip(_lev_leading(var("aero_size"), nlay))
        a_mass = flip(_lev_leading(var("aero_mass"), nlay))
        ncol_ref = a_type.shape[1]
        mass = np.zeros((_N_AERO, nlay, ncol_ref))
        size = np.zeros((_N_AERO, nlay, ncol_ref))
        rows = np.clip(a_type - 1, 0, _N_AERO - 1)
        lay_ix, col_ix = np.meshgrid(
            np.arange(nlay), np.arange(ncol_ref), indexing="ij"
        )
        on = a_type > 0
        mass[rows[on], lay_ix[on], col_ix[on]] = a_mass[on]
        size[rows[on], lay_ix[on], col_ix[on]] = a_size[on]
        reps = -(-ncol // ncol_ref)
        aerosol_state = dict(
            aero_size=np.tile(size, (1, 1, reps))[:, :, :ncol],
            aero_mass=np.tile(mass, (1, 1, reps))[:, :, :ncol],
        )

    # idealized clouds: 100-900 hPa, 2 of 3 dataset columns, liquid above
    # 263 K / ice below 273 K (RRTMGP.jl read_all_sky_with_aerosols.jl:133-157)
    ncol_ds = int(ds.dims["col"]) if "col" in ds.dims else _lev_leading(var("p_lev"), nlev).shape[1]
    r_eff_liq = (float(lkp_cld.radliq_lwr) + float(lkp_cld.radliq_upr)) / 2
    r_eff_ice = (float(lkp_cld.radice_lwr) + float(lkp_cld.radice_upr)) / 2
    icol_ds = np.arange(ncol) % ncol_ds + 1  # the reference's 1-based wrap
    cloudy_col = (icol_ds % 3) != 0
    in_band = (p_lay > 1e4) & (p_lay < 9e4)
    cld = in_band & cloudy_col[None, :]
    cld_frac = np.where(cld, cldfrac, 0.0)
    liq = cld & (t_lay > 263.0)
    ice = cld & (t_lay < 273.0)
    cloud_state = dict(
        cld_r_eff_liq=np.where(liq, r_eff_liq, 0.0),
        cld_r_eff_ice=np.where(ice, r_eff_ice, 0.0),
        cld_path_liq=np.where(liq, 10.0, 0.0),
        cld_path_ice=np.where(ice, 10.0, 0.0),
        cld_frac=cld_frac,
        ice_rgh=2,
    )

    st = state_tensors(p_lev, p_lay, t_lay, vmr_h2o, params, dtype, device)
    atm = atmosphere_from_numpy(
        p_lay=st["p_lay"], t_lay=st["t_lay"], p_lev=st["p_lev"], t_lev=t_lev, t_sfc=t_sfc,
        col_dry=st["col_dry"], vmr_h2o=st["vmr_h2o"], vmr_o3=vmr_o3, vmr_gm=vmr_gm,
        rel_hum=st["rel_hum"], cloud_state=cloud_state, aerosol_state=aerosol_state,
        dtype=dtype, device=device,
    )
    return atm, ncol_ds


def load_reference_fluxes(path: str, band_set: str, ncol: int) -> tuple[np.ndarray, np.ndarray]:
    """(flux_up, flux_dn), numpy float64 arrays, each (nlev, ncol)
    surface-first, column-tiled (RRTMGP.jl read_all_sky_with_aerosols.jl:204-227)."""
    ds = Dataset(path)
    nlev = int(ds.dims["lay"]) + 1
    up = _lev_leading(np.asarray(ds[f"{band_set}_flux_up"], np.float64), nlev)
    dn = _lev_leading(np.asarray(ds[f"{band_set}_flux_dn"], np.float64), nlev)
    p_lev1 = _lev_leading(np.asarray(ds["p_lev"], np.float64), nlev)[:, 0]
    if not (p_lev1[0] > p_lev1[-1]):
        up, dn = up[::-1], dn[::-1]
    reps = -(-ncol // up.shape[1])
    tile = lambda a: np.tile(a, (1, reps))[:, :ncol]
    return tile(up), tile(dn)
