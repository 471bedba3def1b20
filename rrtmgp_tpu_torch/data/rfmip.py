"""RFMIP clear-sky input reader (counterpart of ``rrtmgp_tpu/data/rfmip.py``).

Builds an AtmosphericState + BCs from the RFMIP
``multiple_input4MIPs_radiation_RFMIP...nc`` input file, as RRTMGP.jl's
``test/read_clear_sky.jl`` does: vertical flip to surface-first, TOA
pressure clamped to the lookup's p_ref_min, columns tiled to the requested
ncol, global-mean gases scaled by their ``units`` attribute, and
latitude-dependent gravity skipped (to match the Fortran reference case).

The ``units`` attribute is read from the file's own metadata in either
format (``Dataset.var_attrs``). The JAX reader reads it through h5py only,
so in a NetCDF3 file it never applies it; the files the two packages are
compared on carry no ``units``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import atmosphere_from_numpy, default_device, torch_dtype
from ..parameters import RRTMGPParameters
from ..states import AtmosphericState, compute_col_gas, compute_relative_humidity
from .lookups import GasLookup
from .netcdf import Dataset

# RFMIP variable name per lookup gas name (global means)
_GM_VARS = {
    "co2": "carbon_dioxide_GM",
    "n2o": "nitrous_oxide_GM",
    "co": "carbon_monoxide_GM",
    "ch4": "methane_GM",
    "o2": "oxygen_GM",
    "n2": "nitrogen_GM",
    "ccl4": "carbon_tetrachloride_GM",
    "cfc11": "cfc11_GM",
    "cfc12": "cfc12_GM",
    "cfc22": "hcfc22_GM",
    "hfc143a": "hfc143a_GM",
    "hfc125": "hfc125_GM",
    "hfc23": "hfc23_GM",
    "hfc32": "hfc32_GM",
    "hfc134a": "hfc134a_GM",
    "cf4": "cf4_GM",
}


def _tile_cols(arr: np.ndarray, ncol: int) -> np.ndarray:
    """Tile the trailing column axis up to ncol."""
    n = arr.shape[-1]
    reps = -(-ncol // n)
    return np.tile(arr, (1,) * (arr.ndim - 1) + (reps,))[..., :ncol]


def _units_scale(ds: Dataset, name: str) -> float:
    """The factor a ``units`` attribute such as "1e-06" gives; 1.0 when the
    variable has none or it is not a number."""
    u = ds.var_attrs.get(name, {}).get("units")
    if u is None:
        return 1.0
    try:
        return float(u.decode() if isinstance(u, bytes) else u)
    except (TypeError, ValueError):
        return 1.0


def state_tensors(p_lev, p_lay, t_lay, vmr_h2o, params, dtype, device) -> dict:
    """``p_lev``, ``p_lay``, ``t_lay`` and ``vmr_h2o`` as tensors of
    ``dtype`` on ``device``, with the column density and the relative
    humidity computed from them in that dtype (the JAX readers' order)."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
    out = dict(p_lev=t(p_lev), p_lay=t(p_lay), t_lay=t(t_lay), vmr_h2o=t(vmr_h2o))
    out["col_dry"] = compute_col_gas(out["p_lev"], params, vmr_h2o=out["vmr_h2o"])  # lat skipped
    out["rel_hum"] = compute_relative_humidity(out["p_lay"], out["t_lay"], out["vmr_h2o"], params)
    return out


def load_rfmip_atmosphere(
    path: str,
    lkp: GasLookup,
    ncol: int | None = None,
    expt_no: int = 0,
    dtype=np.float64,
    params: RRTMGPParameters = RRTMGPParameters(),
    device=None,
) -> tuple[AtmosphericState, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (AtmosphericState, sfc_emis (ncol,), sfc_alb (ncol,),
    cos_zenith (ncol,), toa_flux (ncol,)), tensors of ``dtype`` on
    ``device`` (None: the card when there is one).

    expt_no is 0-based (the reference's experiment 1 is expt_no 0).
    """
    dtype = torch_dtype(dtype)
    device = default_device() if device is None else device
    ds = Dataset(path)
    nlay = int(ds.dims["layer"])
    nlev = nlay + 1

    def var(name):
        return np.asarray(ds[name], np.float64)

    p_lev_raw = var("pres_level")
    # normalize to (level, site)
    if p_lev_raw.shape[0] != nlev:
        p_lev_raw = p_lev_raw.T
    ncol_ds = p_lev_raw.shape[1]
    ncol = ncol or ncol_ds

    def lv(name, n, with_expt=False):
        a = var(name)
        if with_expt:
            # (expt, site, layer-or-level) in C order typically
            a = a[expt_no]
        if a.shape[0] != n:
            a = a.T
        if a.shape[0] != n:
            raise ValueError(f"{name}: shape {a.shape}, expected {n} levels or layers")
        return a

    bot_at_1 = p_lev_raw[0, 0] > p_lev_raw[-1, 0]
    flip = (lambda x: x) if bot_at_1 else (lambda x: x[::-1])

    p_lev = flip(p_lev_raw).copy()
    p_lev[-1, :] = lkp.p_ref_min
    p_lay = flip(lv("pres_layer", nlay))
    t_lev = flip(lv("temp_level", nlev, with_expt=True))
    t_lay = flip(lv("temp_layer", nlay, with_expt=True))
    vmr_h2o = flip(lv("water_vapor", nlay, with_expt=True))
    vmr_o3 = flip(lv("ozone", nlay, with_expt=True))

    t_sfc = var("surface_temperature")[expt_no]
    sfc_emis = var("surface_emissivity")
    sfc_alb = var("surface_albedo")
    zenith = np.deg2rad(var("solar_zenith_angle"))
    irrad = var("total_solar_irradiance")

    tile2 = lambda a: _tile_cols(a, ncol)
    tile1 = lambda a: _tile_cols(a[None], ncol)[0]

    names = list(lkp.gas_names)
    vmr_gm = np.zeros(len(names) + 1)
    for gas, varname in _GM_VARS.items():
        if gas in names and varname in ds:
            scale = _units_scale(ds, varname)
            vmr_gm[names.index(gas) + 1] = float(np.ravel(var(varname))[expt_no]) * scale

    st = state_tensors(tile2(p_lev), tile2(p_lay), tile2(t_lay), tile2(vmr_h2o), params, dtype, device)
    atm = atmosphere_from_numpy(
        p_lay=st["p_lay"], t_lay=st["t_lay"], p_lev=st["p_lev"], t_lev=tile2(t_lev), t_sfc=tile1(t_sfc),
        col_dry=st["col_dry"], vmr_h2o=st["vmr_h2o"], vmr_o3=tile2(vmr_o3), vmr_gm=vmr_gm,
        rel_hum=st["rel_hum"], dtype=dtype, device=device,
    )
    t = lambda a: torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
    return atm, t(tile1(sfc_emis)), t(tile1(sfc_alb)), t(np.cos(tile1(zenith))), t(tile1(irrad))
