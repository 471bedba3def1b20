"""Golden-flux tests of the port vs the Fortran RTE-RRTMGP reference data
(the port's counterpart of tests/test_real_data.py, the same cases and
tolerances).

Activates when $RRTMGP_DATA points at an rrtmgp-data v1.9 checkout; skips
otherwise. The reference's full matrix (RRTMGP.jl test/runtests.jl:18-61):
RFMIP clear-sky (100 columns) and all-sky ±aerosols (128 columns,
cldfrac=1), each with {LW no-scat, LW two-stream} x {f64, f32} x SW
two-stream, against rlu/rld/rsu/rsd / rrtmgp-allsky-* at the reference's
L-inf tolerances, in eta_node_mode="reference" unless
$RRTMGP_ETA_NODE_MODE says otherwise (tests/test_real_data.py explains
why). The solves run on the card when there is one (the port's default
device), else on the CPU.

The case functions (``clear_sky_lw`` ...) return (max error up, max error
down, tolerance); tests/test_torch_golden_rehearsal.py runs them on a
fabricated checkout.
"""

import functools
import os

import numpy as np
import pytest
import torch

from rrtmgp_tpu_torch import LwBCs, RRTMGPParameters, SwBCs, solve_lw, solve_sw
from rrtmgp_tpu_torch.convert import default_device, torch_dtype
from rrtmgp_tpu_torch.data import artifact_paths as ap
from rrtmgp_tpu_torch.data.allsky import load_allsky_atmosphere, load_reference_fluxes
from rrtmgp_tpu_torch.data.loader import load_aerosol_lookup, load_cloud_lookup, load_gas_lookup
from rrtmgp_tpu_torch.data.netcdf import Dataset
from rrtmgp_tpu_torch.data.rfmip import load_rfmip_atmosphere
from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica

pytestmark = pytest.mark.skipif(
    not ap.have_data(), reason="RRTMGP_DATA not set / rrtmgp-data not present"
)

NCOL = 100
# RRTMGP.jl test/runtests.jl:21-23: {dtype: tol} per solver
TOL_LW_NOSCAT = {np.float64: 1e-4, np.float32: 0.05}
# the reference files are no-scat-rescaled, so two-stream gets a loose gate
# (RRTMGP.jl clear_sky_utils.jl:177-179)
TOL_LW_2STREAM = {np.float64: 4.5, np.float32: 4.5}
TOL_SW = {np.float64: 1e-3, np.float32: 0.04}
TOL_ALLSKY_LW_NOSCAT = {np.float64: 1e-5, np.float32: 0.05}
TOL_ALLSKY_LW_2STREAM = {np.float64: 5.0, np.float32: 5.0}
TOL_ALLSKY_SW = {np.float64: 1e-5, np.float32: 0.06}
NCOL_ALLSKY = 128

FTS = [np.float64, np.float32]
FT_IDS = ["f64", "f32"]


def eta_node_mode() -> str:
    return os.environ.get("RRTMGP_ETA_NODE_MODE", "reference")


def golden_params() -> RRTMGPParameters:
    """RRTMGP.jl clear_sky_utils.jl:42 parameter overrides."""
    return RRTMGPParameters(grav=9.80665, molmass_dryair=0.028964, molmass_water=0.018016)


def _linf(flux, ref_up, ref_dn):
    up = flux.flux_up.double().cpu().numpy()
    dn = flux.flux_dn.double().cpu().numpy()
    return float(np.max(np.abs(up - ref_up))), float(np.max(np.abs(dn - ref_dn)))


@functools.lru_cache(maxsize=None)
def _clear_sky_setup(root: str, dtype):
    lkp_lw = load_gas_lookup(ap.get_lookup_filename("gas", "lw"), dtype=dtype)
    lkp_sw = load_gas_lookup(ap.get_lookup_filename("gas", "sw"), dtype=dtype)
    atm, sfc_emis, sfc_alb, cos_zenith, toa_flux = load_rfmip_atmosphere(
        ap.get_input_filename("clearsky", "lw"), lkp_lw, ncol=NCOL, expt_no=0, dtype=dtype,
        params=golden_params(),
    )
    return lkp_lw, lkp_sw, atm, sfc_emis, sfc_alb, cos_zenith, toa_flux


def _reference_flux(problemtype, band_set, flux, var, expt_no=0):
    """(nlev, ncol) surface-first reference flux (RRTMGP.jl read_clear_sky.jl:149-174)."""
    ds = Dataset(ap.get_reference_filename(problemtype, band_set, flux))
    a = np.asarray(ds[var], np.float64)[expt_no].T  # C-order (expt, site, level) -> (level, site)
    # orient surface-first using the input file's level order
    p = np.asarray(Dataset(ap.get_input_filename("clearsky", "lw"))["pres_level"], np.float64)
    if p.shape[0] != a.shape[0]:
        p = p.T
    if not (p[0, 0] > p[-1, 0]):  # TOA-first input -> flip to surface-first
        a = a[::-1]
    return a[:, :NCOL]


def clear_sky_lw(dtype, two_stream: bool):
    lkp_lw, _, atm, sfc_emis, *_ = _clear_sky_setup(ap.data_root(), dtype)
    bcs = LwBCs(sfc_emis=sfc_emis[None, :].expand(lkp_lw.n_bnd, NCOL).contiguous())
    flux, _ = solve_lw(lkp_lw, atm, bcs, two_stream=two_stream, eta_node_mode=eta_node_mode())
    err = _linf(flux, _reference_flux("gas", "lw", "flux_up", "rlu"), _reference_flux("gas", "lw", "flux_dn", "rld"))
    return (*err, (TOL_LW_2STREAM if two_stream else TOL_LW_NOSCAT)[dtype])


def clear_sky_sw(dtype):
    _, lkp_sw, atm, _, sfc_alb, cos_zenith, toa_flux = _clear_sky_setup(ap.data_root(), dtype)
    alb = sfc_alb[None, :].expand(lkp_sw.n_bnd, NCOL).contiguous()
    bcs = SwBCs(cos_zenith=cos_zenith, toa_flux=toa_flux, sfc_alb_direct=alb, sfc_alb_diffuse=alb)
    flux, _ = solve_sw(lkp_sw, atm, bcs, eta_node_mode=eta_node_mode())
    # night columns identically zero (RRTMGP.jl clear_sky_utils.jl:106-121)
    night = cos_zenith <= 0
    assert torch.all(flux.flux_up[:, night] == 0.0) and torch.all(flux.flux_dn[:, night] == 0.0)
    err = _linf(flux, _reference_flux("gas", "sw", "flux_up", "rsu"), _reference_flux("gas", "sw", "flux_dn", "rsd"))
    return (*err, TOL_SW[dtype])


@functools.lru_cache(maxsize=None)
def _allsky_setup(root: str, with_aerosols: bool, band_set: str, dtype):
    problem = "gas_clouds_aerosols" if with_aerosols else "gas_clouds"
    input_path = ap.get_reference_filename(problem, band_set)
    lkp = load_gas_lookup(ap.get_lookup_filename("gas", band_set), dtype=dtype)
    lkp_cld = load_cloud_lookup(ap.get_lookup_filename("cloud", band_set), dtype=dtype)
    lkp_aero = (
        load_aerosol_lookup(ap.get_lookup_filename("aerosol", band_set), dtype=dtype)
        if with_aerosols else None
    )
    atm, _ = load_allsky_atmosphere(
        input_path, lkp, lkp_cld, ncol=NCOL_ALLSKY, cldfrac=1.0,
        with_aerosols=with_aerosols, dtype=dtype, params=golden_params(),
    )
    return input_path, lkp, lkp_cld, lkp_aero, atm


def allsky(with_aerosols: bool, band_set: str, dtype, lw_two_stream: bool = False):
    input_path, lkp, lkp_cld, lkp_aero, atm = _allsky_setup(ap.data_root(), with_aerosols, band_set, dtype)
    # cldfrac = 1 makes the McICA mask deterministic (RRTMGP.jl runtests.jl:44-45)
    mask = build_cloud_mask_mcica(atm.cloud_state.cld_frac, lkp.n_gpt, 0)
    f = lambda shape, v: torch.full(shape, v, dtype=torch_dtype(dtype), device=atm.p_lay.device)
    kw = dict(lkp_cld=lkp_cld, lkp_aero=lkp_aero, cld_mask=mask, eta_node_mode=eta_node_mode())
    if band_set == "lw":
        bcs = LwBCs(sfc_emis=f((lkp.n_bnd, NCOL_ALLSKY), 0.98))
        flux, _ = solve_lw(lkp, atm, bcs, two_stream=lw_two_stream, **kw)
        tol = (TOL_ALLSKY_LW_2STREAM if lw_two_stream else TOL_ALLSKY_LW_NOSCAT)[dtype]
    else:
        bcs = SwBCs(cos_zenith=f((NCOL_ALLSKY,), 0.86), toa_flux=f((NCOL_ALLSKY,), float(lkp.solar_src_tot)),
                    sfc_alb_direct=f((lkp.n_bnd, NCOL_ALLSKY), 0.06),
                    sfc_alb_diffuse=f((lkp.n_bnd, NCOL_ALLSKY), 0.06))
        flux, _ = solve_sw(lkp, atm, bcs, **kw)
        tol = TOL_ALLSKY_SW[dtype]
    return (*_linf(flux, *load_reference_fluxes(input_path, band_set, NCOL_ALLSKY)), tol)


def _check(name, dtype, err_up, err_dn, tol):
    print(f"{name} {np.dtype(dtype).name} L-inf: up {err_up:.2e}, dn {err_dn:.2e} W/m^2 (tol {tol}, "
          f"device {default_device()})")
    assert err_up <= tol
    assert err_dn <= tol


@pytest.mark.parametrize("dtype", FTS, ids=FT_IDS)
@pytest.mark.parametrize("two_stream", [False, True], ids=["noscat", "2stream"])
def test_clear_sky_lw_golden(dtype, two_stream):
    _check(f"clear-sky LW {'2stream' if two_stream else 'noscat'}", dtype, *clear_sky_lw(dtype, two_stream))


@pytest.mark.parametrize("dtype", FTS, ids=FT_IDS)
def test_clear_sky_sw_2stream_golden(dtype):
    _check("clear-sky SW 2-stream", dtype, *clear_sky_sw(dtype))


@pytest.mark.parametrize("dtype", FTS, ids=FT_IDS)
@pytest.mark.parametrize("two_stream", [False, True], ids=["noscat", "2stream"])
@pytest.mark.parametrize("with_aerosols", [False, True])
def test_allsky_lw_golden(with_aerosols, two_stream, dtype):
    _check(f"allsky(aero={with_aerosols}) LW {'2stream' if two_stream else 'noscat'}", dtype,
           *allsky(with_aerosols, "lw", dtype, lw_two_stream=two_stream))


@pytest.mark.parametrize("dtype", FTS, ids=FT_IDS)
@pytest.mark.parametrize("with_aerosols", [False, True])
def test_allsky_sw_2stream_golden(with_aerosols, dtype):
    _check(f"allsky(aero={with_aerosols}) SW", dtype, *allsky(with_aerosols, "sw", dtype))
