"""The port's input readers (rrtmgp_tpu_torch.data.rfmip, .allsky) against
the JAX package's on the same files: the RFMIP clear-sky input (TOA-first
and surface-first, tiled past its sites, both experiments) and the all-sky
example (tiling, the TOA-first flip, cloud placement, the aerosol scatter,
the reference fluxes).

Tolerance: every state tensor and boundary array bit for bit, of the same
dtype, in f64 and f32, except the relative humidity, which goes through
exp: XLA's CPU exp and torch's differ by one ulp on some inputs (the
column density, which has no exp, is bitwise), so it is held within 2 ulp
of the JAX value.
"""

import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import fabricate_rrtmgp_data as fab  # noqa: E402
import test_allsky_reader as tar  # noqa: E402
import test_golden_rehearsal as tgr  # noqa: E402
import test_loader as tl  # noqa: E402

from rrtmgp_tpu.data import allsky as jas  # noqa: E402
from rrtmgp_tpu.data import loader as jl  # noqa: E402
from rrtmgp_tpu.data import rfmip as jrf  # noqa: E402
from rrtmgp_tpu.parameters import RRTMGPParameters as JParams  # noqa: E402
from rrtmgp_tpu_torch import convert  # noqa: E402
from rrtmgp_tpu_torch.data import allsky as pas  # noqa: E402
from rrtmgp_tpu_torch.data import loader as pl  # noqa: E402
from rrtmgp_tpu_torch.data import rfmip as prf  # noqa: E402
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere  # noqa: E402
from rrtmgp_tpu_torch.parameters import RRTMGPParameters  # noqa: E402
from rrtmgp_tpu_torch.states import AtmosphericState  # noqa: E402

DTYPES = [np.float64, np.float32]
#: the golden runs' parameters (RRTMGP.jl clear_sky_utils.jl:42)
GOLDEN = dict(grav=9.80665, molmass_dryair=0.028964, molmass_water=0.018016)
STATE = ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "col_dry")


def _same(ref, out, name, ulps=0):
    ref, out = np.asarray(ref), out.numpy()
    assert ref.dtype == out.dtype and ref.shape == out.shape, (name, ref.dtype, out.dtype, ref.shape, out.shape)
    if ulps == 0:
        assert np.array_equal(ref, out), (name, np.abs(ref.astype(np.float64) - out).max())
    else:
        assert np.all(np.abs(ref - out) <= ulps * np.spacing(np.abs(ref))), name


def assert_same_state(ref, out: AtmosphericState):
    for k in STATE:
        _same(getattr(ref, k), getattr(out, k), k)
    for k in ("vmr_h2o", "vmr_o3", "vmr"):
        _same(getattr(ref.vmr, k), getattr(out.vmr, k), k)
    if ref.rel_hum is None:
        assert out.rel_hum is None
    else:
        _same(ref.rel_hum, out.rel_hum, "rel_hum", ulps=2)
    for sub, fields in (("cloud_state", convert.CLOUD_STATE_ARRAYS), ("aerosol_state", ("aero_size", "aero_mass"))):
        a, b = getattr(ref, sub), getattr(out, sub)
        assert (a is None) == (b is None), sub
        if a is not None:
            for k in fields:
                _same(getattr(a, k), getattr(b, k), f"{sub}.{k}")
    if ref.cloud_state is not None:
        assert ref.cloud_state.ice_rgh == out.cloud_state.ice_rgh


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The lookups (JAX, port) of a gas file and the input files."""
    root = tmp_path_factory.mktemp("readers")
    gas = str(root / "gas-lw.nc")
    tl._write_gas_nc(gas, longwave=True)
    rfmip = str(root / "rfmip.nc")
    tgr._write_rfmip_input(rfmip, gas)
    # surface-first RFMIP file with a units attribute, from the fabricated-checkout writer
    atm = synthetic_atmosphere(ncol=7, nlay=tgr.NLAY, p_top=15.0, device="cpu")
    a = {k: getattr(atm, k).numpy() for k in ("p_lev", "p_lay", "t_lev", "t_lay", "t_sfc")}
    a.update(vmr_h2o=atm.vmr.vmr_h2o.numpy(), vmr_o3=atm.vmr.vmr_o3.numpy())
    rfmip_sfc = str(root / "rfmip-sfc.nc")
    fab.write_rfmip_file(rfmip_sfc, {k: v[::-1] if v.ndim == 2 else v for k, v in a.items()},
                         {"carbon_dioxide_GM": 397e-6, "nitrous_oxide_GM": 3.2e-7}, np.full(7, 0.98),
                         np.full(7, 0.07), np.linspace(10.0, 100.0, 7), np.full(7, 1361.0))
    allsky = str(root / "allsky.nc")
    tar._write_allsky_nc(allsky)
    allsky_flux = str(root / "allsky-flux.nc")
    n = tgr.NLAY + 1
    tgr._write_allsky_file(allsky_flux, "sw", fluxes=(np.arange(n * 9.0).reshape(n, 9), np.ones((n, 9))))
    return dict(gas=gas, rfmip=rfmip, rfmip_sfc=rfmip_sfc, allsky=allsky, allsky_flux=allsky_flux)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", [("rfmip", None, 0), ("rfmip", 250, 0), ("rfmip", 64, 1), ("rfmip_sfc", 20, 0)],
                         ids=["sites", "tiled", "expt1", "surface_first"])
def test_rfmip_equals_jax(files, case, dtype):
    name, ncol, expt = case
    jlk, plk = jl.load_gas_lookup(files["gas"], dtype), pl.load_gas_lookup(files["gas"], dtype, device="cpu")
    ref = jrf.load_rfmip_atmosphere(files[name], jlk, ncol=ncol, expt_no=expt, dtype=dtype, params=JParams(**GOLDEN))
    out = prf.load_rfmip_atmosphere(files[name], plk, ncol=ncol, expt_no=expt, dtype=dtype,
                                    params=RRTMGPParameters(**GOLDEN), device="cpu")
    assert_same_state(ref[0], out[0])
    for k, (a, b) in enumerate(zip(ref[1:], out[1:])):
        _same(a, b, ("sfc_emis", "sfc_alb", "cos_zenith", "toa_flux")[k])
    p = out[0].p_lev.numpy()
    assert np.all(p[0] > p[-1]) and np.all(p[-1] == np.float64(plk.p_ref_min).astype(dtype))


def test_rfmip_units_attribute(files, tmp_path):
    """A global mean's units attribute scales it, read from the file's own
    metadata (here NetCDF3; the JAX reader reads it only through h5py)."""
    from scipy.io import netcdf_file

    path = str(tmp_path / "rfmip-units.nc")
    with open(files["rfmip"], "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    with netcdf_file(path, "a") as f:
        f.variables["carbon_dioxide_GM"].units = "1e-06"
    plk = pl.load_gas_lookup(files["gas"], device="cpu")
    plain = prf.load_rfmip_atmosphere(files["rfmip"], plk, device="cpu")[0]
    scaled = prf.load_rfmip_atmosphere(path, plk, device="cpu")[0]
    ig = list(plk.gas_names).index("co2") + 1
    assert scaled.vmr.vmr[ig].item() == plain.vmr.vmr[ig].item() * 1e-6


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", [(10, 1.0, True), (12, 0.7, False), (tar.NCOL_DS, 1.0, True), (128, 1.0, True)],
                         ids=["tiled", "cloud_fraction", "file_columns", "golden_width"])
def test_allsky_equals_jax(files, case, dtype):
    ncol, cldfrac, aero = case
    jlk, plk = tar.LKP, convert.gas_lookup_from_object(tar.LKP, device="cpu")
    jcl = tar.LKP_CLD
    pcl = convert.cloud_lookup_from_object(jcl, device="cpu")
    if dtype == np.float32:
        jcl = jax.tree_util.tree_map(lambda x: x.astype(np.float32), jcl)
        pcl = pcl.to(dtype=convert.torch_dtype(dtype))
    ref, n_ref = jas.load_allsky_atmosphere(files["allsky"], jlk, jcl, ncol=ncol, cldfrac=cldfrac,
                                            with_aerosols=aero, dtype=dtype, params=JParams(**GOLDEN))
    out, n_out = pas.load_allsky_atmosphere(files["allsky"], plk, pcl, ncol=ncol, cldfrac=cldfrac,
                                            with_aerosols=aero, dtype=dtype, params=RRTMGPParameters(**GOLDEN),
                                            device="cpu")
    assert n_ref == n_out == tar.NCOL_DS
    assert_same_state(ref, out)
    if aero:
        assert out.aerosol_state.aero_mass.shape == (15, tar.NLAY, ncol)
    assert bool((out.cloud_state.cld_frac > 0).any())


def test_allsky_matches_expected(files):
    """The reader against the fabricated-checkout writer's independent
    construction of what it must build (allsky_expected), on a file written
    by that writer."""
    atm = synthetic_atmosphere(ncol=5, nlay=24, p_top=15.0, device="cpu")
    a = {k: getattr(atm, k).numpy() for k in ("p_lev", "p_lay", "t_lev", "t_lay")}
    a.update(h2o=atm.vmr.vmr_h2o.numpy(), o3=atm.vmr.vmr_o3.numpy())
    aero = fab.allsky_aerosols(a["p_lay"])
    path = os.path.join(os.path.dirname(files["allsky"]), "allsky-fab.nc")
    fab.write_allsky_file(path, a, aero)
    plk = convert.gas_lookup_from_object(tar.LKP, device="cpu")
    pcl = convert.cloud_lookup_from_object(tar.LKP_CLD, device="cpu")
    out, n = pas.load_allsky_atmosphere(path, plk, pcl, ncol=23, device="cpu")
    r_liq = (float(pcl.radliq_lwr) + float(pcl.radliq_upr)) / 2
    r_ice = (float(pcl.radice_lwr) + float(pcl.radice_upr)) / 2
    want = fab.allsky_expected(a, aero, r_liq, r_ice, 23)
    assert n == 5
    for k in ("p_lev", "p_lay", "t_lev", "t_lay", "t_sfc"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), want[k])
    np.testing.assert_array_equal(out.vmr.vmr_h2o.numpy(), want["vmr_h2o"])
    for k, v in want["aerosol_state"].items():
        np.testing.assert_array_equal(getattr(out.aerosol_state, k).numpy(), v)
    for k in convert.CLOUD_STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(out.cloud_state, k).numpy(), want["cloud_state"][k])
    assert aero["aero_type"].max() > 1 and out.aerosol_state.aero_mass.sum() > 0


@pytest.mark.parametrize("name,band_set,ncol", [("allsky", "lw", 8), ("allsky_flux", "sw", 20)])
def test_reference_fluxes_equal_jax(files, name, band_set, ncol):
    ref = jas.load_reference_fluxes(files[name], band_set, ncol)
    out = pas.load_reference_fluxes(files[name], band_set, ncol)
    for a, b in zip(ref, out):
        assert isinstance(b, np.ndarray) and b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
