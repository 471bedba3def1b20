"""The port's RRTMGPSolver API (rrtmgp_tpu_torch.api) against the JAX
RRTMGPSolver on the CPU (its XLA path), f32, on the same lookups, state and
boundary conditions; and the API surface as tests/test_api.py exercises it.

Fluxes within 1e-4 of max |flux| (8 layers, as the slice tests), McICA
cloud cover and AOD at rtol 1e-6; the port against itself bit for bit
(update_fluxes vs the separate updates, step reproducibility, metric
scaling 2).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu as jrt
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu_torch import convert

NBND, NCOL, NLAY = 2, 12, 8
TOL = 1e-4

J_LOOKUPS = jrt.LookupBundle(
    lookup_lw=jsyn.synthetic_gas_lookup(longwave=True, n_gpt=16, n_bnd=NBND, dtype=np.float32),
    lookup_sw=jsyn.synthetic_gas_lookup(longwave=False, n_gpt=16, n_bnd=NBND, seed=1, dtype=np.float32),
    lookup_lw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=np.float32),
    lookup_sw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, seed=5, dtype=np.float32),
    lookup_lw_aero=jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=np.float32),
    lookup_sw_aero=jsyn.synthetic_aerosol_lookup(n_bnd=NBND, seed=6, dtype=np.float32),
)
T_LOOKUPS = rt.LookupBundle(
    lookup_lw=convert.gas_lookup_from_object(J_LOOKUPS.lookup_lw),
    lookup_sw=convert.gas_lookup_from_object(J_LOOKUPS.lookup_sw),
    lookup_lw_cld=convert.cloud_lookup_from_object(J_LOOKUPS.lookup_lw_cld),
    lookup_sw_cld=convert.cloud_lookup_from_object(J_LOOKUPS.lookup_sw_cld),
    lookup_lw_aero=convert.aerosol_lookup_from_object(J_LOOKUPS.lookup_lw_aero),
    lookup_sw_aero=convert.aerosol_lookup_from_object(J_LOOKUPS.lookup_sw_aero),
)
METHODS = {
    "clear": ("ClearSkyRadiation", False),
    "clear+aerosols": ("ClearSkyRadiation", True),
    "allsky": ("AllSkyRadiation", False),
    "allsky+aerosols": ("AllSkyRadiation", True),
    "allsky+clear diagnostics+aerosols": ("AllSkyRadiationWithClearSkyDiagnostics", True),
}
GETTERS = [
    "top_of_atmosphere_lw_flux_dn", "top_of_atmosphere_diffuse_sw_flux_dn",
    "lw_flux_up", "lw_flux_dn", "lw_flux_net", "surface_emissivity",
    "sw_flux_up", "sw_flux_dn", "sw_flux_net", "sw_direct_flux_dn",
    "cloud_liquid_effective_radius", "cloud_ice_effective_radius",
    "cloud_liquid_water_path", "cloud_ice_water_path", "cloud_fraction",
    "aod_sw_extinction", "aod_sw_scattering", "cos_zenith", "toa_flux",
    "direct_sw_surface_albedo", "diffuse_sw_surface_albedo",
    "surface_temperature", "pressure", "temperature",
    "optical_thickness_parameter", "relative_humidity",
    "sw_cloud_cover", "lw_cloud_cover", "latitude", "get_center_z", "get_face_z",
]
CLEAR_GETTERS = ["clear_lw_flux_up", "clear_lw_flux_dn", "clear_lw_flux", "clear_sw_flux_up",
                 "clear_sw_flux_dn", "clear_sw_direct_flux_dn", "clear_sw_flux"]


def _method(pkg, key):
    name, aero = METHODS[key]
    return getattr(pkg, name)(aerosol_radiation=aero)


def _inputs():
    """Numpy state (fractional clouds) and boundary conditions."""
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    cf = np.asarray(ja.cloud_state.cld_frac) * np.random.default_rng(41).uniform(
        0.2, 1.0, (NLAY, NCOL)).astype(np.float32)
    rng = np.random.default_rng(42)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL)).astype(np.float32)
    mass[rng.random(mass.shape) < 0.3] = 0.0
    mass[:, NLAY // 2:] = 0.0  # the thin top layers stay clean (see test_torch_solve.py)
    size = rng.uniform(0.05, 12.0, (15, NLAY, NCOL)).astype(np.float32)
    # aerosols in the lower layers (the synthetic ones sit below 800 hPa, which 8 layers miss)
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass),
                                          aero_size=jnp.asarray(size)),
    )
    mu0 = np.full(NCOL, 0.6, np.float32)
    mu0[::5] = -0.1
    bc_lw = dict(sfc_emis=np.full((NBND, NCOL), 0.98, np.float32))
    bc_sw = dict(cos_zenith=mu0, toa_flux=np.full(NCOL, 1361.0, np.float32),
                 sfc_alb_direct=np.full((NBND, NCOL), 0.2, np.float32),
                 sfc_alb_diffuse=np.full((NBND, NCOL), 0.25, np.float32))
    return ja, bc_lw, bc_sw


def _port_solver(key, isothermal=False, **kw):
    ja, bc_lw, bc_sw = _inputs()
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=torch.float32,
                               isothermal_boundary_layer=isothermal)
    tb = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    return rt.RRTMGPSolver(grid, _method(rt, key), rt.RRTMGPParameters(), rt.LwBCs(**tb(bc_lw)),
                           rt.SwBCs(**tb(bc_sw)), convert.atmosphere_from_object(ja), lookups=T_LOOKUPS,
                           **kw)


def _jax_solver(key):
    ja, bc_lw, bc_sw = _inputs()
    grid = jrt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float32)
    jb = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return jrt.RRTMGPSolver(grid, _method(jrt, key), jrt.RRTMGPParameters(), jrt.LwBCs(**jb(bc_lw)),
                            jrt.SwBCs(**jb(bc_sw)), ja, lookups=J_LOOKUPS)


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


@pytest.mark.parametrize("key", list(METHODS))
def test_solver_matches_jax_solver(key):
    port, ref = _port_solver(key), _jax_solver(key)
    for s in (port, ref):
        s.advance_step(3)
        s.update_lw_fluxes()
        s.update_sw_fluxes()
    names = ["lw_flux_up", "lw_flux_dn", "lw_flux_net", "sw_flux_up", "sw_flux_dn", "sw_flux_net",
             "sw_direct_flux_dn"]
    if "diagnostics" in key:
        names += CLEAR_GETTERS
    for name in names:
        assert _rel(getattr(port, name)(), getattr(ref, name)()) <= TOL, name
    for name in ("lw_cloud_cover", "sw_cloud_cover", "aod_sw_extinction", "aod_sw_scattering"):
        a, b = getattr(port, name)(), getattr(ref, name)()
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, err_msg=name)
    for name in GETTERS + (CLEAR_GETTERS if "diagnostics" in key else []):
        getattr(port, name)()  # must not raise


@pytest.mark.parametrize("key", ["clear+aerosols", "allsky+aerosols", "allsky+clear diagnostics+aerosols"])
def test_update_fluxes_equals_the_separate_updates(key):
    sep, pair = _port_solver(key), _port_solver(key)
    sep.advance_step(2)
    pair.advance_step(2)
    f_lw, f_sw = sep.update_lw_fluxes(), sep.update_sw_fluxes()
    p_lw, p_sw = pair.update_fluxes()
    for a, b in zip((*f_lw, *f_sw), (*p_lw, *p_sw)):
        assert torch.equal(a, b)
    if "diagnostics" in key:
        assert torch.equal(sep.clear_sw_flux_up(), pair.clear_sw_flux_up())
    if sep.sw_cloud_cover() is not None:
        assert torch.equal(sep.sw_cloud_cover(), pair.sw_cloud_cover())


def test_mcica_step_reproducibility():
    s = _port_solver("allsky")
    s.advance_step(7)
    f1 = [t.clone() for t in s.update_fluxes()[0]]
    s.advance_step(7)
    f2 = s.update_fluxes()[0]
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    assert s._mcica_key(0) == 14 and s._mcica_key(1) == 15
    s.advance_step()
    f3 = s.update_fluxes()[0]
    assert s._step == 8
    assert float((f3.flux_up - f1[0]).abs().max()) > 0.0


def test_metric_scaling_doubles_every_flux():
    s1 = _port_solver("allsky+aerosols")
    s2 = _port_solver("allsky+aerosols", metric_scaling=torch.full((NLAY + 1, NCOL), 2.0))
    for s in (s1, s2):
        s.update_fluxes()
    for a, b in zip((*s1.flux_lw, *s1.flux_sw), (*s2.flux_lw, *s2.flux_sw)):
        assert torch.equal(2.0 * a, b)


def test_clear_diagnostics_equal_a_clear_solve_and_differ_from_cloudy():
    s = _port_solver("allsky+clear diagnostics+aerosols")
    c = _port_solver("clear+aerosols")
    s.update_fluxes()
    c.update_fluxes()
    assert torch.equal(s.clear_lw_flux_up(), c.lw_flux_up())
    assert torch.equal(s.clear_sw_flux_dn(), c.sw_flux_dn())
    assert float((s.clear_lw_flux_up() - s.lw_flux_up()).abs().max()) > 1e-3


def test_getters_domain_view_and_name_lists():
    s = _port_solver("allsky+aerosols", isothermal=True)
    s.update_fluxes()
    assert s.isothermal_boundary_layer() is True
    for name in ("pressure", "temperature", "relative_humidity"):
        assert getattr(s, name)().shape == (NLAY - 1, NCOL), name
    assert torch.equal(s.pressure(), s.as_.p_lay[:-1])
    assert s.domain_view(None) is None
    assert rt.domain_view(False, torch.zeros(11, 4)).shape == (11, 4)
    assert rt.domain_view(True, torch.zeros(11, 4)).shape == (10, 4)
    assert s.volume_mixing_ratio("h2o").shape == (NLAY, NCOL)
    assert torch.equal(s.volume_mixing_ratio("h2o_self"), s.volume_mixing_ratio("h2o"))
    assert float(s.volume_mixing_ratio("co2")) == pytest.approx(397e-6)
    assert s.aero_radius("dust1").shape == (NLAY, NCOL)
    assert float(s.aero_column_mass_density("sulfate").max()) > 0.0
    assert s.check_window() is True
    assert rt.aerosol_names() == jrt.aerosol_names()
    assert rt.AEROSOL_INDEX == jrt.api.AEROSOL_INDEX
    assert rt.gas_names_sw() == jrt.gas_names_sw()
    assert set(rt.aerosol_names()) == set(rt.AEROSOL_INDEX)


def test_lookup_tables_match_jax_bitwise():
    port = rt.lookup_tables(rt.AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32)
    ref = jrt.lookup_tables(jrt.AllSkyRadiation(aerosol_radiation=True), dtype=np.float32)
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        for g in dataclasses.fields(a):
            x, y = getattr(a, g.name), getattr(b, g.name)
            if isinstance(x, torch.Tensor):
                assert np.array_equal(x.numpy(), np.asarray(y)), (f.name, g.name)
    assert port.lookup_lw.n_gpt == 256 and port.lookup_sw.n_gpt == 224
    clear = rt.lookup_tables(rt.ClearSkyRadiation())
    assert clear.lookup_lw_cld is None and clear.lookup_sw_aero is None
    assert clear.lookup_lw.kmajor.dtype == torch.float64
    assert rt.lookup_tables(rt.GrayRadiation()) == rt.LookupBundle()


def _checkout(root):
    """A small fabricated rrtmgp-data checkout (tests/test_loader.py's
    writers under the v1.9 file names); name -> path."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_loader as tl

    from rrtmgp_tpu_torch.data.manifest import V19_FILES

    paths = {k: os.path.join(root, f) for k, f in V19_FILES.items()}
    tl._write_gas_nc(paths["gas_lw"], longwave=True)
    tl._write_gas_nc(paths["gas_sw"], longwave=False)
    for band_set in ("lw", "sw"):
        tl._write_cloud_nc(paths[f"cloud_{band_set}"])
        tl._write_aerosol_nc(paths[f"aerosol_{band_set}"])
    return paths


def _assert_same(a, b):
    from rrtmgp_tpu_torch.states import tree_leaves

    assert type(a) is type(b)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))
    assert all(getattr(a, f.name) == getattr(b, f.name) for f in dataclasses.fields(a)
               if not isinstance(getattr(a, f.name), torch.Tensor | None))


def test_what_is_not_ported_raises(monkeypatch, tmp_path):
    ja, bc_lw, bc_sw = _inputs()
    atm = convert.atmosphere_from_object(ja)
    bl = rt.LwBCs(sfc_emis=torch.from_numpy(bc_lw["sfc_emis"]))
    bs = rt.SwBCs(**{k: torch.from_numpy(v) for k, v in bc_sw.items()})
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL)
    mk = lambda method, **kw: rt.RRTMGPSolver(grid, method, rt.RRTMGPParameters(), bl, bs, atm,
                                              lookups=T_LOOKUPS, **kw)
    # the gray model, once refused here (item 12), now runs
    gray_atm = rt.setup_gray_as_pr_grid(NLAY, torch.linspace(-60.0, 60.0, NCOL), 1e5, 9e3,
                                        rt.GrayOpticalThicknessOGorman2008(), rt.RRTMGPParameters(), device="cpu")
    gray = rt.RRTMGPSolver(grid, rt.GrayRadiation(), rt.RRTMGPParameters(), bl, bs, gray_atm)
    lw, sw = gray.update_fluxes()
    assert gray.auto_chunk is None and lw.flux_up.shape == sw.flux_dn.shape == (NLAY + 1, NCOL)
    assert all(torch.isfinite(f).all() for f in (*lw, *sw))
    with pytest.raises(NotImplementedError, match="item 14"):
        mk(rt.ClearSkyRadiation(), mesh=object())
    # rrtmgp-data files, once refused here (item 15), now load: a checkout
    # gives the loader's lookups, a missing one raises the loader's error
    from rrtmgp_tpu_torch.data import loader

    paths = _checkout(str(tmp_path))
    got = rt.lookup_tables(rt.ClearSkyRadiation(), data_dir=str(tmp_path), device="cpu")
    _assert_same(got.lookup_lw, loader.load_gas_lookup(paths["gas_lw"], device="cpu"))
    _assert_same(got.lookup_sw, loader.load_gas_lookup(paths["gas_sw"], device="cpu"))
    with pytest.raises(FileNotFoundError, match="rrtmgp-gas-lw-g256.nc"):
        rt.lookup_tables(rt.ClearSkyRadiation(), data_dir=str(tmp_path / "nonexistent"))
    # dtype mismatch between the grid and the state
    with pytest.raises(TypeError, match="dtype"):
        rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=torch.float64),
                        rt.ClearSkyRadiation(), rt.RRTMGPParameters(), bl, bs, atm, lookups=T_LOOKUPS)
    # f64 above the memory budget: chunked like the JAX package, no refusal
    atm64 = atm.to(dtype=torch.float64)
    lk64 = rt.LookupBundle(**{f.name: getattr(T_LOOKUPS, f.name).to(dtype=torch.float64)
                              for f in dataclasses.fields(T_LOOKUPS)})
    mk64 = lambda: rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=torch.float64),
                                   rt.AllSkyRadiation(), rt.RRTMGPParameters(), bl.to(dtype=torch.float64),
                                   bs.to(dtype=torch.float64), atm64, lookups=lk64)
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", "0.0001")
    with pytest.warns(UserWarning, match=r"auto-chunking into 2-column chunks \(budget 0 GB"):
        chunked = mk64()
    assert chunked.auto_chunk == 2
    monkeypatch.delenv("RRTMGP_CHUNK_BUDGET_GB")
    s = mk64()
    assert s.auto_chunk is None
    assert s.update_lw_fluxes().flux_up.dtype == torch.float64
    for a, b in zip(chunked.update_lw_fluxes(), s.flux_lw):
        assert torch.equal(a, b)
    assert torch.equal(chunked.lw_cloud_cover(), s.lw_cloud_cover())


@pytest.mark.parametrize("key", ["clear", "clear+aerosols", "allsky", "allsky+aerosols"])
def test_lookup_tables_from_files_match_jax(key, tmp_path, monkeypatch):
    """lookup_tables(data_dir=...) and $RRTMGP_DATA load the files the
    method needs, equal to the JAX package's lookup_tables on the same
    checkout bit for bit (f32); RRTMGPSolver(data_dir=...) reaches them."""
    _checkout(str(tmp_path))
    name, aero = METHODS[key]
    method, jmethod = getattr(rt, name)(aerosol_radiation=aero), getattr(jrt, name)(aerosol_radiation=aero)
    got = rt.lookup_tables(method, data_dir=str(tmp_path), dtype=torch.float32, device="cpu")
    ref = jrt.lookup_tables(jmethod, data_dir=str(tmp_path), dtype=np.float32)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        assert (a is None) == (b is None), f.name
        if a is None:
            continue
        for g in dataclasses.fields(b):
            x, y = getattr(a, g.name), getattr(b, g.name)
            if isinstance(y, torch.Tensor):
                assert y.dtype == torch.float32 and np.array_equal(np.asarray(x), y.numpy()), (f.name, g.name)
            else:
                assert x == y, (f.name, g.name)
    monkeypatch.setenv("RRTMGP_DATA", str(tmp_path))
    env = rt.lookup_tables(method, dtype=torch.float32, device="cpu")
    _assert_same(env.lookup_sw, got.lookup_sw)
    atm = convert.atmosphere_from_object(jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, ngas=4, dtype=np.float32,
                                                                   p_top=12.0), device="cpu")
    monkeypatch.delenv("RRTMGP_DATA")
    solver = rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL), method, rt.RRTMGPParameters(),
                             rt.LwBCs(sfc_emis=torch.full((NBND, NCOL), 0.98)), None, atm,
                             data_dir=str(tmp_path))
    for f in dataclasses.fields(got):
        if getattr(got, f.name) is not None:
            _assert_same(getattr(solver.lookups, f.name), getattr(got, f.name))
    if key == "clear":  # the test files' cloud and aerosol tables have 6 bands, the gas tables 2
        assert torch.isfinite(solver.update_lw_fluxes().flux_up).all()
