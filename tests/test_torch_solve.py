"""The clear-sky slice as a whole: port solve_lw / solve_sw against the JAX
solve_lw / solve_sw on the XLA path, on the same inputs.

ncol 128 and ncol 100 (the JAX megakernel takes only multiples of 128; the
port takes any ncol). Tolerance: max |port - jax| / max |jax| <= 1e-5 in f32,
1e-10 in f64 — the same algorithm in the same order, up to a few ulp of
exp and of the eta-blend multiplication order.

8 layers: with more, the synthetic column's top layers get optically thin
(tau ~ 1e-4), where the Clough factor (1-exp(-x))/x - exp(-x) of both
packages cancels in f32, and XLA's CPU exp, which differs from torch's by
an ulp, then moves LW fluxes by ~1e-4 of their maximum (measured at 12
layers with identical optics fed to both sweeps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs
from rrtmgp_tpu_torch import LwBCs, SwBCs, convert, solve_lw, solve_sw
from rrtmgp_tpu_torch.angular import angular_discretization
from rrtmgp_tpu_torch.ops import mega
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

NLAY = 8
TOL = {np.float32: 1e-5, np.float64: 1e-10}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _lw_case(ncol, dtype):
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, seed=2, dtype=dtype)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=dtype)
    emis = np.random.default_rng(3).uniform(0.9, 1.0, (4, ncol)).astype(dtype)
    return jl, ja, JLwBCs(sfc_emis=jnp.asarray(emis)), convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja), \
        convert.lw_bcs_from_numpy(sfc_emis=emis)


def _sw_case(ncol, dtype):
    jl = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=2, dtype=dtype)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=dtype)
    rng = np.random.default_rng(4)
    mu0 = rng.uniform(0.05, 1.0, ncol).astype(dtype)
    mu0[1::4] = np.asarray([0.0, 1e-6, -0.2], dtype)[np.arange(len(mu0[1::4])) % 3]
    bc = dict(
        cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, dtype),
        sfc_alb_direct=rng.uniform(0.05, 0.4, (4, ncol)).astype(dtype),
        sfc_alb_diffuse=rng.uniform(0.05, 0.4, (4, ncol)).astype(dtype),
    )
    return jl, ja, JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}), convert.gas_lookup_from_object(jl), \
        convert.atmosphere_from_object(ja), convert.sw_bcs_from_numpy(**bc)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ncol", [128, 100])
def test_solve_lw_matches_jax(ncol, dtype):
    jl, ja, jb, tl, ta, tb = _lw_case(ncol, dtype)
    ref, _ = jax.jit(lambda a, b: jmod.solve_lw(jl, a, b))(ja, jb)
    out, diag = solve_lw(tl, ta, tb)
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= TOL[dtype], name
    assert torch.all(out.flux_dn[-1] == 0.0)
    assert diag.cld_cover is None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ncol", [128, 100])
def test_solve_sw_matches_jax_and_zeroes_night(ncol, dtype):
    jl, ja, jb, tl, ta, tb = _sw_case(ncol, dtype)
    ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jl, a, b))(ja, jb)
    out, _ = solve_sw(tl, ta, tb)
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= TOL[dtype], name
    night = tb.cos_zenith <= 0
    assert night.any()
    for f in out:
        assert torch.all(f[:, night] == 0.0)


def test_kernel_path_composition_matches_jax_at_unaligned_ncol():
    """The kernel path's pieces (mega inputs, band Planck, megakernel), run
    through the wrappers on CPU tensors (their plain twins), against the JAX
    XLA solve at ncol 100."""
    jl, ja, jb, tl, ta, tb = _lw_case(100, np.float32)
    ref, _ = jax.jit(lambda a, b: jmod.solve_lw(jl, a, b))(ja, jb)
    tabs, inp = tl.kernel_tables, mega_lw_inputs(tl, ta)
    plk = lambda t: mega.planck_band(t.reshape(-1), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    Ds, wts = angular_discretization(1)
    up, dn = mega.lw_clear_mega(inp, tabs, plk(ta.t_lay), plk(ta.t_lev), plk(ta.t_sfc),
                                tb.sfc_emis, None, float(Ds[0]), float(wts[0]))
    assert _rel(up, ref.flux_up) <= 1e-5 and _rel(dn, ref.flux_dn) <= 1e-5

    jl, ja, jb, tl, ta, tb = _sw_case(100, np.float32)
    ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jl, a, b))(ja, jb)
    tabs, inp = tl.kernel_tables, mega_sw_inputs(tl, ta)
    toa_gpt = tb.toa_flux[:, None] * tl.solar_src_scaled[None, :]
    out = mega.sw_clear_mega(inp, tabs, tb.cos_zenith, toa_gpt, tb.sfc_alb_direct,
                             tb.sfc_alb_diffuse, None)
    day = tb.cos_zenith > 0
    for name, port in zip(("flux_up", "flux_dn", "flux_dn_dir"), out):
        r = _rel(port[:, day], np.asarray(getattr(ref, name))[:, day.numpy()])
        assert r <= 1e-5, (name, r)


def test_incident_flux_multi_angle_and_metric_scaling():
    jl, ja, jb, tl, ta, tb = _lw_case(16, np.float64)
    inc = np.random.default_rng(9).uniform(0.0, 2.0, (16, 32))
    scale = np.linspace(0.9, 1.1, NLAY + 1)[:, None] * np.ones((1, 16))
    ref, _ = jax.jit(lambda a, b: jmod.solve_lw(
        jl, a, b, n_gauss_angles=3, metric_scaling=jnp.asarray(scale)))(
        ja, dataclasses.replace(jb, inc_flux=jnp.asarray(inc)))
    out, _ = solve_lw(tl, ta, dataclasses.replace(tb, inc_flux=torch.from_numpy(inc)),
                      n_gauss_angles=3, metric_scaling=torch.from_numpy(scale))
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= 1e-10, name

    jl, ja, jb, tl, ta, tb = _sw_case(16, np.float64)
    inc = np.random.default_rng(8).uniform(0.0, 2.0, (16, 32))
    ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jl, a, b, metric_scaling=jnp.asarray(scale)))(
        ja, dataclasses.replace(jb, inc_flux_diffuse=jnp.asarray(inc)))
    out, _ = solve_sw(tl, ta, dataclasses.replace(tb, inc_flux_diffuse=torch.from_numpy(inc)),
                      metric_scaling=torch.from_numpy(scale))
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= 1e-10, name


def test_kernel_impl_on_cpu_raises():
    _, _, _, tl, ta, tb = _lw_case(8, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        solve_lw(tl, ta, tb, impl="kernel")
    _, _, _, sl, sa, sb = _sw_case(8, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        solve_sw(sl, sa, sb, impl="kernel")
    with pytest.raises(ValueError):
        solve_lw(tl, ta, tb, impl="xla")


@pytest.fixture
def kernel_dispatch(monkeypatch):
    """solve_* take their kernel path whatever the device: what that path
    does not cover raises before any kernel is reached, and on CPU tensors
    the wrappers run their plain twins, so the dispatch is testable without
    a card."""
    from rrtmgp_tpu_torch.models import rrtmgp as tmod

    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "kernel")


def _noscat_allsky_case():
    """Port inputs of an all-sky LW no-scattering solve with the JAX
    objects of the same numbers (fractional clouds, aerosols below)."""
    from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica

    ncol = 24
    jl, ja, jb, tl, _, tb = _lw_case(ncol, np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    rng = np.random.default_rng(21)
    cf = np.asarray(ja.cloud_state.cld_frac) * rng.uniform(0.2, 1.0, (NLAY, ncol)).astype(np.float32)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, ncol)).astype(np.float32)
    mass[:, NLAY // 2:] = 0.0  # the thin top layers stay clean (see the module docstring)
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass)),
    )
    jc = jsyn.synthetic_cloud_lookup(n_bnd=4, dtype=np.float32)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32)
    mask = np.array(build_cloud_mask_mcica(jax.random.key(6), ja.cloud_state.cld_frac, jl.n_gpt))
    jax_kw = {"n_gauss_angles=2": dict(n_gauss_angles=2),
              "n_gauss_angles=4": dict(n_gauss_angles=4),
              "clouds by seed": dict(lkp_cld=jc, cld_mask_seed=6),
              "aerosols": dict(lkp_aero=jae),
              "clouds by mask": dict(lkp_cld=jc, cld_mask=jnp.asarray(mask)),
              "clouds by seed, aerosols, 3 angles": dict(lkp_cld=jc, cld_mask_seed=6, lkp_aero=jae,
                                                         n_gauss_angles=3)}
    tc, tae = convert.cloud_lookup_from_object(jc), convert.aerosol_lookup_from_object(jae)
    swap = {id(jc): tc, id(jae): tae}
    port_kw = {name: {k: torch.from_numpy(mask) if k == "cld_mask" else swap.get(id(v), v)
                      for k, v in kw.items()} for name, kw in jax_kw.items()}
    return jl, ja, jb, tl, convert.atmosphere_from_object(ja), tb, jax_kw, port_kw


@pytest.mark.parametrize("kwargs", [dict(option=o) for o in (
    "n_gauss_angles=2", "clouds by seed", "aerosols", "clouds by mask",
    "n_gauss_angles=4", "clouds by seed, aerosols, 3 angles",
)])
def test_lw_unported_options_raise(kernel_dispatch, kwargs):
    """What the kernel path of LW no-scattering once refused (more than one
    angle, clouds, aerosols) it now covers: through the kernel dispatch (the
    wrappers' twins on the CPU) it equals the torch path to rounding and the
    JAX XLA solve within the slice's tolerance; nothing raises."""
    option = kwargs["option"]
    jl, ja, jb, tl, ta, tb, jax_kw, port_kw = _noscat_allsky_case()
    out, diag = solve_lw(tl, ta, tb, **port_kw[option])
    exact, ediag = solve_lw(tl, ta, tb, impl="torch", **port_kw[option])
    ref, rdiag = jmod.solve_lw(jl, ja, jb, **jax_kw[option])
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert _rel(getattr(out, name), getattr(exact, name).numpy()) <= 2e-6, name
        assert _rel(getattr(out, name), getattr(ref, name)) <= TOL[np.float32], name
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover)
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(rdiag.cld_cover), rtol=1e-6)
        clear, _ = solve_lw(tl, ta, tb)
        assert float((clear.flux_up - out.flux_up).abs().max()) > 1e-2
    else:
        assert diag.cld_cover is None


@pytest.fixture
def cuda_routing(monkeypatch):
    """solve_* route impl=None as they do for CUDA tensors of the inputs'
    dtype; on CPU tensors the wrappers then run their plain twins."""
    from rrtmgp_tpu_torch.models import rrtmgp as tmod

    real = tmod._resolve_impl
    monkeypatch.setattr(tmod, "_resolve_impl", lambda impl, device, *args, **kwargs: real(
        impl, torch.device("cuda"), *args, **kwargs))


@pytest.mark.parametrize("kwargs", [dict(option=o) for o in ("clear", "clouds by seed", "aerosols")])
def test_sw_unported_options_raise(cuda_routing, monkeypatch, kwargs):
    """The SW direct-beam-only solve, which the default impl once refused on
    CUDA tensors (clear, with clouds, with aerosols), now runs: impl=None
    routes it to the two-kernel path (the wrappers' twins on the CPU), where
    it equals the torch path to 2e-6 and the JAX XLA solve within the
    slice's tolerance, with flux_up = flux_dn = 0 and night columns 0.
    Only the explicit megakernel impl still refuses it."""
    option = kwargs["option"]
    ncol = 24
    jl, _, jb, tl, _, tb = _sw_case(ncol, np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    rng = np.random.default_rng(23)
    cf = np.asarray(ja.cloud_state.cld_frac) * rng.uniform(0.2, 1.0, (NLAY, ncol)).astype(np.float32)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, ncol)).astype(np.float32)
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass)),
    )
    ta = convert.atmosphere_from_object(ja)
    jkw, tkw = {}, {}
    if option == "clouds by seed":
        jc = jsyn.synthetic_cloud_lookup(n_bnd=4, dtype=np.float32)
        jkw, tkw = dict(lkp_cld=jc, cld_mask_seed=6), dict(lkp_cld=convert.cloud_lookup_from_object(jc),
                                                           cld_mask_seed=6)
    elif option == "aerosols":
        jae = jsyn.synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32)
        jkw, tkw = dict(lkp_aero=jae), dict(lkp_aero=convert.aerosol_lookup_from_object(jae))
    from rrtmgp_tpu_torch.ops import interp

    calls = []
    real_optics = interp.optics_fused_ref
    monkeypatch.setattr(interp, "optics_fused_ref", lambda *a: calls.append(1) or real_optics(*a))
    out, _ = solve_sw(tl, ta, tb, two_stream=False, **tkw)
    assert calls, "impl=None did not take the two-kernel path"
    exact, _ = solve_sw(tl, ta, tb, two_stream=False, impl="torch", **tkw)
    ref, _ = jmod.solve_sw(jl, ja, jb, two_stream=False, **jkw)
    assert _rel(out.flux_dn_dir, exact.flux_dn_dir.numpy()) <= 2e-6
    assert _rel(out.flux_dn_dir, ref.flux_dn_dir) <= TOL[np.float32]
    assert float(out.flux_dn_dir.max()) > 100.0
    assert torch.all(out.flux_up == 0.0) and torch.all(out.flux_dn == 0.0)
    night = tb.cos_zenith <= 0
    assert night.any() and torch.all(out.flux_dn_dir[:, night] == 0.0)
    with pytest.raises(ValueError, match="no direct-beam route.*impl=None or 'two_kernel'"):
        solve_sw(tl, ta, tb, two_stream=False, impl="kernel", **tkw)


def test_resolve_impl_routes_by_device_and_dtype():
    """impl=None: the kernels for f32 CUDA tensors and for the f64 solve
    that has a kernel; other f64 solves on CUDA tensors take the torch path
    with a warning; impl='kernel' needs CUDA tensors and an existing
    kernel."""
    from rrtmgp_tpu_torch.models.rrtmgp import _resolve_impl

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _resolve_impl(None, cuda, torch.float32) == "kernel"
    assert _resolve_impl(None, cuda, torch.float32, mega=False) == "two_kernel"
    with pytest.warns(UserWarning, match="exact-precision torch path"):
        assert _resolve_impl(None, cuda, torch.float64) == "torch"
    assert _resolve_impl(None, cuda, torch.float64, has_f64_kernel=True) == "kernel"
    assert _resolve_impl(None, cpu, torch.float32) == "torch"
    assert _resolve_impl(None, cpu, torch.float64) == "torch"
    assert _resolve_impl("kernel", cuda, torch.float64, has_f64_kernel=True) == "kernel"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _resolve_impl("kernel", cuda, torch.float64)
    assert _resolve_impl("torch", cuda, torch.float32) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        _resolve_impl("kernel", cpu, torch.float32)
    with pytest.raises(ValueError, match="not in"):
        _resolve_impl("xla", cuda, torch.float32)


def test_torch_impl_runs_without_cuda_kernels():
    """impl=None on CPU tensors is the torch path; impl='torch' is accepted."""
    _, _, _, tl, ta, tb = _lw_case(8, np.float32)
    a, _ = solve_lw(tl, ta, tb)
    b, _ = solve_lw(tl, ta, LwBCs(sfc_emis=tb.sfc_emis), impl="torch")
    assert torch.equal(a.flux_up, b.flux_up)
    _, _, _, sl, sa, sb = _sw_case(8, np.float32)
    c, _ = solve_sw(sl, sa, SwBCs(sb.cos_zenith, sb.toa_flux, sb.sfc_alb_direct, sb.sfc_alb_diffuse),
                    impl="torch")
    assert c.flux_up.shape == (NLAY + 1, 8)
