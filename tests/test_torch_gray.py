"""The port's gray model (``rrtmgp_tpu_torch.models.gray``) and
``RRTMGPSolver(GrayRadiation())`` against the JAX package on the same
inputs: every gray function in f32 and f64 with both optical-thickness
parameterizations (f64 within 1e-10, f32 within 1e-5 of the largest value),
the equilibrium iteration's step count and profiles, and the JAX package's
gray oracles (exact Beer-Lambert, night columns, LW flux balance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu as jrt
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu.models import gray as jg
from rrtmgp_tpu_torch.models import gray as tg

NLAY, P0, PE = 60, 100000.0, 9000.0
TOL = {np.float32: 1e-5, np.float64: 1e-10}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
OTPS = {"schneider": (jg.GrayOpticalThicknessSchneider2004, tg.GrayOpticalThicknessSchneider2004),
        "ogorman": (jg.GrayOpticalThicknessOGorman2008, tg.GrayOpticalThicknessOGorman2008)}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.detach().cpu().numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def _states(dtype, otp="schneider", ncol=9, nlay=NLAY):
    lat = np.linspace(-90.0, 90.0, ncol)
    jotp, totp = OTPS[otp]
    ja = jg.setup_gray_as_pr_grid(nlay, jnp.asarray(lat, dtype), P0, PE, jotp(), jrt.RRTMGPParameters(), dtype=dtype)
    ta = tg.setup_gray_as_pr_grid(nlay, lat, P0, PE, totp(), rt.RRTMGPParameters(), dtype=TDT[dtype],
                                  device="cpu")
    return ja, ta


@pytest.mark.parametrize("otp", ["schneider", "ogorman"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gray_functions_match_jax(dtype, otp):
    """setup, optics, both solves each way, heating rate and profile update."""
    ja, ta = _states(dtype, otp)
    tol = TOL[dtype]
    for name in ("lat", "p_lay", "p_lev", "t_lay", "t_lev", "z_lev", "t_sfc"):
        assert _rel(getattr(ta, name), getattr(ja, name)) <= tol, name
    jp, tp = jrt.RRTMGPParameters(), rt.RRTMGPParameters()
    for a, b in zip(tg.gray_optics_lw(ta, tp), jg.gray_optics_lw(ja, jp)):
        assert _rel(a, b) <= tol
    sw_tau = jg.gray_optics_sw(ja)
    if otp == "ogorman":
        assert _rel(tg.gray_optics_sw(ta), sw_tau) <= tol
    else:
        assert torch.all(tg.gray_optics_sw(ta) == 0.0) and np.all(np.asarray(sw_tau) == 0.0)

    ncol = ta.ncol
    rng = np.random.default_rng(5)
    emis = rng.uniform(0.8, 1.0, ncol).astype(dtype)
    inc = rng.uniform(0.0, 5.0, ncol).astype(dtype)
    mu0 = rng.uniform(0.05, 1.0, ncol).astype(dtype)
    mu0[2], mu0[5] = 0.0, -0.3
    toa = np.full(ncol, 1361.0, dtype)
    alb_dir, alb_dif = (rng.uniform(0.05, 0.4, ncol).astype(dtype) for _ in range(2))
    J, T = jnp.asarray, torch.from_numpy
    for two_stream in (False, True):
        ref = jg.solve_gray_lw(ja, J(emis), jp, J(inc), two_stream=two_stream)
        port = tg.solve_gray_lw(ta, T(emis), tp, T(inc), two_stream=two_stream)
        for a, b in zip(port, ref):
            assert _rel(a, b) <= tol, ("lw", two_stream)
        ref_sw = jg.solve_gray_sw(ja, J(mu0), J(toa), J(alb_dir), J(alb_dif), two_stream=two_stream)
        port_sw = tg.solve_gray_sw(ta, T(mu0), T(toa), T(alb_dir), T(alb_dif), two_stream=two_stream)
        for a, b in zip(port_sw, ref_sw):
            if np.abs(np.asarray(b)).max() > 0:
                assert _rel(a, b) <= tol, ("sw", two_stream)
            else:
                assert torch.all(a == 0.0)
            assert torch.all(a[:, [2, 5]] == 0.0)
    up, dn, net = tg.solve_gray_lw(ta, T(emis), tp)
    jup, jdn, jnet = jg.solve_gray_lw(ja, J(emis), jp)
    hr = tg.compute_gray_heating_rate(net, ta.p_lev, tp)
    assert _rel(hr, jg.compute_gray_heating_rate(jnet, ja.p_lev, jp)) <= tol
    port = tg.update_profile_lw(ta.t_lay, ta.t_lev, dn, net, hr, 21600.0, tp)
    ref = jg.update_profile_lw(ja.t_lay, ja.t_lev, jdn, jnet, jg.compute_gray_heating_rate(jnet, ja.p_lev, jp),
                               21600.0, jp)
    for a, b in zip(port, ref):
        assert _rel(a, b) <= tol


def test_pow_fast_and_tau_functions_match_jax():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(0.01, 3.0, 50), rng.uniform(-2.0, 4.0, 50)
    assert _rel(rt.pow_fast(torch.from_numpy(x), torch.from_numpy(y)), jrt.pow_fast(jnp.asarray(x), jnp.asarray(y))) <= 1e-14
    p0, dp, p, lat = 1e5, rng.uniform(100, 2000, 20), rng.uniform(1e3, 1e5, 20), rng.uniform(-90, 90, 20)
    for otp in OTPS.values():
        for jf, tf in ((jg.gray_tau_lw, tg.gray_tau_lw), (jg.gray_tau_sw, tg.gray_tau_sw)):
            ref = np.asarray(jf(otp[0](), p0, jnp.asarray(dp), jnp.asarray(p), jnp.asarray(lat)))
            port = tf(otp[1](), p0, torch.from_numpy(dp), torch.from_numpy(p), torch.from_numpy(lat))
            assert np.abs(port.numpy() - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1e-300)
    with pytest.raises(TypeError):
        tg.gray_tau_lw(object(), p0, *(torch.from_numpy(a) for a in (dp, p, lat)))


def test_setup_defaults_to_the_card_when_there_is_one():
    ta = tg.setup_gray_as_pr_grid(4, [0.0, 10.0], P0, PE, tg.GrayOpticalThicknessSchneider2004(),
                                  rt.RRTMGPParameters())
    assert ta.t_lay.device == rt.convert.default_device()
    assert ta.t_lay.dtype == torch.float32 and ta.nlay == 4 and ta.ncol == 2


# ---------------------------------------------------------------------------
# Radiative equilibrium
# ---------------------------------------------------------------------------


def _jax_equilibrium(ja, two_stream, max_steps, tol):
    emis = jnp.ones((ja.ncol,), ja.t_lay.dtype)
    return jax.jit(lambda a: jg.gray_lw_equilibrium(a, emis, jrt.RRTMGPParameters(), two_stream=two_stream,
                                                    max_steps=max_steps, flux_grad_tol=tol))(ja)


def _port_equilibrium(ta, two_stream, max_steps, tol, block=64):
    emis = torch.ones(ta.ncol, dtype=ta.t_lay.dtype)
    return tg.gray_lw_equilibrium(ta, emis, rt.RRTMGPParameters(), two_stream=two_stream, max_steps=max_steps,
                                  flux_grad_tol=tol, block=block)


@pytest.mark.parametrize("two_stream", [False, True])
def test_equilibrium_300_steps_matches_jax(two_stream):
    """300 steps at 9 columns x 60 layers, f64: the same step count and
    profiles within 1e-10 (the 1e-5 W/m2 criterion is not met by then)."""
    ja, ta = _states(np.float64)
    jatm, jT, jerr, jn = _jax_equilibrium(ja, two_stream, 300, 1e-5)
    atm, T_ex, err, n = _port_equilibrium(ta, two_stream, 300, 1e-5)
    assert int(n) == int(jn) == 300
    assert _rel(atm.t_lev, jatm.t_lev) <= 1e-10
    assert _rel(atm.t_lay, jatm.t_lay) <= 1e-10
    assert _rel(T_ex, jT) <= 1e-10
    assert abs(float(err) - float(jerr)) <= 1e-8 * float(jerr)


def test_equilibrium_stops_at_the_same_step_as_jax():
    """A tolerance the JAX loop reaches within 300 steps: both stop at the
    same step, the port mid-block, and the state is frozen from there."""
    ja, ta = _states(np.float64)
    _, _, e150, _ = _jax_equilibrium(ja, False, 150, 1e-5)
    tol = float(e150) * (1.0 + 1e-6)
    jatm, _, jerr, jn = _jax_equilibrium(ja, False, 300, tol)
    atm, _, err, n = _port_equilibrium(ta, False, 300, tol, block=64)
    assert int(jn) < 300 and int(n) == int(jn)
    assert float(err) < tol <= float(e150) * 2
    assert _rel(atm.t_lev, jatm.t_lev) <= 1e-10


def test_block_checked_equals_step_by_step():
    """Checking the condition once per block gives the bits of checking it
    every step, whether the loop ends on max_steps or on the tolerance."""
    _, ta = _states(np.float64)
    for max_steps, tol in ((45, 1e-5), (300, None)):
        if tol is None:  # the error after 40 steps: reached mid-block
            tol = float(_port_equilibrium(ta, False, 40, 1e-5, block=1)[2]) * (1.0 + 1e-9)
        one = _port_equilibrium(ta, False, max_steps, tol, block=1)
        for block in (7, 64):
            other = _port_equilibrium(ta, False, max_steps, tol, block=block)
            assert int(other[3]) == int(one[3])
            for a, b in ((one[0].t_lay, other[0].t_lay), (one[0].t_lev, other[0].t_lev), (one[1], other[1]),
                         (one[2], other[2])):
                assert torch.equal(a, b)
    assert int(one[3]) <= 41
    with pytest.raises(ValueError):
        _port_equilibrium(ta, False, 10, 1e-5, block=0)


@pytest.mark.slow
@pytest.mark.parametrize("two_stream", [False, True])
def test_equilibrium_reaches_the_analytic_profile(two_stream):
    """The reference's gate (the JAX package's test_gray_lw_equilibrium):
    f64, 9 columns x 60 layers, the level temperatures within 0.1 K of the
    analytic equilibrium profile. ~49,000 eager steps: minutes on a CPU."""
    _, ta = _states(np.float64)
    atm, T_ex, err, n = _port_equilibrium(ta, two_stream, 58400, 1e-5, block=256)
    t_error = float((T_ex - atm.t_lev).abs().max())
    assert t_error < 0.1, (t_error, int(n), float(err))


# ---------------------------------------------------------------------------
# Oracles of the JAX package's tests/test_gray.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("two_stream", [False, True])
def test_gray_sw_exact_beer_lambert(dtype, two_stream):
    _, ta = _states(dtype, "ogorman", ncol=8)
    t = TDT[dtype]
    mu0 = torch.full((8,), np.cos(np.deg2rad(52.95)), dtype=t)
    toa = torch.full((8,), 1407.679, dtype=t)
    alb = torch.full((8,), 0.1, dtype=t)
    _, _, dn_dir, _ = tg.solve_gray_sw(ta, mu0, toa, alb, alb, two_stream=two_stream)
    exact = toa[0] * mu0[0] * torch.exp(-tg.gray_optics_sw(ta)[:, 0].sum() / mu0[0])
    assert float((dn_dir[0, 0] - exact).abs() / exact) < 1e-3


def test_gray_lw_flux_balance_f64():
    _, ta = _states(np.float64, ncol=5)
    up, dn, _ = tg.solve_gray_lw(ta, torch.ones(5, dtype=torch.float64), rt.RRTMGPParameters())
    assert float(dn[-1].abs().max()) == 0.0
    sigma_t4 = rt.RRTMGPParameters().Stefan * ta.t_sfc**4
    np.testing.assert_allclose(up[0].numpy(), sigma_t4.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# RRTMGPSolver(GrayRadiation())
# ---------------------------------------------------------------------------


def _gray_solvers(dtype, ncol=16, two_stream=False):
    lat = np.linspace(-60.0, 60.0, ncol)
    jp, tp = jrt.RRTMGPParameters(), rt.RRTMGPParameters()
    ja = jg.setup_gray_as_pr_grid(40, jnp.asarray(lat, dtype), P0, PE, jg.GrayOpticalThicknessOGorman2008(), jp,
                                  dtype=dtype)
    ta = tg.setup_gray_as_pr_grid(40, lat, P0, PE, tg.GrayOpticalThicknessOGorman2008(), tp, dtype=TDT[dtype],
                                  device="cpu")
    rng = np.random.default_rng(9)
    emis = rng.uniform(0.9, 1.0, (1, ncol)).astype(dtype)
    mu0 = rng.uniform(-0.2, 1.0, ncol).astype(dtype)
    alb = rng.uniform(0.05, 0.3, (2, 1, ncol)).astype(dtype)
    toa = np.full(ncol, 1361.0, dtype)
    J, T = jnp.asarray, torch.from_numpy
    js = jrt.RRTMGPSolver(jrt.RRTMGPGridParams(nlay=40, ncol=ncol, dtype=dtype), jrt.GrayRadiation(), jp,
                          jrt.LwBCs(sfc_emis=J(emis)),
                          jrt.SwBCs(cos_zenith=J(mu0), toa_flux=J(toa), sfc_alb_direct=J(alb[0]),
                                    sfc_alb_diffuse=J(alb[1])), ja,
                          two_stream_lw=two_stream, two_stream_sw=two_stream)
    ts = rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=40, ncol=ncol, dtype=TDT[dtype]), rt.GrayRadiation(), tp,
                         rt.LwBCs(sfc_emis=T(emis)),
                         rt.SwBCs(cos_zenith=T(mu0), toa_flux=T(toa), sfc_alb_direct=T(alb[0]),
                                  sfc_alb_diffuse=T(alb[1])), ta,
                         two_stream_lw=two_stream, two_stream_sw=two_stream)
    return js, ts


@pytest.mark.parametrize("two_stream", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solver_gray_radiation_matches_jax(dtype, two_stream):
    """The gray solver's LW and SW fluxes against the JAX package's, f64 and
    f32; auto_chunk stays None (no spectral tensors), even in f64."""
    js, ts = _gray_solvers(dtype, two_stream=two_stream)
    assert ts.auto_chunk is None and ts.lookups == rt.LookupBundle()
    js.update_lw_fluxes()
    js.update_sw_fluxes()
    lw, sw = ts.update_fluxes()
    assert lw is ts.flux_lw and sw is ts.flux_sw
    for getter in ("lw_flux_up", "lw_flux_dn", "lw_flux_net", "sw_flux_up", "sw_flux_dn", "sw_flux_net",
                   "sw_direct_flux_dn"):
        port, ref = getattr(ts, getter)(), getattr(js, getter)()
        if np.abs(np.asarray(ref)).max() == 0.0:
            assert torch.all(port == 0.0), getter
        else:
            assert _rel(port, ref) <= TOL[dtype], getter
    assert ts.optical_thickness_parameter() == tg.GrayOpticalThicknessOGorman2008()
    assert ts.temperature().shape == (40, 16)


def test_solver_gray_rejects_a_dtype_mismatch():
    _, ta = _states(np.float32, ncol=4)
    with pytest.raises(TypeError, match="setup_gray_as_pr_grid"):
        rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=4, dtype=torch.float64), rt.GrayRadiation(),
                        rt.RRTMGPParameters(), None, None, ta)
