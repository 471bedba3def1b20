"""Port RTE solvers (rrtmgp_tpu_torch.ops.rte) against rrtmgp_tpu.ops.rte on
the same random inputs.

The port runs the recurrences layer by layer in the same arithmetic order as
the JAX scans; the direct beam sums optical depth in a loop where JAX uses a
cumulative sum. Tolerance: max |port - jax| / max |jax| <= 1e-5 in f32 and
1e-10 in f64. (Below tau ~ 1e-6 the Clough factor (1-exp(-x))/x - exp(-x)
cancels catastrophically in both packages, and XLA's and torch's exp differ
in the last ulp, so the thin-layer case uses tau = 1e-5.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.ops import rte as jrte
from rrtmgp_tpu_torch.ops import rte as trte

NLAY, NCOL, NGPT = 7, 5, 6
TOL = {np.float32: 1e-5, np.float64: 1e-10}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape
    assert np.all(np.isfinite(port)) and np.all(np.isfinite(ref))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_inc", [False, True])
@pytest.mark.parametrize("Ds,w", [(1.0 / 0.6096748751, 1.0), (1.0 / 0.2509907356, 0.2300253764)])
def test_lw_noscat(dtype, with_inc, Ds, w):
    rng = np.random.default_rng(11)
    b = (NCOL, NGPT)
    tau = rng.uniform(0.0, 3.0, (NLAY, *b)).astype(dtype)
    tau[0, 0, 0] = 0.0       # transparent layer: Taylor branch
    tau[1, 0, 1] = 1e-5
    lay = rng.uniform(1.0, 50.0, (NLAY, *b)).astype(dtype)
    lev = rng.uniform(1.0, 50.0, (NLAY + 1, *b)).astype(dtype)
    sfc = rng.uniform(10.0, 60.0, b).astype(dtype)
    emis = rng.uniform(0.8, 1.0, b).astype(dtype)
    inc = rng.uniform(0.0, 5.0, b).astype(dtype)
    j, t = _both(tau, lay, lev, sfc, emis, inc)
    ju, jd = jrte.lw_noscat(*j[:5], Ds, w, j[5] if with_inc else None)
    tu, td = trte.lw_noscat(*t[:5], Ds, w, t[5] if with_inc else None)
    assert _rel(tu, ju) <= TOL[dtype]
    assert _rel(td, jd) <= TOL[dtype]
    if not with_inc:
        assert torch.all(td[-1] == 0.0)


def _sw_inputs(dtype, mu0_values):
    rng = np.random.default_rng(5)
    b = (NCOL, NGPT)
    tau = rng.uniform(0.0, 2.0, (NLAY, *b)).astype(dtype)
    ssa = rng.uniform(0.0, 1.0, (NLAY, *b)).astype(dtype)
    g = rng.uniform(0.0, 0.9, (NLAY, *b)).astype(dtype)
    mu0 = np.broadcast_to(np.asarray(mu0_values, dtype)[:, None], b).copy()
    toa = rng.uniform(1.0, 100.0, b).astype(dtype)
    adir = rng.uniform(0.0, 0.5, b).astype(dtype)
    adif = rng.uniform(0.0, 0.5, b).astype(dtype)
    inc = rng.uniform(0.0, 3.0, b).astype(dtype)
    return tau, ssa, g, mu0, toa, adir, adif, inc


MU0 = [0.6, 0.0, 1e-6, -0.2, 1.0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sw_2stream_coeffs(dtype):
    tau, ssa, g, mu0, *_ = _sw_inputs(dtype, MU0)
    j, t = _both(tau, ssa, g, mu0[None].repeat(NLAY, 0))
    names = ("Rdir", "Tdir", "T0", "Rdif", "Tdif")
    for name, a, b in zip(names, trte.sw_2stream_coeffs(*t), jrte.sw_2stream_coeffs(*j)):
        assert _rel(a, b) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_inc", [False, True])
@pytest.mark.parametrize("clear_sky_g", [False, True])
def test_sw_2stream(dtype, with_inc, clear_sky_g):
    tau, ssa, g, mu0, toa, adir, adif, inc = _sw_inputs(dtype, MU0)
    if clear_sky_g:
        g = np.zeros_like(g)
    j, t = _both(tau, ssa, g, mu0, toa, adir, adif, inc)
    jout = jrte.sw_2stream(*j[:7], j[7] if with_inc else None)
    # the port takes g = 0.0 as a scalar for clear sky
    t_g = 0.0 if clear_sky_g else t[2]
    tout = trte.sw_2stream(t[0], t[1], t_g, *t[3:7], t[7] if with_inc else None)
    for name, a, b in zip(("flux_up", "flux_dn", "flux_dn_dir"), tout, jout):
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))
    # direct beam never increases downward for day columns
    day = mu0[:, 0] > 0
    d = tout[2].numpy()[:, day]
    assert np.all(np.diff(d, axis=0) >= 0.0)


def _lw2_inputs(dtype):
    rng = np.random.default_rng(13)
    b = (NCOL, NGPT)
    tau = rng.uniform(0.0, 3.0, (NLAY, *b)).astype(dtype)
    tau[0, 0, 0] = 0.0       # below tau_thresh: no layer source
    tau[1, 0, 1] = 1e-5
    ssa = rng.uniform(0.0, 0.9, (NLAY, *b)).astype(dtype)
    g = rng.uniform(0.0, 0.9, (NLAY, *b)).astype(dtype)
    lev = rng.uniform(1.0, 50.0, (NLAY + 1, *b)).astype(dtype)
    sfc = rng.uniform(10.0, 60.0, b).astype(dtype)
    emis = rng.uniform(0.8, 0.99, b).astype(dtype)  # != 1: the surface reflects
    inc = rng.uniform(0.0, 5.0, b).astype(dtype)
    return tau, ssa, g, lev, sfc, emis, inc


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_inc", [False, True])
def test_lw_2stream(dtype, with_inc):
    arrays = _lw2_inputs(dtype)
    j, t = _both(*arrays)
    ju, jd = jrte.lw_2stream(*j[:6], j[6] if with_inc else None)
    tu, td = trte.lw_2stream(*t[:6], t[6] if with_inc else None)
    assert _rel(tu, ju) <= TOL[dtype]
    assert _rel(td, jd) <= TOL[dtype]
    if with_inc:
        assert torch.equal(td[-1], t[6])
    else:
        assert torch.all(td[-1] == 0.0)


def test_lw_2stream_matches_scalar_oracle():
    """f64 against the scalar loops of tests/test_oracle.py, one column of
    the batch at a time (the oracle takes (nlay, nb))."""
    from test_oracle import oracle_lw_2stream

    tau, ssa, g, lev, sfc, emis, inc = _lw2_inputs(np.float64)
    flat = lambda x: x.reshape(x.shape[0], -1) if x.ndim == 3 else x.reshape(-1)
    tu, td = trte.lw_2stream(*(torch.from_numpy(x) for x in (tau, ssa, g, lev, sfc, emis, inc)))
    ou, od = oracle_lw_2stream(*(flat(x) for x in (tau, ssa, g, lev, sfc, emis, inc)))
    np.testing.assert_allclose(flat(tu.numpy()), ou, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(flat(td.numpy()), od, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sw_noscat(dtype):
    """Direct beam only, mu0 in {0.6, 0, tiny, negative, 1}."""
    tau, _, _, mu0, toa, *_ = _sw_inputs(dtype, MU0)
    j, t = _both(tau, mu0, toa)
    jd = jrte.sw_noscat(*j)
    td = trte.sw_noscat(*t)
    assert _rel(td, jd) <= TOL[dtype]
    assert torch.equal(td[-1], t[2] * t[1])
    day = mu0[:, 0] > 0
    assert np.all(np.diff(td.numpy()[:, day], axis=0) >= 0.0)
