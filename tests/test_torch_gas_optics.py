"""Port gas optics (rrtmgp_tpu_torch.ops.gas_optics) against the JAX XLA
path (rrtmgp_tpu.ops.gas_optics) on the same inputs.

Tolerance: max |port - jax| / max |jax| <= 1e-5 in f32 and 1e-10 in f64.
The two differ only in the order of a few multiplications (the port blends
the two eta nodes before scaling by col_mix; JAX scales the one-hot weights),
so the f32 gap is a few ulp.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.ops import gas_optics as jgo
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.ops import gas_optics as tgo

NCOL, NLAY = 8, 6
TOL = {np.float32: 1e-5, np.float64: 1e-10}


def _rel(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port.astype(np.float64) - ref).max() / (np.abs(ref).max() + 1e-300)


def _case(longwave, dtype, exact_nodes=False):
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=32, n_bnd=4, seed=2, dtype=dtype)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=dtype)
    if exact_nodes:
        # co2 = 0: the bands keyed (h2o, co2) sit exactly on eta = 1, where the
        # two eta node modes differ
        vmr = np.asarray(ja.vmr.vmr).copy()
        vmr[2] = 0.0
        ja = dataclasses.replace(ja, vmr=dataclasses.replace(ja.vmr, vmr=jax.numpy.asarray(vmr)))
    return jl, ja, convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("node_mode", ["continuous", "reference"])
def test_pt_eta_interp(dtype, node_mode):
    jl, ja, tl, ta = _case(True, dtype, exact_nodes=True)
    jpt = jgo.compute_pt_interp(jl, ja.p_lay, ja.t_lay)
    tpt = tgo.compute_pt_interp(tl, ta.p_lay, ta.t_lay)
    for k in ("jtemp", "jpress_base", "tropo_lower"):
        np.testing.assert_array_equal(getattr(tpt, k).numpy(), np.asarray(getattr(jpt, k)), err_msg=k)
    for k in ("ftemp", "fpress"):
        assert _rel(getattr(tpt, k), getattr(jpt, k)) <= TOL[dtype], k
    jeta = jgo.compute_eta_interp(jl, ja.vmr, jpt, node_mode=node_mode)
    teta = tgo.compute_eta_interp(tl, ta.vmr, tpt, node_mode=node_mode)
    for k in ("jeta1", "jeta2"):
        np.testing.assert_array_equal(getattr(teta, k).numpy(), np.asarray(getattr(jeta, k)), err_msg=k)
    for k in ("feta1", "feta2", "col_mix1", "col_mix2"):
        assert _rel(getattr(teta, k), getattr(jeta, k)) <= TOL[dtype], k
    # the exact-node case is really exercised: some fractions sit on a node
    f = teta.feta1.numpy()
    assert np.any(f == (1.0 if node_mode == "continuous" else 0.0))


def test_eta_node_mode_rejects_unknown():
    _, _, tl, ta = _case(True, np.float32)
    pt = tgo.compute_pt_interp(tl, ta.p_lay, ta.t_lay)
    with pytest.raises(ValueError):
        tgo.compute_eta_interp(tl, ta.vmr, pt, node_mode="nearest")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("longwave", [True, False])
def test_tau_major_minor_pfrac_rayleigh(longwave, dtype):
    jl, ja, tl, ta = _case(longwave, dtype)
    jpt = jgo.compute_pt_interp(jl, ja.p_lay, ja.t_lay)
    jeta = jgo.compute_eta_interp(jl, ja.vmr, jpt)
    tpt = tgo.compute_pt_interp(tl, ta.p_lay, ta.t_lay)
    teta = tgo.compute_eta_interp(tl, ta.vmr, tpt)
    pairs = [
        ("tau_major", tgo.compute_tau_major(tl, ta.col_dry, tpt, teta),
         jgo.compute_tau_major(jl, ja.col_dry, jpt, jeta)),
        ("tau_minor",
         tgo.compute_tau_minor(tl, ta.vmr, ta.col_dry, ta.p_lay, ta.t_lay, tpt, teta),
         jgo.compute_tau_minor(jl, ja.vmr, ja.col_dry, ja.p_lay, ja.t_lay, jpt, jeta)),
    ]
    if longwave:
        pairs.append(("pfrac", tgo.compute_planck_fraction(tl, tpt, teta),
                      jgo.compute_planck_fraction(jl, jpt, jeta)))
    else:
        pairs.append(("tau_rayleigh", tgo.compute_tau_rayleigh(tl, ta.vmr, ta.col_dry, tpt, teta),
                      jgo.compute_tau_rayleigh(jl, ja.vmr, ja.col_dry, jpt, jeta)))
    for name, port, ref in pairs:
        assert np.abs(np.asarray(ref)).max() > 0, name
        assert port.dtype == (torch.float32 if dtype == np.float32 else torch.float64), name
        assert _rel(port, ref) <= TOL[dtype], (name, _rel(port, ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_planck_sources(dtype):
    jl, ja, tl, ta = _case(True, dtype)
    rng = np.random.default_rng(1)
    pfrac = rng.uniform(0.01, 0.2, (NLAY, NCOL, 32)).astype(dtype)
    # temperatures beyond the table on both sides exercise the end clamps
    t = np.asarray(ja.t_lev).copy()
    t[0, 0], t[0, 1] = 150.0, 360.0
    ja = dataclasses.replace(ja, t_lev=jax.numpy.asarray(t))
    ta = dataclasses.replace(ta, t_lev=torch.from_numpy(t))
    js = jgo.compute_planck_sources(jl, ja, jax.numpy.asarray(pfrac))
    ts = tgo.compute_planck_sources(tl, ta, torch.from_numpy(pfrac))
    for k in ("lay_source", "lev_source", "sfc_source"):
        assert _rel(getattr(ts, k), getattr(js, k)) <= TOL[dtype], (k, _rel(getattr(ts, k), getattr(js, k)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("longwave", [True, False])
def test_gas_optics_end_to_end(longwave, dtype):
    jl, ja, tl, ta = _case(longwave, dtype)
    if longwave:
        jo, to = jgo.gas_optics_lw(jl, ja), tgo.gas_optics_lw(tl, ta)
        pairs = [("tau", to.tau, jo.tau)] + [
            (k, getattr(to.sources, k), getattr(jo.sources, k))
            for k in ("lay_source", "lev_source", "sfc_source")
        ]
    else:
        jo, to = jgo.gas_optics_sw(jl, ja), tgo.gas_optics_sw(tl, ta)
        pairs = [("tau", to.tau, jo.tau), ("ssa", to.ssa, jo.ssa)]
    for name, port, ref in pairs:
        assert _rel(port, ref) <= TOL[dtype], (name, _rel(port, ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_get_vmr_and_col_gas(dtype):
    """get_vmr's VmrGM special cases (ig 0 = none, 1 = h2o, 3 = o3, others
    global means) and the full-3D Vmr, and compute_col_gas with and without
    Helmert gravity."""
    from rrtmgp_tpu import states as jst
    from rrtmgp_tpu_torch import RRTMGPParameters, Vmr, compute_col_gas, get_vmr

    _, ja, _, ta = _case(True, dtype)
    for ig in range(9):
        np.testing.assert_array_equal(
            get_vmr(ta.vmr, ig).numpy(), np.asarray(jst.get_vmr(ja.vmr, ig)), err_msg=str(ig)
        )
    full = np.random.default_rng(2).uniform(0.0, 1e-3, (9, NLAY, NCOL)).astype(dtype)
    for ig in (0, 2, 5):
        np.testing.assert_array_equal(
            get_vmr(Vmr(vmr=torch.from_numpy(full)), ig).numpy(),
            np.asarray(jst.get_vmr(jst.Vmr(vmr=jax.numpy.asarray(full)), ig)),
        )
    lat = np.linspace(-80.0, 80.0, NCOL).astype(dtype)
    p = jst.RRTMGPParameters()
    for kw_t, kw_j in (({}, {}), ({"lat": torch.from_numpy(lat)}, {"lat": jax.numpy.asarray(lat)})):
        port = compute_col_gas(ta.p_lev, RRTMGPParameters(), ta.vmr.vmr_h2o, **kw_t)
        ref = jst.compute_col_gas(ja.p_lev, p, ja.vmr.vmr_h2o, **kw_j)
        assert _rel(port, ref) <= TOL[dtype]


def test_parameters_angles_and_band_map_match_jax():
    from rrtmgp_tpu import angular as jang, parameters as jpar
    from rrtmgp_tpu.data.lookups import band_limits_to_gpt2band as j_g2b
    from rrtmgp_tpu_torch import RRTMGPParameters, angular_discretization, band_limits_to_gpt2band

    a, b = RRTMGPParameters(), jpar.RRTMGPParameters()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.R_d, a.cp_d) == (b.R_d, b.cp_d)
    for n in (1, 2, 3, 4):
        for x, y in zip(angular_discretization(n), jang.angular_discretization(n)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        angular_discretization(5)
    lims = ((0, 3), (3, 10), (10, 12))
    np.testing.assert_array_equal(band_limits_to_gpt2band(lims, 12), j_g2b(lims, 12))
