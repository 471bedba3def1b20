"""Cloud and aerosol optics of the port (rrtmgp_tpu_torch.ops.cloud_optics,
ops.aerosol_optics, states.compute_relative_humidity) against the JAX
package on the same numpy-seeded inputs, and against the scalar oracles of
tests/test_oracle_cloud_aero.py.

Tolerances: max |port - jax| / max |jax| <= 1e-6 in f32 and 1e-12 in f64 (the
JAX package contracts one-hot interpolation weights where the port gathers,
so values agree to an ulp or so); the f64 oracles at rtol 1e-12. The
synthetic cloud / aerosol tables and atmosphere are bitwise equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.ops import aerosol_optics as jaero
from rrtmgp_tpu.ops import cloud_optics as jcld
from rrtmgp_tpu.parameters import RRTMGPParameters as JParams
from rrtmgp_tpu.states import AerosolState as JAerosolState
from rrtmgp_tpu.states import CloudState as JCloudState
from rrtmgp_tpu.states import compute_relative_humidity as j_rh
from rrtmgp_tpu_torch import AerosolState, CloudState, RRTMGPParameters, compute_relative_humidity, convert
from rrtmgp_tpu_torch.data import synthetic as tsyn
from rrtmgp_tpu_torch.ops import aerosol_optics as taero
from rrtmgp_tpu_torch.ops import cloud_optics as tcld

NLAY, NCOL, NBND = 6, 7, 3
TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _cloud_inputs(dtype):
    """Cloud state with radii beyond both ends of the tables and empty cells."""
    rng = np.random.default_rng(21)
    shape = (NLAY, NCOL)
    liq = rng.random(shape) < 0.6
    ice = rng.random(shape) < 0.6
    return dict(
        cld_r_eff_liq=np.where(liq, rng.uniform(1.0, 25.0, shape), 0.0).astype(dtype),
        cld_r_eff_ice=np.where(ice, rng.uniform(5.0, 100.0, shape), 0.0).astype(dtype),
        cld_path_liq=np.where(liq, rng.uniform(5.0, 80.0, shape), 0.0).astype(dtype),
        cld_path_ice=np.where(ice, rng.uniform(5.0, 100.0, shape), 0.0).astype(dtype),
        cld_frac=rng.uniform(0.0, 1.0, shape).astype(dtype),
    )


def _aerosol_inputs(dtype):
    """Masses with zeros, sizes outside every bin, RH beyond both ends."""
    rng = np.random.default_rng(22)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL))
    mass[rng.random(mass.shape) < 0.3] = 0.0
    size = rng.uniform(0.05, 12.0, (15, NLAY, NCOL))
    rh = rng.uniform(-0.1, 1.2, (NLAY, NCOL))
    return mass.astype(dtype), size.astype(dtype), rh.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ice_rgh", [1, 3])
def test_cloud_optics_bands(dtype, ice_rgh):
    fields = _cloud_inputs(dtype)
    jl = jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=dtype)
    ref = jcld.cloud_optics_bands(jl, JCloudState(**{k: jnp.asarray(v) for k, v in fields.items()},
                                                  ice_rgh=ice_rgh))
    port = tcld.cloud_optics_bands(
        convert.cloud_lookup_from_object(jl),
        CloudState(**{k: torch.from_numpy(v) for k, v in fields.items()}, ice_rgh=ice_rgh),
    )
    for name, a, b in zip(("tau", "ssa", "g"), port, ref):
        assert a.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_delta_scale_and_increment_2stream(dtype):
    rng = np.random.default_rng(23)
    x = [rng.uniform(lo, hi, (NLAY, NCOL, 4)).astype(dtype)
         for lo, hi in ((0.0, 3.0), (0.0, 1.0), (0.0, 0.95), (0.0, 2.0), (0.0, 1.0), (0.0, 0.9))]
    x[0][0, 0] = 0.0  # zero optical depth: the eps guards
    x[1][1, 1] = 0.0
    j = [jnp.asarray(a) for a in x]
    t = [torch.from_numpy(a) for a in x]
    for a, b in zip(tcld.delta_scale(*t[:3]), jcld.delta_scale(*j[:3])):
        assert _rel(a, b) <= TOL[dtype]
    for a, b in zip(tcld.increment_2stream(*t), jcld.increment_2stream(*j)):
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("species", [None, (0, 1, 2, 4), (3, 5, 6, 9, 14)])
def test_aerosol_optics_bands(dtype, species):
    mass, size, rh = _aerosol_inputs(dtype)
    jl = jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=dtype)
    ref = jaero.aerosol_optics_bands(
        jl, JAerosolState(aero_size=jnp.asarray(size), aero_mass=jnp.asarray(mass)), jnp.asarray(rh),
        species,
    )
    port = taero.aerosol_optics_bands(
        convert.aerosol_lookup_from_object(jl),
        AerosolState(aero_size=torch.from_numpy(size), aero_mass=torch.from_numpy(mass)),
        torch.from_numpy(rh), species,
    )
    for name, a, b in zip(("tau", "tau_ssa", "tau_ssa_g"), port, ref):
        assert _rel(a, b) <= TOL[dtype], (name, _rel(a, b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cloud_and_aerosol_optics_band_every_band(dtype):
    """cloud_optics_band / aerosol_optics_band against the JAX package's
    one-band functions (gathers both), for every band."""
    fields = _cloud_inputs(dtype)
    jl = jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=dtype)
    js = JCloudState(**{k: jnp.asarray(v) for k, v in fields.items()}, ice_rgh=2)
    tl = convert.cloud_lookup_from_object(jl)
    ts = CloudState(**{k: torch.from_numpy(v) for k, v in fields.items()}, ice_rgh=2)
    mass, size, rh = _aerosol_inputs(dtype)
    ja = jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=dtype)
    jst = JAerosolState(aero_size=jnp.asarray(size), aero_mass=jnp.asarray(mass))
    ta = convert.aerosol_lookup_from_object(ja)
    tst = AerosolState(aero_size=torch.from_numpy(size), aero_mass=torch.from_numpy(mass))
    for ibnd in range(NBND):
        for a, b in zip(tcld.cloud_optics_band(tl, ts, ibnd), jcld.cloud_optics_band(jl, js, ibnd)):
            assert a.shape == (NLAY, NCOL)
            assert _rel(a, b) <= TOL[dtype], ("cloud", ibnd, _rel(a, b))
        for a, b in zip(taero.aerosol_optics_band(ta, tst, torch.from_numpy(rh), ibnd),
                        jaero.aerosol_optics_band(ja, jst, jnp.asarray(rh), ibnd)):
            assert a.shape == (NLAY, NCOL)
            assert _rel(a, b) <= TOL[dtype], ("aerosol", ibnd, _rel(a, b))


def test_aerosol_species_constants_match():
    for name in ("DUST_IDXS", "SALT_IDXS", "SULFATE_IDX", "BC_RH_IDX", "BC_IDX", "OC_RH_IDX", "OC_IDX"):
        assert tuple(np.atleast_1d(getattr(taero, name))) == tuple(np.atleast_1d(getattr(jaero, name)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compute_relative_humidity(dtype):
    rng = np.random.default_rng(24)
    p = rng.uniform(100.0, 1.0e5, (NLAY, NCOL)).astype(dtype)
    t = rng.uniform(190.0, 310.0, (NLAY, NCOL)).astype(dtype)
    q = rng.uniform(0.0, 0.02, (NLAY, NCOL)).astype(dtype)
    q[0, 0] = 0.0  # below q_lay_min
    ref = j_rh(jnp.asarray(p), jnp.asarray(t), jnp.asarray(q), JParams())
    port = compute_relative_humidity(*(torch.from_numpy(a) for a in (p, t, q)), RRTMGPParameters())
    assert _rel(port, ref) <= TOL[dtype]


def test_cloud_and_aerosol_optics_match_scalar_oracles():
    """f64 against the explicit loops of tests/test_oracle_cloud_aero.py."""
    from test_oracle_cloud_aero import oracle_aerosol_optics, oracle_cloud_optics

    fields = _cloud_inputs(np.float64)
    tl = tsyn.synthetic_cloud_lookup(n_bnd=NBND)
    cs = CloudState(**{k: torch.from_numpy(v) for k, v in fields.items()}, ice_rgh=2)
    for a, b in zip(tcld.cloud_optics_bands(tl, cs), oracle_cloud_optics(tl, cs)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-300)
    mass, size, rh = _aerosol_inputs(np.float64)
    al = tsyn.synthetic_aerosol_lookup(n_bnd=NBND)
    ae = AerosolState(aero_size=torch.from_numpy(size), aero_mass=torch.from_numpy(mass))
    for a, b in zip(taero.aerosol_optics_bands(al, ae, torch.from_numpy(rh)), oracle_aerosol_optics(al, ae, rh)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-300)


def _assert_fields_equal(port, ref):
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(a, torch.Tensor):
            assert np.array_equal(a.numpy(), np.asarray(b)), f.name
            assert a.numpy().dtype == np.asarray(b).dtype, f.name
        elif dataclasses.is_dataclass(a):
            _assert_fields_equal(a, b)
        elif a is not None and not hasattr(a, "vmr"):
            assert a == b, f.name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_cloud_and_aerosol_tables_are_bitwise_equal(dtype):
    for kw in (dict(n_bnd=16), dict(n_bnd=14, seed=5)):
        _assert_fields_equal(tsyn.synthetic_cloud_lookup(dtype=dtype, **kw),
                             jsyn.synthetic_cloud_lookup(dtype=dtype, **kw))
    for kw in (dict(n_bnd=16), dict(n_bnd=14, seed=6)):
        _assert_fields_equal(tsyn.synthetic_aerosol_lookup(dtype=dtype, **kw),
                             jsyn.synthetic_aerosol_lookup(dtype=dtype, **kw))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_synthetic_allsky_atmosphere_is_bitwise_equal(dtype):
    kw = dict(ncol=9, nlay=20, dtype=dtype, with_clouds=True, with_aerosols=True)
    port, ref = tsyn.synthetic_atmosphere(**kw), jsyn.synthetic_atmosphere(**kw)
    _assert_fields_equal(port, ref)
    assert port.cloud_state.ice_rgh == ref.cloud_state.ice_rgh == 2
    # convert.py carries the JAX state across unchanged
    _assert_fields_equal(convert.atmosphere_from_object(ref), ref)
    moved = port.to(dtype=torch.float32)
    assert moved.cloud_state.cld_frac.dtype == moved.aerosol_state.aero_mass.dtype == torch.float32
