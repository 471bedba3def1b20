"""The port's synthetic lookups and atmosphere against the JAX package's.

Same seed, same numpy RNG code: the arrays must be bitwise equal, and the
static metadata identical. The convert.py builders round-trip JAX objects.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.data import synthetic as tsyn


def _assert_lookup_equal(jlkp, tlkp):
    for k in convert.GAS_LOOKUP_ARRAYS:
        a, b = getattr(jlkp, k), getattr(tlkp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype, k
            np.testing.assert_array_equal(b.numpy(), a, err_msg=k)
    for k in convert.GAS_LOOKUP_META:
        assert getattr(tlkp, k) == getattr(jlkp, k), k
    assert tlkp.n_gpt == jlkp.n_gpt and tlkp.n_bnd == jlkp.n_bnd
    assert tlkp.is_longwave == jlkp.is_longwave


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("longwave,n_gpt,n_bnd,seed", [
    (True, 32, 4, 2), (False, 32, 4, 2), (True, 36, 4, 0), (False, 28, 14, 1),
])
def test_synthetic_lookup_bitwise(longwave, n_gpt, n_bnd, seed, dtype):
    kw = dict(longwave=longwave, n_gpt=n_gpt, n_bnd=n_bnd, seed=seed, dtype=dtype)
    _assert_lookup_equal(jsyn.synthetic_gas_lookup(**kw), tsyn.synthetic_gas_lookup(**kw))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ncol,nlay,seed", [(8, 6, 7), (100, 20, 3)])
def test_synthetic_atmosphere_bitwise(ncol, nlay, seed, dtype):
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, seed=seed, dtype=dtype)
    ta = tsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, seed=seed, dtype=dtype)
    for k in ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "col_dry"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(), np.asarray(getattr(ja, k)), err_msg=k)
    for k in ("vmr_h2o", "vmr_o3", "vmr"):
        np.testing.assert_array_equal(
            getattr(ta.vmr, k).numpy(), np.asarray(getattr(ja.vmr, k)), err_msg=k
        )
    assert ta.nlay == ja.nlay and ta.ncol == ja.ncol


@pytest.mark.parametrize("longwave", [True, False])
def test_convert_roundtrips_jax_lookup(longwave):
    jlkp = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=32, n_bnd=4, seed=5, dtype=np.float32)
    tlkp = convert.gas_lookup_from_object(jlkp)
    _assert_lookup_equal(jlkp, tlkp)
    assert tlkp.kmajor.dtype == torch.float32
    f64 = convert.gas_lookup_from_object(jlkp, dtype=torch.float64)
    assert f64.kmajor.dtype == torch.float64 and torch.equal(f64.kmajor.float(), tlkp.kmajor)


def test_convert_roundtrips_jax_state_and_bcs():
    from rrtmgp_tpu.states import LwBCs, SwBCs

    ja = jsyn.synthetic_atmosphere(ncol=16, nlay=5, dtype=np.float32)
    ta = convert.atmosphere_from_object(ja)
    ref = tsyn.synthetic_atmosphere(ncol=16, nlay=5, dtype=np.float32)
    for k in ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "col_dry"):
        assert torch.equal(getattr(ta, k), getattr(ref, k)), k
    assert torch.equal(ta.vmr.vmr, ref.vmr.vmr)

    rng = np.random.default_rng(0)
    emis = rng.uniform(0.9, 1.0, (4, 16)).astype(np.float32)
    jl = LwBCs(sfc_emis=emis)
    tl = convert.lw_bcs_from_numpy(sfc_emis=np.asarray(jl.sfc_emis))
    np.testing.assert_array_equal(tl.sfc_emis.numpy(), emis)
    assert tl.inc_flux is None
    mu0 = rng.uniform(-0.2, 1.0, 16).astype(np.float32)
    js = SwBCs(cos_zenith=mu0, toa_flux=np.full(16, 1361.0, np.float32),
               sfc_alb_direct=emis, sfc_alb_diffuse=emis)
    ts = convert.sw_bcs_from_numpy(
        **{f.name: getattr(js, f.name) for f in dataclasses.fields(js)}
    )
    np.testing.assert_array_equal(ts.cos_zenith.numpy(), mu0)
    assert ts.sfc_alb_diffuse.dtype == torch.float32


def test_state_to_moves_and_casts():
    ta = tsyn.synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float64)
    t32 = ta.to("cpu", torch.float32)
    assert t32.p_lay.dtype == torch.float32 and t32.vmr.vmr.dtype == torch.float32
    lkp = tsyn.synthetic_gas_lookup(n_gpt=8, n_bnd=2).to(dtype=torch.float32)
    assert lkp.kmajor.dtype == torch.float32 and lkp.bnd_lims_gpt == ((0, 4), (4, 8))
