"""The all-sky slice on the torch path: port solve_lw / solve_sw with clouds
and aerosols against the JAX solve_lw / solve_sw on the XLA path, on the
same inputs.

LW no-scattering and two-stream, SW two-stream and direct beam only; clouds
from a given mask or from a McICA seed (with and without col_offset: the
port draws the JAX package's off-TPU threefry stream), aerosols with all or
some species. Tolerance: max |port - jax| / max |jax| <= 1e-4 (the JAX
megakernel-vs-XLA tolerance; the two paths run the same algorithm, so the
measured gap is ~1e-6), diagnostics (cloud cover, AOD) at rtol 1e-6, 8
layers (see tests/test_torch_solve.py for why LW comparisons stay thin).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica as j_mask
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs
from rrtmgp_tpu_torch import LwBCs, SwBCs, convert, solve_lw, solve_sw

NCOL, NLAY, NBND = 20, 8, 4
TOL = 1e-4


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _case(longwave, dtype=np.float32):
    """JAX and port lookups and atmosphere, fractional cloud fraction."""
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=32, n_bnd=NBND, seed=2, dtype=dtype)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=dtype, with_clouds=True,
                                   with_aerosols=True)
    cf = np.asarray(ja.cloud_state.cld_frac) * np.random.default_rng(31).uniform(
        0.2, 1.0, (NLAY, NCOL)).astype(dtype)
    rng = np.random.default_rng(32)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL)).astype(dtype)
    mass[rng.random(mass.shape) < 0.3] = 0.0
    mass[:, :, ::7] = 0.0  # aerosol-free columns
    mass[:, NLAY // 2:] = 0.0  # the thin top layers stay clean (see test_torch_solve.py)
    size = rng.uniform(0.05, 12.0, (15, NLAY, NCOL)).astype(dtype)
    # aerosols in the lower layers: the synthetic atmosphere has them below
    # 800 hPa only, which 8 layers do not reach
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass),
                                          aero_size=jnp.asarray(size)),
    )
    jc = jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=dtype)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=dtype)
    port = (convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja),
            convert.cloud_lookup_from_object(jc), convert.aerosol_lookup_from_object(jae))
    return (jl, ja, jc, jae), port


CLOUDS = {
    "mask": dict(mask=True),
    "seed": dict(cld_mask_seed=4),
    "seed+offset": dict(cld_mask_seed=4, col_offset=300),
    "none": dict(),
}


def _kwargs(clouds, aero, jc, jae, tc, tae, n_gpt, cf):
    """(jax kwargs, port kwargs) of one combination."""
    jk, tk = {}, {}
    spec = dict(CLOUDS[clouds])
    if spec.pop("mask", False):
        m = np.array(j_mask(jax.random.key(2), jnp.asarray(cf), n_gpt, col_offset=0))
        jk.update(lkp_cld=jc, cld_mask=jnp.asarray(m))
        tk.update(lkp_cld=tc, cld_mask=torch.from_numpy(m))
    elif spec:
        jk.update(lkp_cld=jc, **spec)
        tk.update(lkp_cld=tc, **spec)
    if aero:
        species = None if aero == "all" else (0, 2, 4)
        jk.update(lkp_aero=jae, aero_species=species)
        tk.update(lkp_aero=tae, aero_species=species)
    return jk, tk


@pytest.mark.parametrize("two_stream", [True, False])
@pytest.mark.parametrize("clouds,aero", [("mask", None), ("seed", "all"), ("seed+offset", "some"),
                                          ("none", "all")])
def test_solve_lw_allsky_matches_jax(two_stream, clouds, aero):
    (jl, ja, jc, jae), (tl, ta, tc, tae) = _case(True)
    emis = np.random.default_rng(3).uniform(0.85, 1.0, (NBND, NCOL)).astype(np.float32)
    jk, tk = _kwargs(clouds, aero, jc, jae, tc, tae, jl.n_gpt, np.asarray(ja.cloud_state.cld_frac))
    ref, dref = jmod.solve_lw(jl, ja, JLwBCs(sfc_emis=jnp.asarray(emis)), two_stream=two_stream, **jk)
    port, diag = solve_lw(tl, ta, LwBCs(sfc_emis=torch.from_numpy(emis)), two_stream=two_stream, **tk)
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert _rel(getattr(port, name), getattr(ref, name)) <= TOL, name
    assert torch.all(port.flux_dn[-1] == 0.0)
    if clouds == "none":
        assert diag.cld_cover is None and dref.cld_cover is None
    else:
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(dref.cld_cover), rtol=1e-6)


@pytest.mark.parametrize("two_stream", [True, False])
@pytest.mark.parametrize("clouds,aero", [("mask", "all"), ("seed+offset", "some"), ("none", "all")])
def test_solve_sw_allsky_matches_jax(two_stream, clouds, aero):
    (jl, ja, jc, jae), (tl, ta, tc, tae) = _case(False)
    rng = np.random.default_rng(4)
    mu0 = rng.uniform(0.05, 1.0, NCOL).astype(np.float32)
    mu0[1::4] = np.asarray([0.0, 1e-6, -0.2], np.float32)[np.arange(len(mu0[1::4])) % 3]
    bc = dict(cos_zenith=mu0, toa_flux=np.full(NCOL, 1361.0, np.float32),
              sfc_alb_direct=rng.uniform(0.05, 0.4, (NBND, NCOL)).astype(np.float32),
              sfc_alb_diffuse=rng.uniform(0.05, 0.4, (NBND, NCOL)).astype(np.float32))
    jk, tk = _kwargs(clouds, aero, jc, jae, tc, tae, jl.n_gpt, np.asarray(ja.cloud_state.cld_frac))
    ref, dref = jmod.solve_sw(jl, ja, JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}),
                              two_stream=two_stream, **jk)
    port, diag = solve_sw(tl, ta, SwBCs(**{k: torch.from_numpy(v) for k, v in bc.items()}),
                          two_stream=two_stream, **tk)
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        if np.abs(np.asarray(getattr(ref, name))).max() == 0.0:  # direct beam only: up, dn diffuse = 0
            assert torch.all(getattr(port, name) == 0.0), name
        else:
            assert _rel(getattr(port, name), getattr(ref, name)) <= TOL, name
    for f in port:
        assert torch.all(f[:, torch.from_numpy(mu0 <= 0)] == 0.0)
    for name in ("aod_sw_ext", "aod_sw_sca"):
        np.testing.assert_allclose(getattr(diag, name).numpy(), np.asarray(getattr(dref, name)), rtol=1e-6)
    if clouds != "none":
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(dref.cld_cover), rtol=1e-6)


def test_allsky_f64_and_metric_scaling():
    """f64 all-sky LW two-stream against JAX at 1e-10, and metric scaling 2
    doubling every flux exactly."""
    (jl, ja, jc, jae), (tl, ta, tc, tae) = _case(True, np.float64)
    emis = np.full((NBND, NCOL), 0.97)
    kw = dict(two_stream=True, cld_mask_seed=6, col_offset=9)
    ref, _ = jmod.solve_lw(jl, ja, JLwBCs(sfc_emis=jnp.asarray(emis)), lkp_cld=jc, lkp_aero=jae, **kw)
    bcs = LwBCs(sfc_emis=torch.from_numpy(emis))
    port, _ = solve_lw(tl, ta, bcs, lkp_cld=tc, lkp_aero=tae, **kw)
    assert port.flux_up.dtype == torch.float64
    assert _rel(port.flux_up, ref.flux_up) <= 1e-10
    scaled, _ = solve_lw(tl, ta, bcs, lkp_cld=tc, lkp_aero=tae,
                         metric_scaling=torch.full((NLAY + 1, NCOL), 2.0, dtype=torch.float64), **kw)
    for a, b in zip(scaled, port):
        assert torch.equal(a, 2.0 * b)


def test_clouds_need_a_mask_or_a_seed():
    """Without a mask or a seed the cloud lookup has nothing to compose
    (the JAX package's XLA path fails there too); both paths say so."""
    _, (tl, ta, tc, _) = _case(True)
    with pytest.raises(ValueError, match="cld_mask or cld_mask_seed"):
        solve_lw(tl, ta, LwBCs(sfc_emis=torch.full((NBND, NCOL), 0.98)), two_stream=True, lkp_cld=tc)
