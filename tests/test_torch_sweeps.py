"""The sweeps from materialized optics and sources of the port (LW
no-scattering g-summed and per g-point, LW two-stream g-summed, SW two-stream
per g-point) and the three paths that run them: LW two-stream on the
two-kernel path, the sweep-only route ``impl="sweep"``, and the per-g-point
entry points.

Inputs come from numpy seeds at small sizes (8-24 columns, 5-8 layers, 32
g-points in 4 bands). Each kernel's plain twin is held against the JAX
package's Pallas kernel run in interpret mode and against the JAX XLA
function on the same arrays; on the CPU a kernel wrapper runs its twin, so
``impl="two_kernel"`` and ``impl="sweep"`` are reached by patching
``_resolve_impl`` (fixture ``dispatch``).

Tolerances (the gates of tests/test_pallas_rte.py for the same kernels):
- lw_noscat_reduced vs lw_noscat_pallas_reduced and vs XLA: rtol 2e-5, atol
  1e-3; lw_2stream_reduced vs lw_2stream_pallas_reduced and vs XLA: rtol
  2e-5, atol 1e-3; sw_2stream_gpt vs sw_2stream_pallas and vs XLA: rtol 2e-4,
  atol 2e-4; lw_noscat_gpt vs lw_noscat_pallas and vs XLA: rtol 2e-5, atol
  1e-5;
- a per-g-point sweep summed over g-points vs its g-summed sibling: 1e-6 of
  the largest flux (the same values added in another order);
- solves, relative to the largest reference flux: vs the JAX XLA path 1e-5
  (TOL of tests/test_torch_solve.py); LW two-stream two-kernel vs the JAX
  two-kernel route 1e-4 (the JAX package's own gate for that route against
  its XLA path, set by its bf16 tables); the sweep route vs the JAX sweep
  route (pallas_rte=True without tables: the same XLA optics, then a Pallas
  sweep) 1e-5; vs the port's torch path 2e-6.
LW comparisons stay at <= 8 layers (thin layers cancel in the f32 Clough
factor, see tests/test_torch_solve.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu.ops import gas_optics as jgo
from rrtmgp_tpu.ops import gas_optics_pallas as jgp
from rrtmgp_tpu.ops import pallas_rte as jprte
from rrtmgp_tpu.ops import rte as jrte
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs
from rrtmgp_tpu_torch import convert, solve_lw, solve_sw
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.ops import gas_optics_kernel, mega
from rrtmgp_tpu_torch.ops import rte_kernels as rk

NLAY = 8
NGPT, NBND = 32, 4
G2B = np.arange(NGPT) // (NGPT // NBND)
TOL_XLA = 1e-5
TOL_JAX_TWO_KERNEL = 1e-4
TOL_JAX_SWEEP = 1e-5
TOL_TORCH = 2e-6
J, T = jnp.asarray, torch.from_numpy


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _g2b():
    return T(G2B.astype(np.int32))


# ---------------------------------------------------------------------------
# The four twins against the JAX Pallas kernels (interpret mode) and XLA
# ---------------------------------------------------------------------------


def _lw_inputs(ncol, nlay=6):
    rng = np.random.default_rng(11)
    f = lambda *shape, lo=0.5, hi=1.5: rng.uniform(lo, hi, shape).astype(np.float32)
    tau = np.abs(rng.normal(0.4, 0.2, (nlay, ncol, NGPT))).astype(np.float32)
    tau[0, :, :3] = 1e-7  # below the Clough threshold: the series branch
    emis_b = f(NBND, ncol, lo=0.9, hi=1.0)
    return dict(tau=tau, lay=f(nlay, ncol, NGPT), lev=f(nlay + 1, ncol, NGPT), sfc=f(ncol, NGPT),
                emis_b=emis_b, emis=np.ascontiguousarray(emis_b.T[:, G2B]), inc=f(ncol, NGPT, lo=0.0, hi=0.3))


@pytest.mark.parametrize("with_inc", [False, True])
def test_lw_noscat_reduced_ref_matches_jax_pallas_and_xla(with_inc):
    """K13's twin (band-valued emissivity through gpt2band) vs
    lw_noscat_pallas_reduced (emissivity per g-point; 12 columns in blocks
    of 8: column padding) and vs ops.rte.lw_noscat summed."""
    x = _lw_inputs(12)
    inc = x["inc"] if with_inc else None
    out = rk.lw_noscat_reduced(T(x["tau"]), T(x["lay"]), T(x["lev"]), T(x["sfc"]), T(x["emis_b"]), _g2b(),
                               1.66, 0.5, None if inc is None else T(inc))
    jargs = (J(x["tau"]), J(x["lay"]), J(x["lev"]), J(x["sfc"]), J(x["emis"]), 1.66, 0.5,
             None if inc is None else J(inc))
    pal = jprte.lw_noscat_pallas_reduced(*jargs, block_cols=8)
    xla = tuple(jnp.sum(f, -1) for f in jrte.lw_noscat(*jargs))
    for o, p, r in zip(out, pal, xla):
        assert o.shape == (7, 12)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-3)
    if not with_inc:
        assert torch.all(out[1][-1] == 0.0)
    assert rk.lw_noscat_reduced.launches == 0  # CPU tensors: the twin only


@pytest.mark.parametrize("with_inc", [False, True])
def test_lw_noscat_gpt_ref_matches_jax_pallas_and_xla(with_inc):
    """K16b's twin vs lw_noscat_pallas (16 columns in blocks of 8) and vs
    ops.rte.lw_noscat, per g-point; summed over g-points it is K13's twin
    to the sum's rounding."""
    x = _lw_inputs(16)
    inc = x["inc"] if with_inc else None
    out = rk.lw_noscat_gpt(T(x["tau"]), T(x["lay"]), T(x["lev"]), T(x["sfc"]), T(x["emis"]), 1.66, 0.5,
                           None if inc is None else T(inc))
    jargs = (J(x["tau"]), J(x["lay"]), J(x["lev"]), J(x["sfc"]), J(x["emis"]), 1.66, 0.5,
             None if inc is None else J(inc))
    pal = jprte.lw_noscat_pallas(*jargs, block_cols=8)
    xla = jrte.lw_noscat(*jargs)
    summed = rk.lw_noscat_reduced(T(x["tau"]), T(x["lay"]), T(x["lev"]), T(x["sfc"]), T(x["emis_b"]), _g2b(),
                                  1.66, 0.5, None if inc is None else T(inc))
    for o, p, r, s in zip(out, pal, xla, summed):
        assert o.shape == (7, 16, NGPT)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-5)
        assert _rel(o.sum(-1), s.numpy()) <= 1e-6
    assert rk.lw_noscat_gpt.launches == 0


def _two_stream_media(nlay, ncol, seed):
    """tau, ssa, g away from the Meador-Weaver pole, as tests/test_pallas_rte.py."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    return rng, u, u(0.01, 3.0, nlay, ncol, NGPT), u(0.0, 0.9, nlay, ncol, NGPT), u(0.0, 0.8, nlay, ncol, NGPT)


@pytest.mark.parametrize("with_inc", [False, True])
def test_lw_2stream_reduced_ref_matches_jax_pallas_and_xla(with_inc):
    """K14's twin vs lw_2stream_pallas_reduced (24 columns in blocks of 16:
    column padding) and vs ops.rte.lw_2stream summed; tau below the Toon
    threshold in a few points (zero layer sources)."""
    nlay, ncol = 6, 24
    rng, u, tau, ssa, g = _two_stream_media(nlay, ncol, 3)
    tau[1, :, :2] = 1e-8
    lev, sfc = u(5, 80, nlay + 1, ncol, NGPT), u(20, 120, ncol, NGPT)
    emis_b = u(0.9, 1.0, NBND, ncol)
    emis = np.ascontiguousarray(emis_b.T[:, G2B])
    inc = u(0.0, 30.0, ncol, NGPT) if with_inc else None
    out = rk.lw_2stream_reduced(T(tau), T(ssa), T(g), T(lev), T(sfc), T(emis_b), _g2b(),
                                None if inc is None else T(inc))
    jargs = (J(tau), J(ssa), J(g), J(lev), J(sfc), J(emis), None if inc is None else J(inc))
    pal = jprte.lw_2stream_pallas_reduced(*jargs, block_cols=16)
    xla = tuple(jnp.sum(f, -1) for f in jrte.lw_2stream(*jargs))
    for o, p, r in zip(out, pal, xla):
        assert o.shape == (nlay + 1, ncol)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-3)
    if not with_inc:
        assert torch.all(out[1][-1] == 0.0)
    assert rk.lw_2stream_reduced.launches == 0


@pytest.mark.parametrize("with_inc", [False, True])
@pytest.mark.parametrize("with_g", [True, False])
def test_sw_2stream_gpt_ref_matches_jax_pallas_and_xla(with_g, with_inc):
    """K16a's twin vs sw_2stream_pallas (16 columns in blocks of 8; its
    asymmetry is not optional, so g = None is held against zeros) and vs
    ops.rte.sw_2stream, per g-point, mu0 and albedos per g-point; summed
    over g-points it is K15's twin to the sum's rounding."""
    nlay, ncol = 7, 16
    rng, u, tau, ssa, g = _two_stream_media(nlay, ncol, 0)
    tau = np.minimum(tau, 2.0)
    mu0 = u(0.1, 1.0, ncol)
    mu0_g = np.ascontiguousarray(np.repeat(mu0[:, None], NGPT, 1))
    toa = u(100, 1400, ncol, NGPT)
    adir_b, adif_b = u(0.05, 0.4, NBND, ncol), u(0.05, 0.4, NBND, ncol)
    adir, adif = (np.ascontiguousarray(a.T[:, G2B]) for a in (adir_b, adif_b))
    inc = u(0.0, 5.0, ncol, NGPT) if with_inc else None
    tinc = None if inc is None else T(inc)
    out = rk.sw_2stream_gpt(T(tau), T(ssa), T(g) if with_g else None, T(mu0_g), T(toa), T(adir), T(adif), tinc)
    jargs = (J(tau), J(ssa), J(g if with_g else np.zeros_like(g)), J(mu0_g), J(toa), J(adir), J(adif),
             None if inc is None else J(inc))
    pal = jprte.sw_2stream_pallas(*jargs, block_cols=8)
    xla = jrte.sw_2stream(*jargs)
    summed = rk.sw_2stream_reduced(T(tau), T(ssa), T(g) if with_g else None, T(mu0), T(toa), T(adir_b), T(adif_b),
                                   _g2b(), tinc)
    for o, p, r, s in zip(out, pal, xla, summed):
        assert o.shape == (nlay + 1, ncol, NGPT)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4)
        assert _rel(o.sum(-1), s.numpy()) <= 1e-6
    assert rk.sw_2stream_gpt.launches == 0


def test_sweep_wrappers_refuse_more_than_1024_gpoints_and_are_counted():
    """The shape check every sweep wrapper makes before a launch takes any
    g-point count from 1 (more than 1024 spread a column over several
    blocks) and refuses none, with the kernels' common message, and the four
    new wrappers are among the counted ones."""
    assert rk._dims(torch.empty(2, 3, 1025), "lw_noscat_reduced") == (2, 3, 1025)
    with pytest.raises(ValueError, match=r"n_gpt=0: the kernels take 1 g-point or more"):
        rk._dims(torch.empty(2, 3, 0), "lw_noscat_reduced")
    with pytest.raises(ValueError, match="expected \\(nlay, ncol, ngpt\\)"):
        rk._dims(torch.empty(2, 3), "lw_2stream_reduced")
    assert rk._dims(torch.empty(2, 3, 1024), "sw_2stream_gpt") == (2, 3, 1024)
    counted = mega.launch_counts()
    for name in ("lw_noscat_reduced", "lw_2stream_reduced", "sw_2stream_gpt", "lw_noscat_gpt"):
        assert counted[name] == 0
        # a CUDA-only wrapper: anything but CPU or CUDA tensors raises, no silent twin
        with pytest.raises(ValueError, match="the kernel runs on CUDA"):
            getattr(rk, name)(torch.empty(2, 3, 4, device="meta"), *[None] * 7)


# ---------------------------------------------------------------------------
# The paths: LW two-stream on the two-kernel path, the sweep-only route
# ---------------------------------------------------------------------------


@pytest.fixture
def dispatch(monkeypatch):
    """dispatch(impl): solve_* take that route whatever the device (on CPU
    tensors its wrappers run their plain twins); an explicit impl="torch"
    keeps the torch path."""
    def use(impl):
        monkeypatch.setattr(tmod, "_resolve_impl", lambda asked, *a, **k: "torch" if asked == "torch" else impl)
    return use


def _lookup(longwave):
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=NGPT, n_bnd=NBND, seed=2, dtype=np.float32)
    return jl, convert.gas_lookup_from_object(jl)


def _allsky_atmosphere(ncol):
    """The synthetic cloudy atmosphere with a fractional cloud fraction and
    aerosols in the lower half (the thin top layers stay clean)."""
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    rng = np.random.default_rng(21)
    cf = np.asarray(ja.cloud_state.cld_frac) * rng.uniform(0.2, 1.0, (NLAY, ncol)).astype(np.float32)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, ncol)).astype(np.float32)
    mass[:, NLAY // 2:] = 0.0
    return dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass)),
    )


def _sky_kwargs(option):
    """(JAX kwargs, port kwargs) of a sky option."""
    jc = jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=np.float32)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=np.float32)
    jkw, tkw = {}, {}
    if "clouds" in option:
        jkw.update(lkp_cld=jc, cld_mask_seed=6)
        tkw.update(lkp_cld=convert.cloud_lookup_from_object(jc), cld_mask_seed=6)
    if "aerosols" in option:
        jkw.update(lkp_aero=jae)
        tkw.update(lkp_aero=convert.aerosol_lookup_from_object(jae))
    return jkw, tkw


def _lw_bcs(ncol, with_inc):
    rng = np.random.default_rng(3)
    emis = rng.uniform(0.9, 1.0, (NBND, ncol)).astype(np.float32)
    inc = rng.uniform(0.0, 2.0, (ncol, NGPT)).astype(np.float32) if with_inc else None
    jb = JLwBCs(sfc_emis=jnp.asarray(emis), inc_flux=None if inc is None else jnp.asarray(inc))
    return jb, convert.lw_bcs_from_numpy(sfc_emis=emis, inc_flux=inc)


def _sw_bcs(ncol):
    rng = np.random.default_rng(4)
    mu0 = rng.uniform(0.05, 1.0, ncol).astype(np.float32)
    mu0[1::4] = np.asarray([0.0, 1e-6, -0.2], np.float32)[np.arange(len(mu0[1::4])) % 3]
    bc = dict(
        cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, np.float32),
        sfc_alb_direct=rng.uniform(0.05, 0.4, (NBND, ncol)).astype(np.float32),
        sfc_alb_diffuse=rng.uniform(0.05, 0.4, (NBND, ncol)).astype(np.float32),
    )
    return JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}), convert.sw_bcs_from_numpy(**bc)


def _check_fluxes(out, refs):
    """out's flux fields against each (reference, tolerance, name)."""
    for field in out._fields:
        o = getattr(out, field)
        for ref, tol, name in refs:
            r = getattr(ref, field)
            r = r.numpy() if isinstance(r, torch.Tensor) else r
            assert _rel(o, r) <= tol, (field, name, _rel(o, r))


def test_gas_optics_lw_kernel_route_matches_jax_pallas_and_xla():
    """gas_optics_kernel.gas_optics_lw (K8 and K11's twins on the CPU, the
    sources in plain torch) vs the JAX gas_optics_pallas.gas_optics_lw at
    5e-5 and the JAX XLA gas_optics_lw at 1e-6 of the largest value; without
    need_lay_source the layer source is None and the rest is unchanged."""
    ncol, nlay = 8, 6
    jl, tl = _lookup(True)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32)
    ta = convert.atmosphere_from_object(ja)
    out = gas_optics_kernel.gas_optics_lw(tl, ta)
    pal = jgp.gas_optics_lw(jl, jgp.build_pallas_tables(jl), ja, block=8)
    xla = jgo.gas_optics_lw(jl, ja)
    pairs = lambda o, r: ((o.tau, r.tau), (o.sources.lay_source, r.sources.lay_source),
                          (o.sources.lev_source, r.sources.lev_source), (o.sources.sfc_source, r.sources.sfc_source))
    for (o, p), (_, x) in zip(pairs(out, pal), pairs(out, xla)):
        assert _rel(o, p) <= 5e-5 and _rel(o, x) <= 1e-6
    assert out.sources.lev_source.shape == (nlay + 1, ncol, NGPT) and out.sources.sfc_source.shape == (ncol, NGPT)
    lean = gas_optics_kernel.gas_optics_lw(tl, ta, need_lay_source=False)
    assert lean.sources.lay_source is None
    assert torch.equal(lean.tau, out.tau) and torch.equal(lean.sources.lev_source, out.sources.lev_source)
    assert torch.equal(lean.sources.sfc_source, out.sources.sfc_source)


@pytest.mark.parametrize("ncol,option,with_inc", [
    (24, "clear", False), (24, "clear", True), (128, "clear", False),
    (24, "clouds by seed", False), (24, "aerosols", True), (24, "clouds by seed, aerosols", False),
])
def test_solve_lw_two_stream_two_kernel_matches_jax(dispatch, ncol, option, with_inc):
    """Path A: solve_lw(two_stream=True) through the two-kernel dispatch vs
    the JAX two-kernel route (pallas_tables, pallas_rte=True, default
    pallas_windowed, so its megakernel is off and lw_2stream_pallas_reduced
    runs) at 1e-4, the JAX XLA path at 1e-5 and the port's torch path at
    2e-6."""
    dispatch("two_kernel")
    jl, tl = _lookup(True)
    ja = _allsky_atmosphere(ncol)
    ta = convert.atmosphere_from_object(ja)
    jb, tb = _lw_bcs(ncol, with_inc)
    jkw, tkw = _sky_kwargs(option)
    out, diag = solve_lw(tl, ta, tb, two_stream=True, **tkw)
    exact, ediag = solve_lw(tl, ta, tb, two_stream=True, impl="torch", **tkw)
    xla, xdiag = jmod.solve_lw(jl, ja, jb, two_stream=True, **jkw)
    pal, _ = jmod.solve_lw(jl, ja, jb, two_stream=True, pallas_tables=jgp.build_pallas_tables(jl),
                           pallas_rte=True, **jkw)
    _check_fluxes(out, ((exact, TOL_TORCH, "torch"), (xla, TOL_XLA, "xla"), (pal, TOL_JAX_TWO_KERNEL, "pallas")))
    if not with_inc:
        assert torch.all(out.flux_dn[-1] == 0.0)
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover)
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(xdiag.cld_cover), rtol=1e-6)
    else:
        assert diag.cld_cover is None


@pytest.mark.parametrize("option,kw", [
    ("clear", dict(n_gauss_angles=1)), ("clear", dict(n_gauss_angles=3)), ("clear", dict(two_stream=True)),
    ("clouds by seed, aerosols", dict(n_gauss_angles=3)), ("clouds by seed, aerosols", dict(two_stream=True)),
])
def test_solve_lw_sweep_matches_jax(dispatch, option, kw):
    """Path B, LW: solve_lw through the sweep dispatch (plain-torch optics,
    then K13's twin once per angle or K14's) vs JAX pallas_rte=True without
    tables at 1e-5, the JAX XLA path at 1e-5 and the port's torch path at
    2e-6; the incident flux is split over the angles."""
    dispatch("sweep")
    ncol = 24
    jl, tl = _lookup(True)
    ja = _allsky_atmosphere(ncol)
    ta = convert.atmosphere_from_object(ja)
    jb, tb = _lw_bcs(ncol, with_inc=kw.get("n_gauss_angles") == 3)
    jkw, tkw = _sky_kwargs(option)
    out, diag = solve_lw(tl, ta, tb, **kw, **tkw)
    exact, ediag = solve_lw(tl, ta, tb, impl="torch", **kw, **tkw)
    xla, _ = jmod.solve_lw(jl, ja, jb, **kw, **jkw)
    pal, _ = jmod.solve_lw(jl, ja, jb, pallas_rte=True, pallas_sweep_cols=8, **kw, **jkw)
    _check_fluxes(out, ((exact, TOL_TORCH, "torch"), (xla, TOL_XLA, "xla"), (pal, TOL_JAX_SWEEP, "pallas_rte")))
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover)


@pytest.mark.parametrize("option", ["clear", "clouds by seed, aerosols"])
def test_solve_sw_sweep_matches_jax(dispatch, option):
    """Path B, SW: solve_sw through the sweep dispatch vs JAX
    pallas_rte=True without tables at 1e-5, the JAX XLA path at 1e-5 and the
    port's torch path at 2e-6; night columns exactly 0; the direct-beam
    solve under "sweep" is the torch path's, bit for bit."""
    dispatch("sweep")
    ncol = 24
    jl, tl = _lookup(False)
    ja = _allsky_atmosphere(ncol)
    ta = convert.atmosphere_from_object(ja)
    jb, tb = _sw_bcs(ncol)
    jkw, tkw = _sky_kwargs(option)
    out, diag = solve_sw(tl, ta, tb, **tkw)
    exact, ediag = solve_sw(tl, ta, tb, impl="torch", **tkw)
    xla, _ = jmod.solve_sw(jl, ja, jb, **jkw)
    pal, _ = jmod.solve_sw(jl, ja, jb, pallas_rte=True, pallas_sweep_cols=8, **jkw)
    _check_fluxes(out, ((exact, TOL_TORCH, "torch"), (xla, TOL_XLA, "xla"), (pal, TOL_JAX_SWEEP, "pallas_rte")))
    night = tb.cos_zenith <= 0
    assert night.any()
    for f in out:
        assert torch.all(f[:, night] == 0.0)
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover) and torch.equal(diag.aod_sw_ext, ediag.aod_sw_ext)
    beam, _ = solve_sw(tl, ta, tb, two_stream=False, **tkw)
    beam_exact, _ = solve_sw(tl, ta, tb, two_stream=False, impl="torch", **tkw)
    assert all(torch.equal(a, b) for a, b in zip(beam, beam_exact))


@pytest.mark.parametrize("impl", ["kernel", "two_kernel", "sweep"])
def test_mixed_dtype_boundary_conditions_on_the_kernel_routes(dispatch, impl):
    """Boundary conditions in f64 with an f32 atmosphere: the kernel routes
    cast them to the state's dtype (as the JAX package casts), so the fluxes
    are f32 and equal the cast input's bit for bit, and agree with the torch
    path (which promotes where the f64 field enters) at 2e-6. LW with an incident flux, SW with
    every field in f64."""
    dispatch(impl)
    ncol = 16
    _, tl = _lookup(True)
    _, ts = _lookup(False)
    ta = convert.atmosphere_from_object(jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32))
    _, lb = _lw_bcs(ncol, with_inc=True)
    _, sb = _sw_bcs(ncol)
    f64 = lambda b: dataclasses.replace(b, **{f.name: getattr(b, f.name).double() for f in dataclasses.fields(b)
                                              if isinstance(getattr(b, f.name), torch.Tensor)})
    for solve, lkp, b in ((solve_lw, tl, lb), (solve_sw, ts, sb)):
        mixed, _ = solve(lkp, ta, f64(b))
        cast, _ = solve(lkp, ta, b)
        promoted, _ = solve(lkp, ta, f64(b), impl="torch")
        for m, c, p in zip(mixed, cast, promoted):
            assert m.dtype == torch.float32
            assert torch.equal(m, c)
            assert _rel(m, p.numpy()) <= TOL_TORCH
    ready, mask = tmod._kernel_ready(f64(lb), torch.ones(2, 3, 4, dtype=torch.bool).transpose(0, 1), torch.float32)
    assert ready.sfc_emis.dtype == torch.float32 and ready.inc_flux.dtype == torch.float32
    assert mask.dtype == torch.bool and mask.is_contiguous()
    same, _ = tmod._kernel_ready(lb, None, torch.float32)
    assert same.sfc_emis is lb.sfc_emis  # already f32 and contiguous: returned as it is


def test_sweep_and_two_kernel_need_cuda_and_f32():
    """impl="sweep" and impl="two_kernel" raise for CPU tensors and for f64
    with the documented messages; impl=None never picks "sweep"."""
    _, tl = _lookup(True)
    _, ts = _lookup(False)
    ta = convert.atmosphere_from_object(jsyn.synthetic_atmosphere(ncol=8, nlay=NLAY, dtype=np.float32))
    _, lb = _lw_bcs(8, False)
    _, sb = _sw_bcs(8)
    for impl in ("sweep", "two_kernel"):
        with pytest.raises(ValueError, match=f"impl='{impl}' runs the CUDA kernels and needs CUDA tensors"):
            solve_lw(tl, ta, lb, two_stream=True, impl=impl)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            solve_sw(ts, ta, sb, impl=impl)
    cuda, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    with pytest.raises(NotImplementedError, match="the sweep route in f64 .*ROADMAP queue 1"):
        tmod._resolve_impl("sweep", cuda, f64)
    with pytest.raises(NotImplementedError, match="the two-kernel path in f64 .*ROADMAP queue 1"):
        tmod._resolve_impl("two_kernel", cuda, f64)
    assert tmod._resolve_impl("sweep", cuda, f32) == "sweep"
    assert tmod.IMPLS == ("kernel", "two_kernel", "sweep", "torch")
    with pytest.raises(ValueError, match="not in"):
        tmod._resolve_impl("sweeps", cuda, f32)
    for mega_ok in (True, False):
        assert tmod._resolve_impl(None, cuda, f32, mega=mega_ok) in ("kernel", "two_kernel")


def test_constructors_default_to_the_card_when_there_is_one(monkeypatch):
    """The port's constructors place their tensors on ``convert.default_device()``
    when the caller names no device (the card when there is one, the CPU
    otherwise) and where the caller says when it does, so a solve runs on the
    card unless the CPU is asked for."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup

    want = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    assert convert.default_device() == want
    monkeypatch.setattr(convert, "default_device", lambda: torch.device("meta"))
    emis = np.full((4, 8), 0.98, np.float32)
    assert convert.lw_bcs_from_numpy(sfc_emis=emis).sfc_emis.device.type == "meta"
    assert convert.lw_bcs_from_numpy(sfc_emis=emis, device="cpu").sfc_emis.device.type == "cpu"
    assert synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float32).p_lay.device.type == "meta"
    assert synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float32, device="cpu").t_lev.device.type == "cpu"
    lkp = synthetic_gas_lookup(longwave=True, n_gpt=8, n_bnd=2, dtype=np.float32, device="cpu")
    assert lkp.kmajor.device.type == "cpu" and lkp.device.type == "cpu"
