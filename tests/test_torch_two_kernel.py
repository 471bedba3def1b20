"""The two-kernel path of the port (materialized gas optics, row-layout band
Planck, source-fused LW no-scattering sweep, g-summed SW two-stream sweep):
each kernel's plain twin against the JAX package's Pallas kernel run in
interpret mode, and solve_lw / solve_sw through the two-kernel dispatch
against the JAX two-kernel path and the JAX XLA path.

Inputs come from numpy seeds at small sizes (8-24 columns and once 128, 6-8
layers, 32 g-points in 4 bands). On the CPU a kernel wrapper runs its twin,
so ``impl="two_kernel"`` is reached by patching ``_resolve_impl`` (fixture
``two_kernel_dispatch``), as ``kernel_dispatch`` does for the megakernels.

Tolerances, each relative to the largest reference value unless rtol/atol:
- gas optics vs the JAX Pallas optics: 5e-5 (tests/test_pallas_optics.py:
  the JAX kernel contracts bf16 hi/lo table splits); vs the JAX XLA optics:
  1e-6 (same algorithm in f32; a few ulp of multiplication order);
- band Planck vs the JAX Pallas kernel: 1e-5 (bf16 hi/lo table);
- LW sweep vs the JAX Pallas sweep on the same optics: rtol 2e-5, atol 1e-3;
  SW sweep: rtol 2e-4, atol 1e-3 (tests/test_pallas_rte.py);
- solves vs the JAX XLA path: 1e-5 (TOL of tests/test_torch_solve.py); vs
  the JAX two-kernel path: 5e-5 LW and 1e-4 SW, the JAX package's own
  gates for that path against its XLA path (tests/test_pallas_optics.py),
  set by its bf16 tables; two-kernel vs torch path of the port: 2e-6.
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
from rrtmgp_tpu.ops import pallas_interp as jpi
from rrtmgp_tpu.ops import pallas_rte as jprte
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs
from rrtmgp_tpu_torch import convert, solve_lw, solve_sw
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.ops import interp, mega, rte_kernels
from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw_raw, gas_optics_sw
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

NLAY = 8
TOL_XLA = 1e-5
TOL_JAX_TWO_KERNEL = {"lw": 5e-5, "sw": 1e-4}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _lookup(longwave):
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    return jl, convert.gas_lookup_from_object(jl)


@pytest.fixture
def two_kernel_dispatch(monkeypatch):
    """solve_* take the two-kernel path whatever the device; on CPU tensors
    its wrappers run their plain twins."""
    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "two_kernel")


# ---------------------------------------------------------------------------
# The four twins against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("longwave", [True, False])
def test_optics_fused_ref_matches_jax_pallas_and_xla(longwave):
    """K8's twin (and the gas_optics_kernel functions around it, whose
    wrappers run the twins on the CPU) vs the JAX fused optics kernel at
    5e-5 and the JAX XLA optics at 1e-6 of the largest value."""
    ncol, nlay = 8, 6
    jl, tl = _lookup(longwave)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32)
    ta = convert.atmosphere_from_object(ja)
    tabs = jgp.build_pallas_tables(jl)
    pt = jgo.compute_pt_interp(jl, ja.p_lay, ja.t_lay)
    eta = jgo.compute_eta_interp(jl, ja.vmr, pt)
    if longwave:
        pal = jgp.gas_optics_lw_raw(jl, tabs, ja, block=8)
        pal = (pal.tau, pal.pfrac)
        xla = (jgo.gas_optics_lw(jl, ja).tau, jgo.compute_planck_fraction(jl, pt, eta))
        out = interp.optics_fused_ref(mega_lw_inputs(tl, ta), tl.kernel_tables)
        raw = gas_optics_lw_raw(tl, ta)
        via = (raw.tau, raw.pfrac)
    else:
        pal = jgp.gas_optics_sw(jl, tabs, ja, block=8)
        xla = jgo.gas_optics_sw(jl, ja)
        out = interp.optics_fused_ref(mega_sw_inputs(tl, ta), tl.kernel_tables)
        via = tuple(gas_optics_sw(tl, ta))
    for name, o, v, p, x in zip(("tau", "second"), out, via, pal, xla):
        assert o.shape == (nlay, ncol, 32)
        assert torch.equal(o, v), name
        assert _rel(o, p) <= 5e-5, (name, _rel(o, p))
        assert _rel(o, x) <= 1e-6, (name, _rel(o, x))
    assert float(out[0].min()) >= 0.0
    assert interp.optics_fused.launches == 0  # CPU tensors: the twin only


def test_planck_band_rows_ref_matches_jax_pallas():
    """K11's twin vs planck_band_pallas (its first n_bnd columns) at 1e-5
    of the largest value, temperatures outside the table included (the end
    values are returned)."""
    jl, tl = _lookup(True)
    tabs = jgp.build_pallas_tables(jl)
    n_t = int(jl.totplnk.shape[0])
    t_min, t_delta = float(jl.t_planck_min), float(jl.t_planck_delta)
    t_max = t_min + (n_t - 1) * t_delta
    rng = np.random.default_rng(5)
    t = rng.uniform(t_min - 30.0, t_max + 30.0, 300).astype(np.float32)
    t[:4] = [t_min - 50.0, t_min, t_max, t_max + 50.0]
    ref = jpi.planck_band_pallas(jnp.asarray(t), tabs.totplnk_hi, tabs.totplnk_lo,
                                 n_t=n_t, t_min=t_min, t_delta=t_delta)
    out = interp.planck_band_rows(torch.from_numpy(t), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    assert out.shape == (300, 4)
    assert _rel(out, np.asarray(ref)[:, :4]) <= 1e-5
    assert torch.equal(out[0], tl.totplnk[0]) and torch.equal(out[3], tl.totplnk[-1])
    # the bands-leading kernel's twin is the same function, transposed
    assert torch.equal(out.T, mega.planck_band(torch.from_numpy(t), tl.totplnk, tl.t_planck_min,
                                               tl.t_planck_delta))


def test_planck_band_rows_sets_equal_the_per_set_twins_and_hold_pallas():
    """The sets of a solve in one call (the CPU runs the twins): bit for bit
    the per-set twins, within 1e-5 of planck_band_pallas, and chip_smoke.py's
    grid_sample yardstick (both forms) within 1e-6 of the twin."""
    import chip_smoke

    jl, tl = _lookup(True)
    tabs = jgp.build_pallas_tables(jl)
    n_t = int(jl.totplnk.shape[0])
    t_min, t_delta = float(jl.t_planck_min), float(jl.t_planck_delta)
    t_max = t_min + (n_t - 1) * t_delta
    rng = np.random.default_rng(7)
    sets = [rng.uniform(t_min - 30.0, t_max + 30.0, n).astype(np.float32) for n in (300, 0, 41)]
    tab = (tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    outs = interp.planck_band_rows_sets([torch.from_numpy(t) for t in sets], *tab)
    for out, t in zip(outs, sets):
        tt = torch.from_numpy(t)
        want = interp.planck_band_rows_ref(tt, *tab)
        assert out.shape == (t.size, 4) and torch.equal(out, want)
        if t.size:
            ref = jpi.planck_band_pallas(jnp.asarray(t), tabs.totplnk_hi, tabs.totplnk_lo,
                                         n_t=n_t, t_min=t_min, t_delta=t_delta)
            assert _rel(out, np.asarray(ref)[:, :4]) <= 1e-5
            assert _rel(chip_smoke.grid_sample_rows(tt, *tab), want.numpy()) <= 1e-6
            assert _rel(chip_smoke.grid_sample_bands(tt, *tab).T, want.numpy()) <= 1e-6
    assert interp.planck_band_rows.launches == 0  # CPU tensors: the twin only


def _lw_sweep_inputs():
    rng = np.random.default_rng(11)
    nlay, ncol, ngpt, nbnd = 6, 12, 32, 4
    f = lambda *shape, lo=0.5, hi=1.5: rng.uniform(lo, hi, shape).astype(np.float32)
    tau = np.abs(rng.normal(0.4, 0.2, (nlay, ncol, ngpt))).astype(np.float32)
    tau[0, :, :3] = 1e-7  # below the Clough threshold: the series branch
    lims = ((0, 8), (8, 16), (16, 24), (24, 32))
    return dict(tau=tau, pfrac=f(nlay, ncol, ngpt, lo=0.01, hi=0.2), plk_lay=f(nlay, ncol, nbnd),
                plk_lev=f(nlay + 1, ncol, nbnd), plk_sfc=f(ncol, nbnd),
                emis=f(ncol, nbnd, lo=0.9, hi=1.0), inc=f(ncol, ngpt, lo=0.0, hi=0.3)), lims


@pytest.mark.parametrize("with_inc", [False, True])
def test_lw_noscat_banded_reduced_ref_matches_jax_pallas(with_inc):
    """K12's twin vs lw_noscat_banded_reduced on the same tau, Planck
    fraction and band values, rtol 2e-5 / atol 1e-3."""
    x, lims = _lw_sweep_inputs()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ref = jprte.lw_noscat_banded_reduced(
        j["tau"], j["pfrac"], j["plk_lay"], j["plk_lev"], j["plk_sfc"], j["emis"], 1.66, 0.5, lims,
        j["inc"] if with_inc else None, block_cols=8)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    g2b = torch.arange(32, dtype=torch.int32) // 8
    out = rte_kernels.lw_noscat_banded_reduced(
        t["tau"], t["pfrac"], t["plk_lay"], t["plk_lev"], t["plk_sfc"], t["emis"].T.contiguous(), g2b,
        1.66, 0.5, t["inc"] if with_inc else None)
    for o, r in zip(out, ref):
        assert o.shape == (7, 12)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-3)
    if not with_inc:
        assert torch.all(out[1][-1] == 0.0)
    assert rte_kernels.lw_noscat_banded_reduced.launches == 0


@pytest.mark.parametrize("block_cols", [16, 32])
@pytest.mark.parametrize("with_g", [True, False])
def test_sw_2stream_reduced_ref_matches_jax_pallas(with_g, block_cols):
    """K15's twin vs sw_2stream_pallas_reduced, blocked (16 columns) and
    streamed (32), with the asymmetry and without, rtol 2e-4 / atol 1e-3.
    Media stay away from the Meador-Weaver pole k * mu0 = 1, where any two
    f32 implementations differ."""
    rng = np.random.default_rng(0)
    nlay, ncol, ngpt, nbnd = 7, 40, 32, 4
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape).astype(np.float32)
    tau, ssa, g = u(0.01, 2.0, nlay, ncol, ngpt), u(0.0, 0.9, nlay, ncol, ngpt), u(0.0, 0.8, nlay, ncol, ngpt)
    mu0, toa = u(0.1, 1.0, ncol), u(100, 1400, ncol, ngpt)
    adir, adif, inc = u(0.05, 0.4, nbnd, ncol), u(0.05, 0.4, nbnd, ncol), u(0.0, 5.0, ncol, ngpt)
    g2b = np.arange(ngpt) // 8
    J = jnp.asarray
    ref = jprte.sw_2stream_pallas_reduced(
        J(tau), J(ssa), J(g) if with_g else None, J(np.repeat(mu0[:, None], ngpt, 1)), J(toa),
        J(adir.T[:, g2b]), J(adif.T[:, g2b]), J(inc), block_cols=block_cols)
    T = torch.from_numpy
    out = rte_kernels.sw_2stream_reduced(
        T(tau), T(ssa), T(g) if with_g else None, T(mu0), T(toa), T(adir), T(adif),
        T(g2b.astype(np.int32)), T(inc))
    for o, r in zip(out, ref):
        assert o.shape == (nlay + 1, ncol)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4, atol=1e-3)
    assert rte_kernels.sw_2stream_reduced.launches == 0


# ---------------------------------------------------------------------------
# The slice: solve_lw / solve_sw through the two-kernel dispatch
# ---------------------------------------------------------------------------


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
    jc = jsyn.synthetic_cloud_lookup(n_bnd=4, dtype=np.float32)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32)
    jkw, tkw = {}, {}
    if "clouds" in option:
        jkw.update(lkp_cld=jc, cld_mask_seed=6)
        tkw.update(lkp_cld=convert.cloud_lookup_from_object(jc), cld_mask_seed=6)
    if "aerosols" in option:
        jkw.update(lkp_aero=jae)
        tkw.update(lkp_aero=convert.aerosol_lookup_from_object(jae))
    return jkw, tkw


@pytest.mark.parametrize("ncol,option,angles", [
    (24, "clear", 1), (24, "clear", 2), (100, "clear", 4), (128, "clear", 2),
    (24, "clouds by seed", 1), (24, "aerosols", 2), (24, "clouds by seed, aerosols", 4),
])
def test_solve_lw_two_kernel_matches_jax(two_kernel_dispatch, ncol, option, angles):
    """LW no-scattering through the two-kernel dispatch (twins on the CPU)
    vs the JAX two-kernel path (pallas_tables, pallas_rte, default
    pallas_windowed) at 5e-5, the JAX XLA path at 1e-5, and the port's torch
    path at 2e-6; the incident flux is split over the angles."""
    jl, tl = _lookup(True)
    ja = _allsky_atmosphere(ncol)
    ta = convert.atmosphere_from_object(ja)
    rng = np.random.default_rng(3)
    emis = rng.uniform(0.9, 1.0, (4, ncol)).astype(np.float32)
    inc = rng.uniform(0.0, 2.0, (ncol, 32)).astype(np.float32) if angles == 2 else None
    jb = JLwBCs(sfc_emis=jnp.asarray(emis), inc_flux=None if inc is None else jnp.asarray(inc))
    tb = convert.lw_bcs_from_numpy(sfc_emis=emis, inc_flux=inc)
    jkw, tkw = _sky_kwargs(option)
    out, diag = solve_lw(tl, ta, tb, n_gauss_angles=angles, **tkw)
    exact, ediag = solve_lw(tl, ta, tb, n_gauss_angles=angles, impl="torch", **tkw)
    xla, xdiag = jmod.solve_lw(jl, ja, jb, n_gauss_angles=angles, **jkw)
    pal, _ = jmod.solve_lw(jl, ja, jb, n_gauss_angles=angles, pallas_tables=jgp.build_pallas_tables(jl),
                           pallas_rte=True, **jkw)
    for name in ("flux_up", "flux_dn", "flux_net"):
        o = getattr(out, name)
        assert _rel(o, getattr(exact, name).numpy()) <= 2e-6, name
        assert _rel(o, getattr(xla, name)) <= TOL_XLA, (name, _rel(o, getattr(xla, name)))
        assert _rel(o, getattr(pal, name)) <= TOL_JAX_TWO_KERNEL["lw"], (name, _rel(o, getattr(pal, name)))
    if inc is None:
        assert torch.all(out.flux_dn[-1] == 0.0)
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover)
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(xdiag.cld_cover), rtol=1e-6)
    else:
        assert diag.cld_cover is None


def _sw_bcs(ncol):
    rng = np.random.default_rng(4)
    mu0 = rng.uniform(0.05, 1.0, ncol).astype(np.float32)
    mu0[1::4] = np.asarray([0.0, 1e-6, -0.2], np.float32)[np.arange(len(mu0[1::4])) % 3]
    bc = dict(
        cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, np.float32),
        sfc_alb_direct=rng.uniform(0.05, 0.4, (4, ncol)).astype(np.float32),
        sfc_alb_diffuse=rng.uniform(0.05, 0.4, (4, ncol)).astype(np.float32),
    )
    return JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}), convert.sw_bcs_from_numpy(**bc)


@pytest.mark.parametrize("two_stream", [True, False])
@pytest.mark.parametrize("ncol,option", [
    (24, "clear"), (100, "clear"), (128, "clear"), (24, "clouds by seed, aerosols"),
])
def test_solve_sw_two_kernel_matches_jax(two_kernel_dispatch, ncol, option, two_stream):
    """SW two-stream and direct beam only through the two-kernel dispatch vs
    the JAX two-kernel path at 1e-4, the JAX XLA path at 1e-5 and the port's
    torch path at 2e-6; night columns exactly 0; the direct-beam solve has
    flux_up == flux_dn == 0; AOD and cloud cover as on the torch path."""
    jl, tl = _lookup(False)
    ja = _allsky_atmosphere(ncol)
    ta = convert.atmosphere_from_object(ja)
    jb, tb = _sw_bcs(ncol)
    jkw, tkw = _sky_kwargs(option)
    out, diag = solve_sw(tl, ta, tb, two_stream=two_stream, **tkw)
    exact, ediag = solve_sw(tl, ta, tb, two_stream=two_stream, impl="torch", **tkw)
    xla, _ = jmod.solve_sw(jl, ja, jb, two_stream=two_stream, **jkw)
    pal, _ = jmod.solve_sw(jl, ja, jb, two_stream=two_stream, pallas_tables=jgp.build_pallas_tables(jl),
                           pallas_rte=True, **jkw)
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        o = getattr(out, name)
        if not two_stream and name != "flux_dn_dir":
            assert torch.all(o == 0.0), name
            continue
        assert _rel(o, getattr(exact, name).numpy()) <= 2e-6, name
        assert _rel(o, getattr(xla, name)) <= TOL_XLA, (name, _rel(o, getattr(xla, name)))
        assert _rel(o, getattr(pal, name)) <= TOL_JAX_TWO_KERNEL["sw"], (name, _rel(o, getattr(pal, name)))
    night = tb.cos_zenith <= 0
    assert night.any()
    for f in out:
        assert torch.all(f[:, night] == 0.0)
    assert torch.all(out.flux_dn_dir[:-1] <= out.flux_dn_dir[1:])  # the beam weakens downward
    if "clouds" in option:
        assert torch.equal(diag.cld_cover, ediag.cld_cover)
        assert torch.equal(diag.aod_sw_ext, ediag.aod_sw_ext)
    else:
        assert diag.cld_cover is None and diag.aod_sw_ext is None


def test_two_kernel_needs_cuda_and_refuses_what_it_lacks(two_kernel_dispatch, monkeypatch):
    """impl="two_kernel" on CPU tensors raises like "kernel"; LW two-stream
    through it is computed (no ROADMAP item is left on this path for f32);
    f64 names the f64 item."""
    jl, tl = _lookup(True)
    ta = convert.atmosphere_from_object(jsyn.synthetic_atmosphere(ncol=8, nlay=NLAY, dtype=np.float32))
    tb = convert.lw_bcs_from_numpy(sfc_emis=np.full((4, 8), 0.98, np.float32))
    lw2, _ = solve_lw(tl, ta, tb, two_stream=True)
    assert not hasattr(tmod, "TWO_KERNEL_LW2_ITEM")
    monkeypatch.undo()  # the real routing from here on
    exact, _ = solve_lw(tl, ta, tb, two_stream=True, impl="torch")
    assert _rel(lw2.flux_net, exact.flux_net.numpy()) <= 2e-6
    with pytest.raises(ValueError, match="CUDA"):
        solve_lw(tl, ta, tb, impl="two_kernel")
    jls, tls = _lookup(False)
    _, sb = _sw_bcs(8)
    with pytest.raises(ValueError, match="CUDA"):
        solve_sw(tls, ta, sb, impl="two_kernel", two_stream=False)
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmod._resolve_impl("two_kernel", cuda, torch.float64)
    assert tmod._resolve_impl("two_kernel", cuda, torch.float32) == "two_kernel"


def test_impl_none_routes_like_the_jax_package():
    """impl=None on f32 CUDA tensors: the megakernels where they cover the
    solve, the two-kernel path otherwise (several LW angles, the SW
    direct-beam solve); never a branch that raises."""
    cuda, f32, f64 = torch.device("cuda"), torch.float32, torch.float64
    assert tmod._resolve_impl(None, cuda, f32, mega=True) == "kernel"
    assert tmod._resolve_impl(None, cuda, f32, mega=False) == "two_kernel"
    assert tmod._resolve_impl(None, cuda, f32, True, False) == "two_kernel"
    # f64: the per-angle f64 kernel where there is one, else the torch path
    assert tmod._resolve_impl(None, cuda, f64, True, False) == "kernel"
    with pytest.warns(UserWarning, match="exact-precision torch path"):
        assert tmod._resolve_impl(None, cuda, f64, False, False) == "torch"
    assert tmod._resolve_impl(None, torch.device("cpu"), f32, mega=False) == "torch"
    assert tmod._resolve_impl("kernel", cuda, f32, mega=False) == "kernel"
