"""The f64 slice of the port against the JAX package's exact f64 path on the
CPU, and the column chunking that lets an f64 solver run at any width.

- lw_clear_mega_ref in f64 (the twin of the f64 build of the LW
  no-scattering kernel) and f64 solve_lw with 1-3 angles, through the kernel
  path's wrappers (twins on CPU tensors), against the JAX XLA f64 solve at
  max |port - jax| / max |jax| <= 1e-10 (the same operations, up to an ulp of
  exp and the order of the g-point sums), and against the JAX double-f32
  kernel solve_lw_df64 in interpret mode, as tests/test_df64_solve.py runs
  it, at 1e-4 W/m2 absolute (the reference's f64 LW tolerance);
- sw_clear_mega_ref in f64 (the twin of the f64 build of the SW
  two-stream kernel) and f64 solve_sw through the kernel path's wrappers,
  against the JAX XLA f64 solve_sw at the same 1e-10, night columns
  included;
- a g-point count that is not a power of two (36) in f64, with an incident
  flux (LW) or an incident diffuse flux (SW);
- which f64 solves take their kernel with impl=None on CUDA tensors;
- tree_map_columns / slice_columns, with the VmrGM exclusion;
- solve_chunked against the unchunked solve, bit for bit, clear / with a
  given mask / in seed mode, the chunk dividing ncol or not, on the torch
  path and on the kernel path's twins; and against the JAX solve_chunked;
- RRTMGPSolver in f64 under a tiny $RRTMGP_CHUNK_BUDGET_GB: it warns, sets
  auto_chunk to the JAX package's value, equals its own unchunked fluxes
  bit for bit and the JAX solver with f64_kernel=False at 1e-10 — with
  aerosols under clear sky too, which the JAX df64 routing would drop.
"""

import dataclasses
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu as jrt
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu_torch import convert, solve_lw, solve_sw
from rrtmgp_tpu_torch.angular import angular_discretization
from rrtmgp_tpu_torch.models.rrtmgp import solve_chunked
from rrtmgp_tpu_torch.ops import mega
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs
from rrtmgp_tpu_torch.states import VmrGM, slice_columns, tree_map_columns

sys.setrecursionlimit(100000)  # the df64 kernel's interpret-mode trace is deep

NLAY = 8
REL = 1e-10


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


@pytest.fixture
def kernel_dispatch(monkeypatch):
    """solve_* take their kernel path on CPU tensors, where the wrappers run
    their plain twins."""
    from rrtmgp_tpu_torch.models import rrtmgp as tmod

    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "kernel")


# ---------------------------------------------------------------------------
# The f64 LW no-scattering solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def df64_prob():
    """The problem of tests/test_df64_solve.py, for both packages."""
    ncol = 128
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=16, n_bnd=2, n_eta=3, n_press=10, n_temp=5,
                                   dtype=np.float64)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float64)
    emis = np.full((2, ncol), 0.98)
    return (jl, ja, jrt.LwBCs(sfc_emis=jnp.asarray(emis)), convert.gas_lookup_from_object(jl),
            convert.atmosphere_from_object(ja), convert.lw_bcs_from_numpy(sfc_emis=emis))


def test_kernel_tables_and_inputs_keep_f64(df64_prob):
    _, _, _, tl, ta, _ = df64_prob
    tabs, inp = tl.kernel_tables, mega_lw_inputs(tl, ta)
    for name in ("kmajor", "second", "kminor"):
        assert getattr(tabs, name).dtype == torch.float64, name
    for f in dataclasses.fields(inp):
        x = getattr(inp, f.name)
        if x is not None and x.is_floating_point():
            assert x.dtype == torch.float64, f.name
    assert tl.to(dtype=torch.float32).kernel_tables.kmajor.dtype == torch.float32


@pytest.mark.parametrize("n_angles", [1, 2, 3])
def test_f64_solve_lw_kernel_path_matches_jax_exact(df64_prob, kernel_dispatch, n_angles):
    jl, ja, jb, tl, ta, tb = df64_prob
    ref, _ = jax.jit(lambda a, b: jmod.solve_lw(jl, a, b, n_gauss_angles=n_angles))(ja, jb)
    out, diag = solve_lw(tl, ta, tb, n_gauss_angles=n_angles)
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert getattr(out, name).dtype == torch.float64
        assert _rel(getattr(out, name), getattr(ref, name)) <= REL, name
    assert diag.cld_cover is None
    # the kernel path's pieces equal the torch path to rounding
    exact, _ = solve_lw(tl, ta, tb, n_gauss_angles=n_angles, impl="torch")
    assert _rel(out.flux_up, exact.flux_up.numpy()) <= 1e-13


@pytest.mark.parametrize("n_angles", [1, 2])
def test_f64_solve_lw_within_reference_tolerance_of_df64_kernel(df64_prob, kernel_dispatch, n_angles):
    """The native-f64 solve and the JAX double-f32 kernel it replaces agree
    within the reference's f64 LW tolerance, 1e-4 W/m2."""
    from rrtmgp_tpu.ops.pallas_mega_df import build_df64_tables, compute_df64_window, solve_lw_df64

    jl, ja, jb, tl, ta, tb = df64_prob
    up, dn = solve_lw_df64(jl, build_df64_tables(jl), ja, jb, window=compute_df64_window(jl, ja),
                           n_gauss_angles=n_angles)
    out, _ = solve_lw(tl, ta, tb, n_gauss_angles=n_angles)
    assert np.abs(out.flux_up.numpy() - np.asarray(up)).max() <= 1e-4
    assert np.abs(out.flux_dn.numpy() - np.asarray(dn)).max() <= 1e-4


def test_f64_lw_clear_mega_ref_with_36_gpoints_and_incident_flux():
    """A g-point count that is not a power of two, with an incident flux:
    the f64 twin against the JAX exact f64 solve."""
    ncol = 20
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=36, n_bnd=4, seed=2, dtype=np.float64)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float64)
    rng = np.random.default_rng(5)
    emis, inc = rng.uniform(0.9, 1.0, (4, ncol)), rng.uniform(0.0, 2.0, (ncol, 36))
    ref, _ = jax.jit(lambda a, b: jmod.solve_lw(jl, a, b))(
        ja, jrt.LwBCs(sfc_emis=jnp.asarray(emis), inc_flux=jnp.asarray(inc)))
    tl, ta = convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja)
    plk = lambda t: mega.planck_band(t.reshape(-1), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    Ds, wts = angular_discretization(1)
    args = (mega_lw_inputs(tl, ta), tl.kernel_tables, plk(ta.t_lay), plk(ta.t_lev), plk(ta.t_sfc),
            torch.from_numpy(emis), torch.from_numpy(inc), float(Ds[0]), float(wts[0]))
    up, dn = mega.lw_clear_mega(*args)
    up_ref, dn_ref = mega.lw_clear_mega_ref(*args)
    assert torch.equal(up, up_ref) and torch.equal(dn, dn_ref) and up.dtype == torch.float64
    assert _rel(up, ref.flux_up) <= REL and _rel(dn, ref.flux_dn) <= REL
    assert set(mega.launch_counts().values()) == {0}  # CPU tensors: twins only


class _Routed(Exception):
    """Raised by a recording ``_resolve_impl`` with (route, warned): the
    solve goes no further."""


def test_f64_routing_by_solve(monkeypatch):
    """impl=None on f64 CUDA tensors takes the kernel only for the solves
    that have one (clear-sky LW no-scattering and SW two-stream without
    aerosols); the others warn and take the torch path; impl='kernel'
    raises for them, naming the ROADMAP item; on CPU tensors f64 takes the
    torch path silently."""
    from rrtmgp_tpu_torch.models import rrtmgp as tmod

    real = tmod._resolve_impl
    cuda, cpu, f64 = torch.device("cuda"), torch.device("cpu"), torch.float64
    assert real(None, cuda, f64, True) == "kernel"
    assert real("kernel", cuda, f64, True) == "kernel"
    assert real("torch", cuda, f64, True) == "torch"
    with pytest.warns(UserWarning, match="clear-sky LW no-scattering and SW two-stream solves without aerosols"):
        assert real(None, cuda, f64, False) == "torch"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 20"):
        real("kernel", cuda, f64, False)
    assert real(None, cpu, f64, True) == "torch"

    # solve_sw's own condition, routed as for CUDA tensors of the inputs
    def spy(impl, device, *args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            route = real(impl, cuda, *args, **kwargs)
        raise _Routed(route, any(str(w.message) == tmod.F64_WARNING for w in caught))

    monkeypatch.setattr(tmod, "_resolve_impl", spy)
    _, port = _allsky_case(np.float64)
    sw, atm, bcs = port["sw"], port["atm"], port["bc_sw"]
    clouds = dict(lkp_cld=port["cld"], cld_mask_seed=3)
    for kw, want in ((dict(), ("kernel", False)), (dict(two_stream=False), ("torch", True)),
                     (dict(lkp_aero=port["aero"]), ("torch", True)), (clouds, ("torch", True)),
                     (dict(clouds, lkp_aero=port["aero"]), ("torch", True))):
        with pytest.raises(_Routed) as routed:
            solve_sw(sw, atm, bcs, **kw)
        assert routed.value.args == want, kw
    for kw in (dict(lkp_aero=port["aero"]), clouds):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 20"):
            solve_sw(sw, atm, bcs, impl="kernel", **kw)


def test_f64_two_stream_twin_runs_in_f64(df64_prob, kernel_dispatch):
    """With the dispatch forced to the kernel path, CPU tensors run the
    twins in the inputs' dtype (the wrappers refuse f64 on CUDA tensors
    where the kernel has no f64 build)."""
    _, _, _, tl, ta, tb = df64_prob
    out, _ = solve_lw(tl, ta, tb, two_stream=True)
    ref, _ = solve_lw(tl, ta, tb, two_stream=True, impl="torch")
    assert out.flux_up.dtype == torch.float64
    assert _rel(out.flux_up, ref.flux_up.numpy()) <= 1e-13


# ---------------------------------------------------------------------------
# The f64 SW two-stream solve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sw64_prob():
    """A clear-sky SW problem in f64 for both packages: random albedos and
    sun angles, every fifth column at night."""
    ncol = 40
    jl = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=16, n_bnd=2, n_eta=3, n_press=10, n_temp=5, seed=1,
                                   dtype=np.float64)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float64)
    rng = np.random.default_rng(7)
    mu0 = rng.uniform(0.02, 1.0, ncol)
    mu0[::5] = -0.2
    bc = dict(cos_zenith=mu0, toa_flux=rng.uniform(1300.0, 1400.0, ncol),
              sfc_alb_direct=rng.uniform(0.05, 0.4, (2, ncol)), sfc_alb_diffuse=rng.uniform(0.05, 0.4, (2, ncol)))
    return (jl, ja, jrt.SwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}), convert.gas_lookup_from_object(jl),
            convert.atmosphere_from_object(ja), convert.sw_bcs_from_numpy(**bc))


def test_f64_solve_sw_kernel_path_matches_jax_exact(sw64_prob, kernel_dispatch):
    jl, ja, jb, tl, ta, tb = sw64_prob
    ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jl, a, b))(ja, jb)
    out, diag = solve_sw(tl, ta, tb)
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        assert getattr(out, name).dtype == torch.float64
        assert _rel(getattr(out, name), getattr(ref, name)) <= REL, name
    assert diag.cld_cover is None and torch.all(out.flux_dn[:, ::5] == 0.0)
    # the kernel path's pieces equal the torch path to rounding
    exact, _ = solve_sw(tl, ta, tb, impl="torch")
    for a, b in zip(out, exact):
        assert _rel(a, b.numpy()) <= 1e-13


def test_f64_sw_clear_mega_ref_with_36_gpoints_and_incident_diffuse_flux():
    """A g-point count that is not a power of two, with an incident diffuse
    flux: the f64 twin against the JAX exact f64 solve (day columns: the
    twin leaves night columns to the caller)."""
    ncol = 20
    jl = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=36, n_bnd=4, seed=2, dtype=np.float64)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float64)
    rng = np.random.default_rng(5)
    bc = dict(cos_zenith=rng.uniform(0.05, 1.0, ncol), toa_flux=np.full(ncol, 1361.0),
              sfc_alb_direct=rng.uniform(0.05, 0.4, (4, ncol)), sfc_alb_diffuse=rng.uniform(0.05, 0.4, (4, ncol)),
              inc_flux_diffuse=rng.uniform(0.0, 2.0, (ncol, 36)))
    ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jl, a, b))(ja, jrt.SwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}))
    tl, ta, tb = convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja), convert.sw_bcs_from_numpy(**bc)
    toa_gpt = tb.toa_flux[:, None] * tl.solar_src_scaled[None, :]
    args = (mega_sw_inputs(tl, ta), tl.kernel_tables, tb.cos_zenith, toa_gpt, tb.sfc_alb_direct,
            tb.sfc_alb_diffuse, tb.inc_flux_diffuse)
    out, twin = mega.sw_clear_mega(*args), mega.sw_clear_mega_ref(*args)
    assert all(torch.equal(a, b) and a.dtype == torch.float64 for a, b in zip(out, twin))
    for got, name in zip(out, ("flux_up", "flux_dn", "flux_dn_dir")):
        assert _rel(got, getattr(ref, name)) <= REL, name
    assert set(mega.launch_counts().values()) == {0}  # CPU tensors: twins only


def test_f64_megakernels_refuse_a_composition():
    """The f64 builds of both megakernels are clear sky only: their wrappers
    refuse clouds or aerosols in f64, naming the ROADMAP item."""
    _, port = _allsky_case(np.float64)
    aero = port["atm"].aerosol_state.aero_mass[0] > 0.0
    composed = (mega.Composition(aero_bands=(aero,) * 3, aero_mask=aero),
                mega.Composition(cld_bands=(aero,) * 3, cld_frac=aero, seed=3))
    for name in ("lw_clear_mega", "sw_clear_mega"):
        mega._f64_clear_only(name, mega.CLEAR)
        for comp in composed:
            with pytest.raises(NotImplementedError, match=f"{name}: .*ROADMAP queue 1, item 20"):
                mega._f64_clear_only(name, comp)


# ---------------------------------------------------------------------------
# Column maps and solve_chunked
# ---------------------------------------------------------------------------


def _allsky_case(dtype, ncol=12, ngpt=16, nbnd=2):
    """JAX and port inputs of a small all-sky problem: fractional clouds,
    aerosols in the lower layers, an incident LW flux."""
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=nbnd, dtype=dtype)
    js = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=ngpt, n_bnd=nbnd, seed=1, dtype=dtype)
    jc = jsyn.synthetic_cloud_lookup(n_bnd=nbnd, dtype=dtype)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=nbnd, dtype=dtype)
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=dtype, with_clouds=True, with_aerosols=True)
    rng = np.random.default_rng(31)
    cf = np.asarray(ja.cloud_state.cld_frac) * rng.uniform(0.2, 1.0, (NLAY, ncol)).astype(dtype)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, ncol)).astype(dtype)
    mass[:, NLAY // 2:] = 0.0
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass)),
    )
    mu0 = rng.uniform(0.1, 1.0, ncol).astype(dtype)
    mu0[::5] = -0.1
    bc_lw = dict(sfc_emis=rng.uniform(0.9, 1.0, (nbnd, ncol)).astype(dtype))
    bc_sw = dict(cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, dtype),
                 sfc_alb_direct=rng.uniform(0.05, 0.4, (nbnd, ncol)).astype(dtype),
                 sfc_alb_diffuse=rng.uniform(0.05, 0.4, (nbnd, ncol)).astype(dtype))
    inc = rng.uniform(0.0, 2.0, (ncol, ngpt)).astype(dtype)
    jax_side = dict(lw=jl, sw=js, cld=jc, aero=jae, atm=ja, bc_lw=bc_lw, bc_sw=bc_sw)
    port = dict(lw=convert.gas_lookup_from_object(jl), sw=convert.gas_lookup_from_object(js),
                cld=convert.cloud_lookup_from_object(jc), aero=convert.aerosol_lookup_from_object(jae),
                atm=convert.atmosphere_from_object(ja),
                bc_lw=convert.lw_bcs_from_numpy(**bc_lw, inc_flux=inc),
                bc_sw=convert.sw_bcs_from_numpy(**bc_sw, inc_flux_diffuse=inc))
    return jax_side, port


def test_tree_map_columns_and_slice_columns():
    _, port = _allsky_case(np.float32, ncol=12)
    atm, bl, bs = port["atm"], port["bc_lw"], port["bc_sw"]
    ngas = atm.vmr.vmr.shape[0]
    part = slice_columns(atm, 3, 8, 12)
    assert part.ncol == 5 and part.p_lev.shape == (NLAY + 1, 5) and part.t_sfc.shape == (5,)
    assert torch.equal(part.t_lay, atm.t_lay[:, 3:8]) and part.t_lay.is_contiguous()
    assert torch.equal(part.cloud_state.cld_frac, atm.cloud_state.cld_frac[:, 3:8])
    assert part.cloud_state.ice_rgh == atm.cloud_state.ice_rgh
    assert torch.equal(part.aerosol_state.aero_mass, atm.aerosol_state.aero_mass[..., 3:8])
    assert torch.equal(part.vmr.vmr, atm.vmr.vmr) and part.vmr.vmr_h2o.shape == (NLAY, 5)
    # the incident fluxes are (ncol, ngpt): cut on their leading axis
    assert torch.equal(slice_columns(bl, 3, 8, 12).inc_flux, bl.inc_flux[3:8])
    assert slice_columns(bl, 3, 8, 12).inc_flux.is_contiguous()
    cut = slice_columns(bs, 10, 12, 12)
    assert cut.cos_zenith.shape == (2,) and cut.sfc_alb_direct.shape == (2, 2)
    assert torch.equal(cut.inc_flux_diffuse, bs.inc_flux_diffuse[10:])
    # ncol == ngas + 1: a shape test would cut the global-mean vector
    vm = VmrGM(torch.zeros(NLAY, ngas), torch.zeros(NLAY, ngas), atm.vmr.vmr)
    cut = slice_columns(vm, 0, 2, ngas)
    assert cut.vmr_h2o.shape == (NLAY, 2) and torch.equal(cut.vmr, atm.vmr.vmr)
    seen = []
    tree_map_columns(lambda x: seen.append("col") or x, lambda x: seen.append("other") or x, vm)
    assert seen == ["col", "col", "other"]
    assert tree_map_columns(lambda x: x, lambda x: x, None) is None


CHUNK_MODES = ("clear", "mask", "seed")


def _chunk_kwargs(mode, port, wave):
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica

    lkp = port["lw" if wave == "lw" else "sw"]
    kw = dict(lkp_aero=port["aero"])
    if mode != "clear":
        kw["lkp_cld"] = port["cld"]
    mask = None
    if mode == "mask":
        mask = build_cloud_mask_mcica(port["atm"].cloud_state.cld_frac, lkp.n_gpt, 5, 0)
    return kw, mask, 5 if mode == "seed" else None


def _run_chunked(solve, lkp, atm, bcs, kw, mask, seed, chunk):
    if mask is not None:
        one = lambda a, b, m: solve(lkp, a, b, cld_mask=m, **kw)
    elif seed is not None:
        one = lambda a, b, s, off: solve(lkp, a, b, cld_mask_seed=s, col_offset=off, **kw)
    else:
        one = lambda a, b: solve(lkp, a, b, **kw)
    return solve_chunked(one, atm, bcs, chunk, cld_mask=mask, cld_mask_seed=seed)


def _assert_same(chunked, whole):
    (cf, cd), (wf, wd) = chunked, whole
    assert type(cf) is type(wf) and type(cd) is type(wd)
    for a, b in zip((*cf, *cd), (*wf, *wd)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("chunk", [4, 5, 12, 100])
@pytest.mark.parametrize("mode", CHUNK_MODES)
def test_solve_chunked_equals_unchunked_on_the_torch_path(mode, chunk):
    _, port = _allsky_case(np.float64)
    for wave, solve, extra in (("lw", solve_lw, dict(n_gauss_angles=2)), ("sw", solve_sw, {})):
        kw, mask, seed = _chunk_kwargs(mode, port, wave)
        kw.update(extra)
        lkp, bcs = port[wave], port["bc_" + wave]
        whole = solve(lkp, port["atm"], bcs, cld_mask=mask, cld_mask_seed=seed, **kw)
        _assert_same(_run_chunked(solve, lkp, port["atm"], bcs, kw, mask, seed, chunk), whole)


@pytest.mark.parametrize("chunk", [4, 5])
@pytest.mark.parametrize("mode", CHUNK_MODES)
def test_solve_chunked_equals_unchunked_on_the_kernel_path(kernel_dispatch, mode, chunk):
    """The kernel path's pieces (twins on the CPU): LW no-scattering with 3
    angles, LW two-stream and SW, f32."""
    _, port = _allsky_case(np.float32)
    for wave, solve, extra in (("lw", solve_lw, dict(n_gauss_angles=3)),
                               ("lw", solve_lw, dict(two_stream=True)), ("sw", solve_sw, {})):
        kw, mask, seed = _chunk_kwargs(mode, port, wave)
        kw.update(extra)
        lkp, bcs = port[wave], port["bc_" + wave]
        whole = solve(lkp, port["atm"], bcs, cld_mask=mask, cld_mask_seed=seed, **kw)
        _assert_same(_run_chunked(solve, lkp, port["atm"], bcs, kw, mask, seed, chunk), whole)
        if mode == "seed":
            assert whole[1].cld_cover is not None and float(whole[1].cld_cover.max()) > 0.0


@pytest.mark.parametrize("mode", CHUNK_MODES)
def test_solve_chunked_matches_jax_solve_chunked(mode):
    """Both packages' chunked LW solves (f64, chunk 4 of 12 columns; the JAX
    one takes only chunks that divide ncol and no incident flux)."""
    jx, port = _allsky_case(np.float64)
    kw, mask, seed = _chunk_kwargs(mode, port, "lw")
    bcs = dataclasses.replace(port["bc_lw"], inc_flux=None)
    out, diag = _run_chunked(solve_lw, port["lw"], port["atm"], bcs, kw, mask, seed, 4)
    jkw = dict(lkp_aero=jx["aero"], **({} if mode == "clear" else dict(lkp_cld=jx["cld"])))
    jb = jrt.LwBCs(sfc_emis=jnp.asarray(jx["bc_lw"]["sfc_emis"]))
    if mode == "mask":
        fn = lambda a, b, m: jmod.solve_lw(jx["lw"], a, b, cld_mask=m, **jkw)
        ref, jdiag = jmod.solve_chunked(fn, jx["atm"], jb, 4, cld_mask=jnp.asarray(mask.numpy()))
    elif mode == "seed":
        fn = lambda a, b, s, off: jmod.solve_lw(jx["lw"], a, b, cld_mask_seed=s, col_offset=off, **jkw)
        ref, jdiag = jmod.solve_chunked(fn, jx["atm"], jb, 4, cld_mask_seed=5)
    else:
        ref, jdiag = jmod.solve_chunked(lambda a, b: jmod.solve_lw(jx["lw"], a, b, **jkw), jx["atm"], jb, 4)
    for name in ("flux_up", "flux_dn", "flux_net"):
        assert _rel(getattr(out, name), getattr(ref, name)) <= REL, name
    if mode != "clear":
        np.testing.assert_allclose(diag.cld_cover.numpy(), np.asarray(jdiag.cld_cover), rtol=1e-12)


def test_solve_chunked_rejects_an_empty_chunk():
    _, port = _allsky_case(np.float32)
    with pytest.raises(ValueError, match="chunk"):
        solve_chunked(lambda a, b: None, port["atm"], port["bc_lw"], 0)


# ---------------------------------------------------------------------------
# RRTMGPSolver in f64: the auto-chunk
# ---------------------------------------------------------------------------

METHODS = {
    "clear": ("ClearSkyRadiation", False, False),
    "clear+aerosols": ("ClearSkyRadiation", True, False),
    "allsky+aerosols": ("AllSkyRadiation", True, True),
    "allsky+clear diagnostics+aerosols": ("AllSkyRadiationWithClearSkyDiagnostics", True, False),
}
FLUXES = ["lw_flux_up", "lw_flux_dn", "lw_flux_net", "sw_flux_up", "sw_flux_dn", "sw_flux_net",
          "sw_direct_flux_dn"]
CLEAR_FLUXES = ["clear_lw_flux_up", "clear_lw_flux_dn", "clear_sw_flux_up", "clear_sw_flux_dn"]


def _solvers(key, **port_kw):
    """(port solver, JAX solver with f64_kernel=False) in f64 on the same
    inputs, built under the environment's chunk budget."""
    name, aero, two_stream_lw = METHODS[key]
    jx, port = _allsky_case(np.float64)
    ncol = 12
    jl = jrt.LookupBundle(lookup_lw=jx["lw"], lookup_sw=jx["sw"], lookup_lw_cld=jx["cld"],
                          lookup_sw_cld=jx["cld"], lookup_lw_aero=jx["aero"], lookup_sw_aero=jx["aero"])
    tl = rt.LookupBundle(lookup_lw=port["lw"], lookup_sw=port["sw"], lookup_lw_cld=port["cld"],
                         lookup_sw_cld=port["cld"], lookup_lw_aero=port["aero"], lookup_sw_aero=port["aero"])
    jb = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    common = dict(two_stream_lw=two_stream_lw, n_gauss_angles=1 if two_stream_lw else 2)
    js = jrt.RRTMGPSolver(
        jrt.RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=jnp.float64), getattr(jrt, name)(aerosol_radiation=aero),
        jrt.RRTMGPParameters(), jrt.LwBCs(**jb(jx["bc_lw"])), jrt.SwBCs(**jb(jx["bc_sw"])), jx["atm"],
        lookups=jl, f64_kernel=False, **common)
    bl = dataclasses.replace(port["bc_lw"], inc_flux=None)
    bs = dataclasses.replace(port["bc_sw"], inc_flux_diffuse=None)
    ts = rt.RRTMGPSolver(
        rt.RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=torch.float64), getattr(rt, name)(aerosol_radiation=aero),
        rt.RRTMGPParameters(), bl, bs, port["atm"], lookups=tl, **common, **port_kw)
    return ts, js


@pytest.mark.parametrize("key", list(METHODS))
def test_f64_solver_auto_chunks_and_matches_jax(monkeypatch, key):
    whole, _ = _solvers(key)
    assert whole.auto_chunk is None
    # 8 layers x 16 g-points x 8 B x 34 = 34816 B per column: 8 columns fit 3e5 B
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", "0.0003")
    with pytest.warns(UserWarning, match="auto-chunking into 8-column chunks"):
        port, ref = _solvers(key, f64_kernel=False)
    assert port.auto_chunk == ref.auto_chunk == 8  # does not divide the 12 columns
    for s in (whole, port, ref):
        s.advance_step(3)
        s.update_fluxes()
    names = FLUXES + (CLEAR_FLUXES if "diagnostics" in key else [])
    for name in names:
        a, b = getattr(port, name)(), getattr(whole, name)()
        assert a.dtype == torch.float64 and torch.equal(a, b), name
        assert _rel(a, getattr(ref, name)()) <= REL, name
    for name in ("lw_cloud_cover", "sw_cloud_cover", "aod_sw_extinction", "aod_sw_scattering"):
        a, b, c = getattr(port, name)(), getattr(whole, name)(), getattr(ref, name)()
        assert (a is None) == (b is None) == (c is None), name
        if a is not None:
            assert torch.equal(a, b), name
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-9, err_msg=name)
    if key == "clear+aerosols":
        plain, _ = _solvers("clear")
        plain.update_fluxes()
        assert float((plain.lw_flux_up() - port.lw_flux_up()).abs().max()) > 1e-6  # the aerosols are kept


def test_f64_solver_metric_scaling_and_budget_default(monkeypatch):
    """Chunked solves apply the metric scaling to the assembled fluxes; the
    default budget leaves a small problem whole."""
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", "0.0003")
    scale = torch.linspace(0.9, 1.1, NLAY + 1, dtype=torch.float64)[:, None] * torch.ones(1, 12, dtype=torch.float64)
    with pytest.warns(UserWarning, match="auto-chunking"):
        plain, _ = _solvers("allsky+aerosols")
    with pytest.warns(UserWarning, match="auto-chunking"):
        scaled, _ = _solvers("allsky+aerosols", metric_scaling=scale)
    for s in (plain, scaled):
        s.update_fluxes()
    for a, b in zip((*plain.flux_lw, *plain.flux_sw), (*scaled.flux_lw, *scaled.flux_sw)):
        assert torch.equal(a * scale, b)
