"""The unfused optics of the two-kernel path (the JAX package's
``pallas_windowed="off"``; ``fused_optics=False`` in the port): the table
interpolation kernel (``ops.interp.interp_pt_eta``), the minor-gas kernel
(``ops.interp.interp_minor``) and ``optics_unfused`` built from them, each
against the JAX package's Pallas kernels run in interpret mode, and
solve_lw / solve_sw / RRTMGPSolver through ``fused_optics=False``.

On the CPU a kernel wrapper runs its plain twin; the two-kernel route is
reached by patching ``_resolve_impl`` (fixture ``two_kernel_dispatch``) or by
routing as for CUDA tensors (``cuda_routing``). Small sizes: 8-24 columns,
6-8 layers, synthetic lookups of 32 g-points in 4 bands (36 for the kernels,
a count no warp divides).

Tolerances, each relative to the largest reference value:
- the kernels' twins vs the JAX Pallas kernels: 5e-5 (the JAX kernels
  contract bf16 hi/lo table splits; tests/test_torch_two_kernel.py);
- the unfused optics vs the JAX unfused optics: 5e-5; vs the JAX XLA
  optics: 1e-6; vs the port's fused optics (``optics_fused_ref``): equal bit
  for bit, since the twins compute the same operations in the same order;
- solves vs the JAX ``pallas_windowed="off"`` solves: 5e-5 LW, 1e-4 SW (the
  JAX gates of its two-kernel path); vs the port's fused two-kernel route:
  equal bit for bit.
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
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs
from rrtmgp_tpu_torch import RRTMGPGridParams, RRTMGPSolver, convert, solve_lw, solve_sw
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.ops import interp, mega
from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica
from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw_raw, gas_optics_sw
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

NLAY = 8
TOL_PALLAS = 5e-5
TOL_JAX_OFF = {"lw": 5e-5, "sw": 1e-4}


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.all(np.isfinite(port))
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


def _lookup(longwave, n_gpt=32):
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=n_gpt, n_bnd=4, seed=2, dtype=np.float32)
    return jl, convert.gas_lookup_from_object(jl)


def _atmosphere(ncol, nlay):
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32)
    return ja, convert.atmosphere_from_object(ja)


@pytest.fixture
def two_kernel_dispatch(monkeypatch):
    """solve_* take the two-kernel path whatever the device; on CPU tensors
    its wrappers run their plain twins."""
    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "two_kernel")


@pytest.fixture
def cuda_routing(monkeypatch):
    """solve_* route as they do for CUDA tensors; the wrappers then run
    their twins on the CPU tensors."""
    real = tmod._resolve_impl
    monkeypatch.setattr(tmod, "_resolve_impl", lambda impl, device, *args, **kwargs: real(
        impl, torch.device("cuda"), *args, **kwargs))


# ---------------------------------------------------------------------------
# The kernels' twins against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_gpt", [32, 36])
@pytest.mark.parametrize("table", ["kmajor", "planck fraction", "rayleigh"])
def test_interp_pt_eta_ref_matches_jax_pallas(table, n_gpt):
    """K9's twin vs the JAX interp_pt_eta on the same numbers, at 5e-5 of
    the largest value: kmajor with col_mix, the Planck fraction with ones
    (no col_mix in the port), and the 2-slab Rayleigh table at the
    troposphere side's slab with fpress = 0, both sides present, so that the
    pressure node past the last slab (side 1) is skipped. The JAX kernel's
    rows are built as ``_interp_table`` builds them (q0 = slab *
    rows_per_slab + jtemp)."""
    ncol, nlay = 8, 6
    longwave = table != "rayleigh"
    jl, tl = _lookup(longwave, n_gpt)
    _, ta = _atmosphere(ncol, nlay)
    inp = (mega_lw_inputs if longwave else mega_sw_inputs)(tl, ta)
    tabs, jtabs = tl.kernel_tables, jgp.build_pallas_tables(jl)
    assert inp.tropo_lower.any() and (~inp.tropo_lower).any()
    if table == "rayleigh":
        jpress, fpress = (~inp.tropo_lower).to(torch.int32), torch.zeros_like(inp.fpress)
    else:
        jpress, fpress = inp.jpress_base, inp.fpress
    t_table, hi, lo = {
        "kmajor": (tabs.kmajor, jtabs.kmajor_hi, jtabs.kmajor_lo),
        "planck fraction": (tabs.second, jtabs.planck_hi, jtabs.planck_lo),
        "rayleigh": (tabs.second, jtabs.rayl_hi, jtabs.rayl_lo),
    }[table]
    cm = (inp.col_mix1, inp.col_mix2) if table == "kmajor" else (None, None)
    out = interp.interp_pt_eta(t_table, inp.jtemp, inp.ftemp, jpress, fpress, inp.jeta1, inp.feta1,
                               inp.jeta2, inp.feta2, tabs.gpt2band, *cm)
    rows = nlay * ncol
    rps = jpi.rows_per_slab(tl.n_temp)
    flat = lambda x: jnp.asarray(x.reshape(rows, *x.shape[2:]).numpy())
    ones = torch.ones_like(inp.col_mix1)
    ref = jpi.interp_pt_eta(
        hi, lo, flat(jpress * rps + inp.jtemp), flat(fpress), flat(inp.ftemp),
        flat(inp.jeta1), flat(inp.feta1), flat(inp.jeta2), flat(inp.feta2),
        flat(inp.col_mix1 if cm[0] is not None else ones), flat(inp.col_mix2 if cm[0] is not None else ones),
        n_temp=rps, n_eta=tl.n_eta, n_gpt=n_gpt, bnd_lims_gpt=tuple(map(tuple, jl.bnd_lims_gpt)),
        block_rows=16,
    )
    assert out.shape == (nlay, ncol, n_gpt)
    assert _rel(out, np.asarray(ref).reshape(nlay, ncol, n_gpt)) <= TOL_PALLAS
    assert interp.interp_pt_eta.launches == 0  # CPU tensors: the twin only


@pytest.mark.parametrize("n_gpt", [32, 36])
@pytest.mark.parametrize("longwave", [True, False])
def test_interp_minor_ref_matches_jax_pallas(longwave, n_gpt):
    """K10's twin vs the JAX merged minor-gas kernel (``_tau_minor_merged``,
    its inputs from the JAX prologue) at 5e-5 of the largest value, and
    the same values as the minor part of the fused optics' twin."""
    ncol, nlay, block = 8, 6, 8
    jl, tl = _lookup(longwave, n_gpt)
    ja, ta = _atmosphere(ncol, nlay)
    inp = (mega_lw_inputs if longwave else mega_sw_inputs)(tl, ta)
    out = interp.interp_minor(inp, tl.kernel_tables)
    jtabs = jgp.build_pallas_tables(jl)
    _, _, pt2d, eta2d, _, _, _, ncol_pad = jgp._prep(jl, ja, block)
    ref = jgp._tau_minor_merged(jl, jtabs, ja, pt2d, eta2d, ncol_pad, block)
    assert out.shape == (nlay, ncol, n_gpt)
    assert float(out.abs().max()) > 0.0
    assert _rel(out, np.asarray(ref)[:, :ncol]) <= TOL_PALLAS
    major = interp.interp_pt_eta(tl.kernel_tables.kmajor, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress,
                                 inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tl.kernel_tables.gpt2band,
                                 inp.col_mix1, inp.col_mix2)
    assert torch.equal(major * inp.col_dry[..., None] + out, interp.tau_gas(inp, tl.kernel_tables))
    assert interp.interp_minor.launches == 0


# ---------------------------------------------------------------------------
# The unfused optics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("longwave", [True, False])
def test_unfused_optics_match_jax_and_the_fused_optics(longwave):
    """gas_optics_lw_raw / gas_optics_sw with fused=False vs the JAX unfused
    optics (windowed="off") at 5e-5, the JAX XLA optics at 1e-6, and the
    port's fused optics (twin and wrapper functions) bit for bit."""
    ncol, nlay = 12, 6
    jl, tl = _lookup(longwave)
    ja, ta = _atmosphere(ncol, nlay)
    jtabs = jgp.build_pallas_tables(jl)
    pt = jgo.compute_pt_interp(jl, ja.p_lay, ja.t_lay)
    eta = jgo.compute_eta_interp(jl, ja.vmr, pt)
    if longwave:
        raw = gas_optics_lw_raw(tl, ta, fused=False)
        out = (raw.tau, raw.pfrac)
        fused = gas_optics_lw_raw(tl, ta)
        fused = (fused.tau, fused.pfrac)
        pal = jgp.gas_optics_lw_raw(jl, jtabs, ja, block=8, windowed="off")
        pal = (pal.tau, pal.pfrac)
        xla = (jgo.gas_optics_lw(jl, ja).tau, jgo.compute_planck_fraction(jl, pt, eta))
        twin = interp.optics_fused_ref(mega_lw_inputs(tl, ta), tl.kernel_tables)
    else:
        out = tuple(gas_optics_sw(tl, ta, fused=False))
        fused = tuple(gas_optics_sw(tl, ta))
        pal = jgp.gas_optics_sw(jl, jtabs, ja, block=8, windowed="off")
        xla = jgo.gas_optics_sw(jl, ja)
        twin = interp.optics_fused_ref(mega_sw_inputs(tl, ta), tl.kernel_tables)
    for name, o, f, t, p, x in zip(("tau", "second"), out, fused, twin, pal, xla):
        assert o.shape == (nlay, ncol, 32)
        assert torch.equal(o, t) and torch.equal(o, f), name
        assert _rel(o, p) <= TOL_PALLAS, (name, _rel(o, p))
        assert _rel(o, x) <= 1e-6, (name, _rel(o, x))
    assert float(out[0].min()) >= 0.0
    assert interp.interp_pt_eta.launches == interp.interp_minor.launches == 0


# ---------------------------------------------------------------------------
# The slice: solve_lw / solve_sw through fused_optics=False
# ---------------------------------------------------------------------------


def _allsky(ncol, longwave):
    """The synthetic cloudy, aerosol-laden atmosphere (fractional cloud
    fraction, aerosols in the lower half), a McICA mask drawn by the port
    for it, and the cloud and aerosol lookups: (JAX kwargs, port kwargs,
    JAX atmosphere, port atmosphere)."""
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    rng = np.random.default_rng(21)
    cf = np.asarray(ja.cloud_state.cld_frac) * rng.uniform(0.2, 1.0, (NLAY, ncol)).astype(np.float32)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, ncol)).astype(np.float32)
    mass[:, NLAY // 2:] = 0.0
    ja = dataclasses.replace(
        ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
        aerosol_state=dataclasses.replace(ja.aerosol_state, aero_mass=jnp.asarray(mass)),
    )
    ta = convert.atmosphere_from_object(ja)
    mask = build_cloud_mask_mcica(ta.cloud_state.cld_frac, 32, 6)
    assert mask.any()
    jc = jsyn.synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, seed=0 if longwave else 5)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, seed=0 if longwave else 6)
    jkw = dict(lkp_cld=jc, lkp_aero=jae, cld_mask=jnp.asarray(mask.numpy()))
    tkw = dict(lkp_cld=convert.cloud_lookup_from_object(jc), lkp_aero=convert.aerosol_lookup_from_object(jae),
               cld_mask=mask)
    return jkw, tkw, ja, ta


def _inputs(option, ncol, longwave):
    if option == "clear":
        ja, ta = _atmosphere(ncol, NLAY)
        return {}, {}, ja, ta
    return _allsky(ncol, longwave)


@pytest.mark.parametrize("option", ["clear", "all-sky"])
@pytest.mark.parametrize("kw", [dict(n_gauss_angles=1), dict(n_gauss_angles=3), dict(two_stream=True)],
                         ids=["1 angle", "3 angles", "two-stream"])
def test_solve_lw_unfused_matches_jax_off_and_the_fused_route(two_kernel_dispatch, kw, option):
    """solve_lw(fused_optics=False) through the two-kernel dispatch vs the
    JAX solve_lw(pallas_tables, pallas_windowed="off") at 5e-5, and vs the
    port's fused two-kernel route bit for bit; clear, and all-sky with a
    McICA cloud mask and aerosols."""
    ncol = 16
    jl, tl = _lookup(True)
    jkw, tkw, ja, ta = _inputs(option, ncol, True)
    emis = np.random.default_rng(3).uniform(0.9, 1.0, (4, ncol)).astype(np.float32)
    jb, tb = JLwBCs(sfc_emis=jnp.asarray(emis)), convert.lw_bcs_from_numpy(sfc_emis=emis)
    out, diag = solve_lw(tl, ta, tb, fused_optics=False, **kw, **tkw)
    fused, fdiag = solve_lw(tl, ta, tb, **kw, **tkw)
    off, _ = jmod.solve_lw(jl, ja, jb, pallas_tables=jgp.build_pallas_tables(jl), pallas_windowed="off",
                           **kw, **jkw)
    for name in ("flux_up", "flux_dn", "flux_net"):
        o = getattr(out, name)
        assert torch.equal(o, getattr(fused, name)), name
        assert _rel(o, getattr(off, name)) <= TOL_JAX_OFF["lw"], (name, _rel(o, getattr(off, name)))
    assert torch.all(out.flux_dn[-1] == 0.0)
    if option != "clear":
        assert torch.equal(diag.cld_cover, fdiag.cld_cover)


@pytest.mark.parametrize("option", ["clear", "all-sky"])
@pytest.mark.parametrize("two_stream", [True, False], ids=["two-stream", "direct beam"])
def test_solve_sw_unfused_matches_jax_off_and_the_fused_route(two_kernel_dispatch, two_stream, option):
    """solve_sw(fused_optics=False) through the two-kernel dispatch vs the
    JAX solve_sw(pallas_tables, pallas_windowed="off") at 1e-4 and the
    port's fused two-kernel route bit for bit; two-stream and direct beam,
    clear and all-sky; night columns 0."""
    ncol = 16
    jl, tl = _lookup(False)
    jkw, tkw, ja, ta = _inputs(option, ncol, False)
    rng = np.random.default_rng(4)
    mu0 = rng.uniform(0.05, 1.0, ncol).astype(np.float32)
    mu0[1::4] = 0.0
    bc = dict(cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, np.float32),
              sfc_alb_direct=rng.uniform(0.05, 0.4, (4, ncol)).astype(np.float32),
              sfc_alb_diffuse=rng.uniform(0.05, 0.4, (4, ncol)).astype(np.float32))
    jb, tb = JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}), convert.sw_bcs_from_numpy(**bc)
    out, diag = solve_sw(tl, ta, tb, two_stream=two_stream, fused_optics=False, **tkw)
    fused, fdiag = solve_sw(tl, ta, tb, two_stream=two_stream, **tkw)
    off, _ = jmod.solve_sw(jl, ja, jb, two_stream=two_stream, pallas_tables=jgp.build_pallas_tables(jl),
                           pallas_windowed="off", **jkw)
    for name in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net"):
        o = getattr(out, name)
        assert torch.equal(o, getattr(fused, name)), name
        if not two_stream and name != "flux_dn_dir":
            assert torch.all(o == 0.0), name
            continue
        assert _rel(o, getattr(off, name)) <= TOL_JAX_OFF["sw"], (name, _rel(o, getattr(off, name)))
    for f in out:
        assert torch.all(f[:, mu0 <= 0] == 0.0)
    if option != "clear":
        assert torch.equal(diag.aod_sw_ext, fdiag.aod_sw_ext)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def test_unfused_routing():
    """fused_optics=False: the two-kernel path for impl=None on CUDA tensors
    (every f32 solve, as the JAX "off" gives up the megakernels) and for
    "two_kernel"; the torch path on CPU tensors; ValueError with "kernel",
    "sweep" or "torch" in either dtype; an explicit "two_kernel" in f64
    names its ROADMAP item as with the fused optics. f64 with impl=None
    routes as a fused f64 solve: tests/test_torch_routes.py holds those
    routes."""
    cuda, cpu, f32, f64 = torch.device("cuda"), torch.device("cpu"), torch.float32, torch.float64
    for mega_ok in (True, False):
        assert tmod._resolve_impl(None, cuda, f32, mega=mega_ok, fused_optics=False) == "two_kernel"
    assert tmod._resolve_impl("two_kernel", cuda, f32, fused_optics=False) == "two_kernel"
    assert tmod._resolve_impl(None, cpu, f32, fused_optics=False) == "torch"
    for dtype in (f32, f64):
        for impl in ("kernel", "sweep", "torch"):
            with pytest.raises(ValueError, match="fused_optics"):
                tmod._resolve_impl(impl, cuda, dtype, True, fused_optics=False)
    for has_kernel in (False, True):
        with pytest.raises(NotImplementedError, match=mega.F64_ALLSKY_ITEM):
            tmod._resolve_impl("two_kernel", cuda, f64, has_kernel, fused_optics=False)


def test_unfused_on_cpu_runs_the_torch_path_and_refuses_other_impls():
    """On CPU tensors solve_lw / solve_sw with fused_optics=False and
    impl=None equal the torch path bit for bit and launch nothing; an impl
    without a materialized-optics kernel raises ValueError."""
    jl, tl = _lookup(True)
    jls, tls = _lookup(False)
    _, ta = _atmosphere(8, NLAY)
    tb = convert.lw_bcs_from_numpy(sfc_emis=np.full((4, 8), 0.98, np.float32))
    sb = convert.sw_bcs_from_numpy(cos_zenith=np.full(8, 0.6, np.float32), toa_flux=np.full(8, 1361.0, np.float32),
                                   sfc_alb_direct=np.full((4, 8), 0.2, np.float32),
                                   sfc_alb_diffuse=np.full((4, 8), 0.2, np.float32))
    mega.reset_launch_counts()
    lw, _ = solve_lw(tl, ta, tb, n_gauss_angles=3, fused_optics=False)
    sw, _ = solve_sw(tls, ta, sb, fused_optics=False)
    assert all(torch.equal(a, b) for a, b in zip(lw, solve_lw(tl, ta, tb, n_gauss_angles=3, impl="torch")[0]))
    assert all(torch.equal(a, b) for a, b in zip(sw, solve_sw(tls, ta, sb, impl="torch")[0]))
    assert interp.interp_pt_eta.launches == interp.interp_minor.launches == 0
    assert not any(mega.launch_counts().values())
    for impl in ("kernel", "sweep", "torch"):
        with pytest.raises(ValueError, match="fused_optics"):
            solve_lw(tl, ta, tb, impl=impl, fused_optics=False)
        with pytest.raises(ValueError, match="fused_optics"):
            solve_sw(tls, ta, sb, impl=impl, fused_optics=False)


def test_solver_passes_fused_optics_through(cuda_routing, monkeypatch):
    """RRTMGPSolver(fused_optics=False).update_fluxes() routes its LW and SW
    solves as for CUDA tensors through the unfused two-kernel path (its
    twins on the CPU): the routing sees fused_optics=False, the unfused
    optics run once per solve, and the fluxes equal those of the solver
    with impl="two_kernel" and fused optics bit for bit."""
    from rrtmgp_tpu_torch import AllSkyRadiation, RRTMGPParameters, lookup_tables
    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere
    from rrtmgp_tpu_torch.ops import gas_optics_kernel
    from rrtmgp_tpu_torch.states import LwBCs, SwBCs

    seen, unfused = [], []
    routed = tmod._resolve_impl  # cuda_routing's
    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: seen.append(
        kwargs.get("fused_optics", True)) or routed(*args, **kwargs))
    real = gas_optics_kernel.optics_unfused
    monkeypatch.setattr(gas_optics_kernel, "optics_unfused", lambda *a: unfused.append(1) or real(*a))
    ncol = 8
    atm = synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=np.float32, device="cpu", with_clouds=True)
    f = lambda shape, v: torch.full(shape, v)
    method = AllSkyRadiation(False)
    lookups = lookup_tables(method, dtype=torch.float32, device="cpu")
    bcs = (LwBCs(sfc_emis=f((16, ncol), 0.98)),
           SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0),
                 sfc_alb_direct=f((14, ncol), 0.2), sfc_alb_diffuse=f((14, ncol), 0.2)))
    fluxes = []
    for kw in (dict(fused_optics=False), dict(impl="two_kernel")):
        s = RRTMGPSolver(RRTMGPGridParams(nlay=NLAY, ncol=ncol), method, RRTMGPParameters(), *bcs, atm,
                         lookups=lookups, **kw)
        fluxes.append(s.update_fluxes())
    assert seen == [False, False, True, True]
    assert len(unfused) == 2
    (lw_u, sw_u), (lw_f, sw_f) = fluxes
    for a, b in zip((*lw_u, *sw_u), (*lw_f, *sw_f)):
        assert torch.equal(a, b)
