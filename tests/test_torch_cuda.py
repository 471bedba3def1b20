"""The CUDA kernels of rrtmgp_tpu_torch (ops.mega, ops.interp, ops.rte_kernels)
on the card (marker ``gpu``).

Each test skips where ``torch.cuda.is_available()`` is false. On a machine
with an NVIDIA GPU, run them without the JAX test configuration of
tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

They cover what chip_smoke.py does not: the incident-flux inputs of the
megakernels and of the sweeps, odd shapes, run-to-run
determinism, the wrappers' argument checks on CUDA tensors, the routing of
solve_lw / solve_sw (f64, several angles, the SW direct-beam solve), the
angle loop, the launch counts of solve_lw / solve_sw and
RRTMGPSolver.update_fluxes, LW two-stream on the two-kernel path, the
sweep-only route (impl="sweep"), boundary conditions of another dtype
than the state, the unfused optics (interp_pt_eta, interp_minor,
fused_optics=False: equal to the fused optics and route bit for bit),
RRTMGPSolver on a mesh of two entries on the card (equal to the unsplit
solver bit for bit), differentiable_solve_lw / _sw (kernel forward equal to the plain solve,
gradient equal to the chunked torch path, bit for bit) and the gray model
(the equilibrium's CUDA-graph blocks equal to the step-by-step loop bit for
bit; the gray solver on the card against the CPU). Tolerances as chip_smoke.py: max |kernel - twin|
/ max |twin| <= 1e-6 (Planck, aerosol_bands), 5e-5 (LW no-scattering), 1e-4
(LW two-stream, SW, their sweeps), 1e-6 (materialized optics, row-layout Planck); in f64 1e-14 (Planck) and 1e-12 (LW no-scattering: the
same operations, up to the order of the g-point sums and an ulp of exp);
the McICA cloud cover and mcica_mask_export bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rrtmgp_tpu_torch import LwBCs, SwBCs, solve_lw, solve_sw
from rrtmgp_tpu_torch.angular import angular_discretization
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu_torch.ops import interp, mega, rte_kernels
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

pytestmark = pytest.mark.gpu

TOL = {"planck_band": 1e-6, "lw_clear_mega": 5e-5, "sw_clear_mega": 1e-4, "lw2_mega": 1e-4,
       "aerosol_bands": 1e-6, "optics_fused": 1e-6, "planck_band_rows": 1e-6,
       "lw_noscat_banded_reduced": 5e-5, "sw_2stream_reduced": 1e-4,
       "lw_noscat_reduced": 5e-5, "lw_2stream_reduced": 1e-4, "sw_2stream_gpt": 1e-4, "lw_noscat_gpt": 5e-5,
       "interp_pt_eta": 1e-6, "interp_minor": 1e-6}
TOL64 = {"planck_band": 1e-14, "lw_clear_mega": 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    mega.reset_launch_counts()
    return torch.device("cuda")


def _counts() -> dict:
    """The wrappers that launched, with their counts."""
    return {k: n for k, n in mega.launch_counts().items() if n}


def _rel(out, ref) -> float:
    err = scale = 0.0
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        err = max(err, (a.double() - b.double()).abs().max().item())
        scale = max(scale, b.double().abs().max().item())
    assert scale > 0.0
    return err / scale


def _case(dev, ngpt, nbnd, ncol, nlay):
    """Kernel arguments of LW and SW at one size, with incident fluxes."""
    lw = synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=nbnd, dtype=np.float32, device=dev)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=ngpt, n_bnd=nbnd, seed=1, dtype=np.float32,
                              device=dev)
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=dev)
    rng = np.random.default_rng(5)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    plk = lambda t: mega.planck_band(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    Ds, wts = angular_discretization(1)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lay), plk(atm.t_lev),
               plk(atm.t_sfc), u(0.8, 1.0, nbnd, ncol), u(0.0, 2.0, ncol, ngpt),
               float(Ds[0]), float(wts[0]))
    toa_gpt = u(1000.0, 1400.0, ncol)[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, u(0.05, 1.0, ncol), toa_gpt.contiguous(),
               u(0.05, 0.4, nbnd, ncol), u(0.05, 0.4, nbnd, ncol), u(0.0, 2.0, ncol, ngpt))
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    return plk_args, lw_args, sw_args


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2),
                                                 (1100, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_kernels_match_twins_with_incident_flux(cuda, ngpt, nbnd, ncol, nlay):
    plk_args, lw_args, sw_args = _case(cuda, ngpt, nbnd, ncol, nlay)
    mega.reset_launch_counts()
    for a in plk_args:
        assert _rel([mega.planck_band(*a)], [mega.planck_band_ref(*a)]) <= TOL["planck_band"]
    up, dn = mega.lw_clear_mega(*lw_args)
    assert up.shape == dn.shape == (nlay + 1, ncol)
    assert _rel((up, dn), mega.lw_clear_mega_ref(*lw_args)) <= TOL["lw_clear_mega"]
    assert torch.all(dn[-1] > 0.0)  # the incident flux arrives at TOA
    out = mega.sw_clear_mega(*sw_args)
    assert _rel(out, mega.sw_clear_mega_ref(*sw_args)) <= TOL["sw_clear_mega"]
    torch.cuda.synchronize()
    assert _counts() == {"planck_band": 3, "lw_clear_mega": 1, "sw_clear_mega": 1}


def test_kernels_are_deterministic(cuda):
    _, lw_args, sw_args = _case(cuda, 64, 4, 500, 20)
    for fn, args in ((mega.lw_clear_mega, lw_args), (mega.sw_clear_mega, sw_args)):
        first, second = fn(*args), fn(*args)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    plk_args, lw_args, sw_args = _case(cuda, 8, 2, 16, 4)
    t, totplnk, t_min, t_delta = plk_args[0]
    with pytest.raises(TypeError, match="float32"):
        mega.planck_band(t.double(), totplnk, t_min, t_delta)
    with pytest.raises(ValueError, match="contiguous"):
        mega.planck_band(t.repeat(2)[::2], totplnk, t_min, t_delta)
    with pytest.raises(ValueError, match="on cpu"):
        mega.planck_band(t, totplnk.cpu(), t_min, t_delta)
    with pytest.raises(ValueError, match="shape"):
        mega.lw_clear_mega(*lw_args[:5], lw_args[5][:1], *lw_args[6:])
    with pytest.raises(ValueError, match="shape"):
        mega.sw_clear_mega(*sw_args[:2], sw_args[2][:-1], *sw_args[3:])
    with pytest.raises(ValueError, match="longwave"):
        mega.lw_clear_mega(sw_args[0], sw_args[1], *lw_args[2:])
    assert _counts() == {"planck_band": 3}


def _planck_sets(dev, dtype, sizes, nbnd=16):
    """A lookup of ``nbnd`` bands and temperature sets of ``sizes`` points
    (numpy seed 4) below the table, on every node, inside the last interval,
    on the last node, above it and uniform across and beyond it."""
    lw = synthetic_gas_lookup(longwave=True, n_gpt=2 * nbnd, n_bnd=nbnd, dtype=dtype, device=dev)
    n_t = lw.totplnk.shape[0]
    t_min, dt = float(lw.t_planck_min), float(lw.t_planck_delta)
    t_max = t_min + (n_t - 1) * dt
    edges = [t_min - 40.0, *(t_min + k * dt for k in range(n_t)), t_max - 0.5 * dt, t_max + 1e-3, t_max + 40.0]
    rng = np.random.default_rng(4)
    t = np.concatenate([edges, rng.uniform(t_min - 20.0, t_max + 20.0, max(sum(sizes) - len(edges), 0))])
    t = torch.from_numpy(t[:sum(sizes)].astype(dtype)).to(dev)
    return lw, torch.split(t, list(sizes))


PLANCK_SIZES = [(4099,), (257, 0), (1, 255, 256), (7, 4099, 33)]


@pytest.mark.parametrize("sizes", PLANCK_SIZES)
@pytest.mark.parametrize("dtype,layout", [(np.float32, "bands"), (np.float64, "bands"), (np.float32, "rows")])
def test_planck_sets_match_twins_and_one_set_calls(cuda, sizes, dtype, layout):
    """One launch over 1-3 sets of odd sizes (a set of 0 points among them)
    holds the twin (1e-6, f64 1e-14, as chip_smoke.py) and equals the
    one-set calls bit for bit."""
    lw, ts = _planck_sets(cuda, dtype, sizes)
    tab = (lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    sets, one, ref = ((mega.planck_band_sets, mega.planck_band, mega.planck_band_ref) if layout == "bands" else
                      (interp.planck_band_rows_sets, interp.planck_band_rows, interp.planck_band_rows_ref))
    out = sets(ts, *tab)
    name = "planck_band" if layout == "bands" else "planck_band_rows"
    assert _counts() == {name: 1}
    tol = TOL64["planck_band"] if dtype == np.float64 else TOL[name]
    for o, t in zip(out, ts):
        assert o.shape == ((16, t.numel()) if layout == "bands" else (t.numel(), 16)) and o.dtype == t.dtype
        if t.numel():
            assert _rel([o], [ref(t, *tab)]) <= tol
        assert torch.equal(o, one(t, *tab))
    first = out[0][0] if layout == "rows" else out[0][:, 0]
    assert torch.equal(first, lw.totplnk[0])  # below the table: the first node's values


@pytest.mark.parametrize("nbnd", [1, 3, 4, 14])
def test_planck_sets_take_any_band_count(cuda, nbnd):
    """Band counts that are not a multiple of 4 (the rows kernel then
    stores band by band) and a single band."""
    lw, ts = _planck_sets(cuda, np.float32, (300, 41), nbnd)
    tab = (lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    for sets, ref in ((mega.planck_band_sets, mega.planck_band_ref),
                      (interp.planck_band_rows_sets, interp.planck_band_rows_ref)):
        for o, t in zip(sets(ts, *tab), ts):
            assert _rel([o], [ref(t, *tab)]) <= TOL["planck_band"]


def test_planck_sets_reject_what_the_kernel_does_not_take(cuda):
    lw, ts = _planck_sets(cuda, np.float32, (10, 20))
    tab = (lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    for sets in (mega.planck_band_sets, interp.planck_band_rows_sets):
        with pytest.raises(ValueError, match="temperature sets"):
            sets((), *tab)
        with pytest.raises(ValueError, match="temperature sets"):
            sets((*ts, *ts), *tab)
        with pytest.raises(TypeError, match="float32"):
            sets((ts[0], ts[1].double()), *tab)
        with pytest.raises(ValueError, match="on cpu"):
            sets((ts[0], ts[1].cpu()), *tab)
        with pytest.raises(ValueError, match="contiguous"):
            sets((ts[0], ts[1][::2]), *tab)
        with pytest.raises(ValueError, match="totplnk"):
            sets(ts, lw.totplnk[:1], *tab[1:])
    assert _counts() == {}


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_grid_sample_yardstick_holds_the_planck_twin(cuda, dtype, tol):
    """chip_smoke.py's library yardstick of K3 / K11 on the card."""
    import chip_smoke

    lw, ts = _planck_sets(cuda, dtype, (4099, 33))
    tab = (lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    for t in ts:
        assert _rel([chip_smoke.grid_sample_bands(t, *tab)], [mega.planck_band_ref(t, *tab)]) <= tol
        if dtype == np.float32:
            assert _rel([chip_smoke.grid_sample_rows(t, *tab)], [interp.planck_band_rows_ref(t, *tab)]) <= tol


def _every_impl(cuda, ngpt):
    """Every impl (the default one too) of solve_lw (LW no-scattering at 1
    and 3 angles, LW two-stream) and solve_sw, clear and all-sky (McICA by
    seed, aerosols), at ``ngpt`` g-points against impl="torch"."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    ncol, nlay = 6, 5
    small = dict(n_eta=3, n_press=4, n_temp=3, dtype=np.float32, device=cuda)
    lw = synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=4, **small)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=ngpt, n_bnd=4, seed=1, **small)
    clear = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    cloudy = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda, with_clouds=True,
                                  with_aerosols=True)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((4, ncol), 0.98))
    bs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((4, ncol), 0.2),
               sfc_alb_diffuse=f((4, ncol), 0.2))
    sky = lambda seed: dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                            lkp_aero=synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                            cld_mask_seed=seed)
    cases = ((solve_lw, lw, bl, dict(), TOL["lw_clear_mega"]),
             (solve_lw, lw, bl, dict(n_gauss_angles=3), TOL["lw_noscat_banded_reduced"]),
             (solve_lw, lw, bl, dict(two_stream=True), TOL["lw2_mega"]),
             (solve_sw, sw, bs, dict(), TOL["sw_clear_mega"]))
    for atm, kw_lw, kw_sw in ((clear, {}, {}), (cloudy, sky(5), sky(6))):
        for solve, lkp, b, kw, tol in cases:
            extra = kw_lw if solve is solve_lw else kw_sw
            exact, d_exact = solve(lkp, atm, b, impl="torch", **kw, **extra)
            for impl in ("kernel", "two_kernel", "sweep", None):
                mega.reset_launch_counts()
                out, d_out = solve(lkp, atm, b, impl=impl, **kw, **extra)
                assert _counts(), (impl, kw)  # the kernels ran
                assert _rel(out, exact) <= tol, (solve.__name__, impl, kw)
                if extra:
                    assert torch.equal(d_out.cld_cover, d_exact.cld_cover)


def test_more_than_1024_gpoints_run_on_every_impl(cuda):
    """A lookup of more g-points than a block has threads raises nowhere:
    every impl (the default one too) runs it, a column's g-points over
    several blocks, and agrees with impl="torch", LW no-scattering (1 and 3
    angles), LW two-stream and SW, clear and all-sky (McICA by seed,
    aerosols); boundary conditions with other strides than the kernels take
    are made contiguous by the solves."""
    _every_impl(cuda, 1100)
    lkp = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float32, device=cuda)
    emis = torch.rand((4, 4), device=cuda) * 0.1 + 0.9
    strided = LwBCs(sfc_emis=emis.T.contiguous().T)
    assert not strided.sfc_emis.is_contiguous()
    mega.reset_launch_counts()
    for n in (1, 2):
        a, _ = solve_lw(lkp, atm, strided, n_gauss_angles=n)
        b, _ = solve_lw(lkp, atm, LwBCs(sfc_emis=emis), n_gauss_angles=n)
        assert torch.equal(a.flux_up, b.flux_up)
    assert _counts() == {"planck_band": 2, "lw_clear_mega": 2, "optics_fused": 2, "planck_band_rows": 2,
                         "lw_noscat_banded_reduced": 2}


def test_1000_gpoints_run_on_every_impl(cuda):
    """1000 g-points fit a block of 1024 threads but not the block of a
    kernel whose registers allow fewer (lw2_mega, sw_clear_mega all-sky
    seeded): each wrapper plans with its kernel's maxThreadsPerBlock, so
    every impl runs and agrees with impl="torch"; every plan holds its
    kernel's limit."""
    from rrtmgp_tpu_torch.ops._launch import LAST_PLANS

    LAST_PLANS.clear()
    _every_impl(cuda, 1000)
    assert {"lw2_mega", "sw_clear_mega", "lw_clear_mega", "lw_2stream_reduced"} <= set(LAST_PLANS)
    for name, (plan, most) in LAST_PLANS.items():
        assert 32 <= plan.group <= most <= 1024 and plan.n_groups * plan.group >= 1000, name
        assert plan.n_groups == -(-1000 // (most // 32 * 32)), name


@pytest.mark.parametrize("ngpt,nlay", [(40, 60), (256, 800)])
def test_megakernels_at_sixty_and_800_layers(cuda, ngpt, nlay):
    """lw2_mega and sw_clear_mega at 60 layers and at 800 with 256 g-points
    (the in-block level sums, LW 2 x 801 x 8 and SW 3 x 801 x 8 floats, past
    the 48 KB of shared memory a block gets without asking), clear and with
    McICA by seed + aerosols, against their twins and run to run; the cloud
    cover bit for bit."""
    lw, sw, atm, cld, aero, lw_args, sw_args, masks = _allsky_case(cuda, ngpt, 4, 16, nlay)
    for (fn, ref, args, tol), lkp, c, a, m, delta in (
        ((mega.lw2_mega, mega.lw2_mega_ref, lw_args, TOL["lw2_mega"]), lw, cld[0], aero[0], masks[0], False),
        ((mega.sw_clear_mega, mega.sw_clear_mega_ref, sw_args, TOL["sw_clear_mega"]), sw, cld[1], aero[1],
         masks[1], True),
    ):
        for comp in (mega.CLEAR, *_compositions(lkp, atm, c, a, m, delta)):
            out, want = fn(*args, comp), ref(*args, comp)
            if comp.seeded:
                assert torch.equal(out[-1], want[-1])
                out, want = out[:-1], want[:-1]
            assert out[0].shape == (nlay + 1, 16)
            assert _rel(out, want) <= tol
            again = fn(*args, comp)
            assert all(torch.equal(x, y) for x, y in zip(out, again))


@pytest.mark.parametrize("ngpt,nbnd,nlay", [(224, 14, 2800), (256, 16, 3700)])
def test_deep_columns_keep_their_level_sums_in_device_memory(cuda, ngpt, nbnd, nlay):
    """Columns too deep for their in-block level sums (SW 3 x 2801 x 7 warps,
    LW 2 x 3701 x 8 warps of floats, each past the 227 KB a block can opt in
    to): the launch plan keeps one block per column and completes the sums
    in device memory, and every kernel with level sums holds its twin: K2
    and K15 at 224 g-points x 2800 layers; K1, K4, K12, K13 and K14 at 256 x
    3700."""
    from rrtmgp_tpu_torch.ops._launch import gpoint_plan, smem_limit

    ncol = 3
    _, lw_args, sw_args = _case(cuda, ngpt, nbnd, ncol, nlay)
    fields = 3 if ngpt == 224 else 2
    plan = gpoint_plan(ngpt, nlay, fields, 4, mega.BLOCK_COUNT_BYTES, smem_limit(cuda))
    assert plan.n_groups == 1 and not plan.in_block
    if ngpt == 224:
        _, _, _, _, k15 = _two_kernel_case(cuda, ngpt, nbnd, ncol, nlay)
        cases = ((mega.sw_clear_mega, mega.sw_clear_mega_ref, sw_args, TOL["sw_clear_mega"]),
                 (rte_kernels.sw_2stream_reduced, rte_kernels.sw_2stream_reduced_ref, k15,
                  TOL["sw_2stream_reduced"]))
    else:
        inp, tabs, _, plk_lev, plk_sfc, emis, inc = lw_args[:7]
        k13, k14, _, _, _ = _sweep_case(cuda, ngpt, nbnd, ncol, nlay)
        k12 = _two_kernel_case(cuda, ngpt, nbnd, ncol, nlay)[3]
        cases = ((mega.lw_clear_mega, mega.lw_clear_mega_ref, lw_args, TOL["lw_clear_mega"]),
                 (mega.lw2_mega, mega.lw2_mega_ref, (inp, tabs, plk_lev, plk_sfc, emis, inc), TOL["lw2_mega"]),
                 (rte_kernels.lw_noscat_banded_reduced, rte_kernels.lw_noscat_banded_reduced_ref, k12,
                  TOL["lw_noscat_banded_reduced"]),
                 (rte_kernels.lw_noscat_reduced, rte_kernels.lw_noscat_reduced_ref, k13, TOL["lw_noscat_reduced"]),
                 (rte_kernels.lw_2stream_reduced, rte_kernels.lw_2stream_reduced_ref, k14,
                  TOL["lw_2stream_reduced"]))
    mega.reset_launch_counts()
    for fn, ref, args, tol in cases:
        out = fn(*args)
        assert out[0].shape == (nlay + 1, ncol), fn.__name__
        assert _rel(out, ref(*args)) <= tol, fn.__name__
    torch.cuda.synchronize()
    assert _counts() == {fn.__name__: 1 for fn, *_ in cases}


def test_solves_on_cuda_take_the_kernels(cuda):
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=1, dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=300, nlay=12, dtype=np.float32, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((4, 300), 0.98))
    mu0 = f((300,), 0.6)
    mu0[::3] = -0.1
    bs = SwBCs(cos_zenith=mu0, toa_flux=f((300,), 1361.0),
               sfc_alb_direct=f((4, 300), 0.2), sfc_alb_diffuse=f((4, 300), 0.2))
    k_lw, _ = solve_lw(lw, atm, bl)
    k_sw, _ = solve_sw(sw, atm, bs)
    assert _counts() == {"planck_band": 1, "lw_clear_mega": 1, "sw_clear_mega": 1}
    t_lw, _ = solve_lw(lw, atm, bl, impl="torch")
    t_sw, _ = solve_sw(sw, atm, bs, impl="torch")
    assert mega.launch_counts()["lw_clear_mega"] == 1
    assert _rel(k_lw, t_lw) <= TOL["lw_clear_mega"]
    assert _rel(k_sw, t_sw) <= TOL["sw_clear_mega"]
    for flux in k_sw:
        assert torch.all(flux[:, mu0 <= 0] == 0.0)
    # several angles: the megakernel path launches once per angle, the band
    # Planck values shared; the default is the two-kernel path, which computes
    # the optics once and sweeps every angle in one launch
    for n in (2, 3, 4):
        t_n = solve_lw(lw, atm, bl, n_gauss_angles=n, impl="torch")[0]
        mega.reset_launch_counts()
        k_n, _ = solve_lw(lw, atm, bl, n_gauss_angles=n, impl="kernel")
        assert _counts() == {"planck_band": 1, "lw_clear_mega": n}
        assert _rel(k_n, t_n) <= TOL["lw_clear_mega"]
        mega.reset_launch_counts()
        d_n, _ = solve_lw(lw, atm, bl, n_gauss_angles=n)
        assert _counts() == {"optics_fused": 1, "planck_band_rows": 1, "lw_noscat_banded_reduced": 1}
        assert _rel(d_n, t_n) <= TOL["lw_noscat_banded_reduced"]
        assert _rel(d_n, k_n) <= TOL["lw_noscat_banded_reduced"]
    # f64 clear-sky LW no-scattering has a kernel, LW two-stream has none
    lw64, atm64 = lw.to(dtype=torch.float64), atm.to(dtype=torch.float64)
    bl64 = dataclasses.replace(bl, sfc_emis=bl.sfc_emis.double())
    mega.reset_launch_counts()
    k64, _ = solve_lw(lw64, atm64, bl64, impl="kernel")
    assert _counts() == {"planck_band": 1, "lw_clear_mega": 1} and k64.flux_up.dtype == torch.float64
    assert _rel(k64, solve_lw(lw64, atm64, bl64, impl="torch")[0]) <= TOL64["lw_clear_mega"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_lw(lw64, atm64, bl64, two_stream=True, impl="kernel")


def test_f64_routing(cuda):
    """impl=None on f64 CUDA tensors: clear-sky LW no-scattering without
    aerosols takes the f64 kernel (1-4 angles, with or without incident
    flux); with aerosols, two-stream, or SW, the torch path with a warning;
    impl='kernel' raises where f64 has no kernel."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup

    ncol = 40
    lw = synthetic_gas_lookup(longwave=True, n_gpt=16, n_bnd=2, dtype=np.float64, device=cuda)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=16, n_bnd=2, seed=1, dtype=np.float64, device=cuda)
    atm = synthetic_atmosphere(ncol=ncol, nlay=8, dtype=np.float64, device=cuda, with_aerosols=True)
    rng = np.random.default_rng(2)
    mass = torch.from_numpy(rng.uniform(0.0, 2e-5, (15, 8, ncol))).to(cuda)
    atm = dataclasses.replace(atm, aerosol_state=dataclasses.replace(atm.aerosol_state, aero_mass=mass))
    aero = synthetic_aerosol_lookup(n_bnd=2, dtype=np.float64, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float64, device=cuda)
    bl = LwBCs(sfc_emis=f((2, ncol), 0.98))
    bl_inc = dataclasses.replace(bl, inc_flux=torch.from_numpy(rng.uniform(0.0, 2.0, (ncol, 16))).to(cuda))
    bs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((2, ncol), 0.2), sfc_alb_diffuse=f((2, ncol), 0.2))
    for bcs, n in ((bl, 1), (bl_inc, 3)):
        mega.reset_launch_counts()
        k_lw, _ = solve_lw(lw, atm, bcs, n_gauss_angles=n)
        assert _counts() == {"planck_band": 1, "lw_clear_mega": n}
        t_lw, _ = solve_lw(lw, atm, bcs, n_gauss_angles=n, impl="torch")
        assert k_lw.flux_up.dtype == torch.float64 and _rel(k_lw, t_lw) <= TOL64["lw_clear_mega"]
    mega.reset_launch_counts()
    with pytest.warns(UserWarning, match="f64 CUDA kernel"):
        a_lw, _ = solve_lw(lw, atm, bl, lkp_aero=aero)
    with pytest.warns(UserWarning, match="f64 CUDA kernel"):
        k_lw2, _ = solve_lw(lw, atm, bl, two_stream=True)
    with pytest.warns(UserWarning, match="f64 CUDA kernel"):
        k_sw, _ = solve_sw(sw, atm, bs)
    assert _counts() == {}
    # the aerosols are kept: the fluxes differ from the aerosol-free ones
    assert not torch.equal(a_lw.flux_up, solve_lw(lw, atm, bl, impl="torch")[0].flux_up)
    for a, b in zip((*a_lw, *k_lw2, *k_sw), (*solve_lw(lw, atm, bl, lkp_aero=aero, impl="torch")[0],
                                             *solve_lw(lw, atm, bl, two_stream=True, impl="torch")[0],
                                             *solve_sw(sw, atm, bs, impl="torch")[0])):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    for call in (lambda: solve_sw(sw, atm, bs, impl="kernel"),
                 lambda: solve_lw(lw, atm, bl, two_stream=True, impl="kernel"),
                 lambda: solve_lw(lw, atm, bl, lkp_aero=aero, impl="kernel")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2)])
def test_f64_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay):
    """planck_band and lw_clear_mega built for f64 against their f64 twins
    (any n_gpt, not only powers of two), and against the f32 kernels."""
    plk_args, lw_args, _ = _case(cuda, ngpt, nbnd, ncol, nlay)
    lw64 = synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=nbnd, dtype=np.float64, device=cuda)
    atm64 = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float64, device=cuda)
    plk64 = [(t.reshape(-1), lw64.totplnk, lw64.t_planck_min, lw64.t_planck_delta)
             for t in (atm64.t_lay, atm64.t_lev, atm64.t_sfc)]
    mega.reset_launch_counts()
    planck = [mega.planck_band(*a) for a in plk64]
    for out, a in zip(planck, plk64):
        assert out.dtype == torch.float64
        assert _rel([out], [mega.planck_band_ref(*a)]) <= TOL64["planck_band"]
    args64 = (mega_lw_inputs(lw64, atm64), lw64.kernel_tables, *planck, lw_args[5].double(),
              lw_args[6].double(), *lw_args[7:])
    up, dn = mega.lw_clear_mega(*args64)
    assert up.dtype == torch.float64 and up.shape == (nlay + 1, ncol)
    assert _rel((up, dn), mega.lw_clear_mega_ref(*args64)) <= TOL64["lw_clear_mega"]
    assert _counts() == {"planck_band": 3, "lw_clear_mega": 1}
    # f32 against f64: the f32 algorithm's own error (its Clough factor cancels in thin layers)
    assert _rel(mega.lw_clear_mega(*lw_args), (up, dn)) <= 1e-4
    again = mega.lw_clear_mega(*args64)
    assert torch.equal(again[0], up) and torch.equal(again[1], dn)


def _allsky_case(dev, ngpt, nbnd, ncol, nlay):
    """All-sky kernel arguments at one size: LW two-stream (with an incident
    flux) and SW inputs, cloud and aerosol lookups, fractional cloud
    fraction, and a McICA mask drawn by the torch twin."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica

    lw = synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=nbnd, dtype=np.float32, device=dev)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=ngpt, n_bnd=nbnd, seed=1, dtype=np.float32, device=dev)
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=dev,
                               with_clouds=True, with_aerosols=True)
    rng = np.random.default_rng(6)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    cs = atm.cloud_state
    mass = u(0.0, 2e-5, 15, nlay, ncol) * (u(0.0, 1.0, 15, nlay, ncol) > 0.3)
    # aerosols in every layer (the synthetic ones sit below 800 hPa only)
    atm = dataclasses.replace(
        atm, cloud_state=dataclasses.replace(cs, cld_frac=(cs.cld_frac * u(0.2, 1.0, nlay, ncol)).contiguous()),
        aerosol_state=dataclasses.replace(atm.aerosol_state, aero_mass=mass.contiguous(),
                                          aero_size=u(0.05, 12.0, 15, nlay, ncol)),
    )
    kw = dict(n_bnd=nbnd, dtype=np.float32, device=dev)
    cld = (synthetic_cloud_lookup(**kw), synthetic_cloud_lookup(seed=5, **kw))
    aero = (synthetic_aerosol_lookup(**kw), synthetic_aerosol_lookup(seed=6, **kw))
    plk = lambda t: mega.planck_band(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lev), plk(atm.t_sfc),
               u(0.8, 1.0, nbnd, ncol), u(0.0, 2.0, ncol, ngpt))
    toa_gpt = u(1000.0, 1400.0, ncol)[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, u(0.05, 1.0, ncol), toa_gpt.contiguous(),
               u(0.05, 0.4, nbnd, ncol), u(0.05, 0.4, nbnd, ncol), u(0.0, 2.0, ncol, ngpt))
    masks = [build_cloud_mask_mcica(atm.cloud_state.cld_frac, ngpt, 9, 100) for _ in (lw, sw)]
    return lw, sw, atm, cld, aero, lw_args, sw_args, masks


def _compositions(lkp, atm, cld, aero, mask, delta):
    """(cloud mask, seed + aerosols) Compositions as the solves build them."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    make = lambda a, m, s: _kernel_composition(lkp, atm, cld, a, m, s, 100, None, delta, False)[0]
    return make(None, mask, None), make(aero, None, 9)


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 12), (5, 5, 3, 4),
                                                 (1100, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_allsky_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay):
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    lw, sw, atm, cld, aero, lw_args, sw_args, masks = _allsky_case(cuda, ngpt, nbnd, ncol, nlay)
    mega.reset_launch_counts()
    for (fn, ref, args, tol), lkp, c, a, m, delta in (
        ((mega.lw2_mega, mega.lw2_mega_ref, lw_args, TOL["lw2_mega"]), lw, cld[0], aero[0], masks[0], False),
        ((mega.sw_clear_mega, mega.sw_clear_mega_ref, sw_args, TOL["sw_clear_mega"]), sw, cld[1], aero[1],
         masks[1], True),
    ):
        for comp in (mega.CLEAR, *_compositions(lkp, atm, c, a, m, delta)):
            out, want = fn(*args, comp), ref(*args, comp)
            if comp.seeded:
                assert torch.equal(out[-1], want[-1])  # McICA cloud cover
                out, want = out[:-1], want[:-1]
            assert out[0].shape == (nlay + 1, ncol)
            assert _rel(out, want) <= tol
    for lkp in aero:
        a = (lkp, atm.aerosol_state, atm.rel_hum)
        assert _rel(ab.aerosol_bands(*a), ab.aerosol_bands_ref(*a)) <= TOL["aerosol_bands"]
    cf = atm.cloud_state.cld_frac
    for off in (0, 384):
        u, m = mega.mcica_mask_export(cf, 9, off, ngpt)
        u_ref, m_ref = mega.mcica_mask_export_ref(cf, 9, off, ngpt)
        assert u.shape == (nlay, ncol, ngpt) and torch.equal(u, u_ref) and torch.equal(m, m_ref)
    torch.cuda.synchronize()
    # aerosol_bands: 2 here, 2 in the seeded compositions
    assert _counts() == {"lw2_mega": 3, "sw_clear_mega": 3, "aerosol_bands": 4, "mcica_mask_export": 2}


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 12), (5, 5, 3, 4),
                                                 (1100, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_lw_noscat_composed_matches_twin(cuda, ngpt, nbnd, ncol, nlay):
    """lw_clear_mega with a cloud mask, McICA seed + aerosols, and aerosols
    alone against its twin; seed mode equals the exported-mask mode and its
    cover the twin's, bit for bit; f64 composition raises."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    lw, _, atm, cld, aero, lw2_args, _, masks = _allsky_case(cuda, ngpt, nbnd, ncol, nlay)
    inp, tabs, plk_lev, plk_sfc, emis, inc = lw2_args
    plk_lay = mega.planck_band(atm.t_lay.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    Ds, wts = angular_discretization(2)
    args = (inp, tabs, plk_lay, plk_lev, plk_sfc, emis, inc, float(Ds[1]), float(wts[1]))
    by_mask, seeded = _compositions(lw, atm, cld[0], aero[0], masks[0], False)
    aero_only = _kernel_composition(lw, atm, None, aero[0], None, None, 0, None, False, False)[0]
    clear = mega.lw_clear_mega(*args)
    mega.reset_launch_counts()
    for comp in (by_mask, seeded, aero_only):
        out, want = mega.lw_clear_mega(*args, comp), mega.lw_clear_mega_ref(*args, comp)
        assert len(out) == (3 if comp.seeded else 2)
        if comp.seeded:
            assert out[2].dtype == torch.float32 and torch.equal(out[2], want[2])
        assert _rel(out[:2], want[:2]) <= TOL["lw_clear_mega"]
        assert ncol < 100 or not torch.equal(out[0], clear[0])
        again = mega.lw_clear_mega(*args, comp)
        assert all(torch.equal(x, y) for x, y in zip(out, again))
    assert _counts() == {"lw_clear_mega": 6}
    # seed mode against the same mask handed in
    exported = mega.mcica_mask_export(atm.cloud_state.cld_frac, 9, 100, ngpt)[1].bool()
    given = seeded._replace(cld_mask=exported, cld_frac=None, seed=None)
    for x, y in zip(mega.lw_clear_mega(*args, seeded)[:2], mega.lw_clear_mega(*args, given)):
        assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mega.lw_clear_mega(mega_lw_inputs(lw.to(dtype=torch.float64), atm.to(dtype=torch.float64)),
                           lw.to(dtype=torch.float64).kernel_tables,
                           *(x.double() for x in (plk_lay, plk_lev, plk_sfc, emis, inc)),
                           float(Ds[1]), float(wts[1]), by_mask)


def test_allsky_noscat_solver_takes_the_kernels(cuda):
    """RRTMGPSolver with two_stream_lw=False under clouds and aerosols runs
    LW through lw_clear_mega (one launch per angle), not lw2_mega, and
    agrees with the torch path; chunked equals unchunked bit for bit."""
    from rrtmgp_tpu_torch import AllSkyRadiation, RRTMGPGridParams, RRTMGPParameters, RRTMGPSolver
    from rrtmgp_tpu_torch.models.rrtmgp import solve_chunked

    ncol, nlay = 300, 12
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                               with_clouds=True, with_aerosols=True)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((16, ncol), 0.98))
    bs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((14, ncol), 0.2), sfc_alb_diffuse=f((14, ncol), 0.2))
    grid = RRTMGPGridParams(nlay=nlay, ncol=ncol)
    for n in (1, 3):
        mk = lambda **kw: RRTMGPSolver(grid, AllSkyRadiation(aerosol_radiation=True), RRTMGPParameters(),
                                       bl, bs, atm, two_stream_lw=False, n_gauss_angles=n, **kw)
        solver, ref = mk(impl="kernel"), mk(impl="torch")
        mega.reset_launch_counts()
        f_lw, f_sw = solver.update_fluxes()
        torch.cuda.synchronize()
        assert _counts() == {"planck_band": 1, "lw_clear_mega": n, "sw_clear_mega": 1, "aerosol_bands": 2}
        if n > 1:
            # the default routing: LW leaves the megakernel for the two-kernel
            # path (mask from the export kernel, aerosol band sums from their
            # kernel, composition in plain torch)
            auto = mk()
            mega.reset_launch_counts()
            a_lw, _ = auto.update_fluxes()
            assert _counts() == {"optics_fused": 1, "planck_band_rows": 1, "lw_noscat_banded_reduced": 1,
                                 "mcica_mask_export": 1, "sw_clear_mega": 1, "aerosol_bands": 2}
            assert _rel(a_lw, f_lw) <= TOL["lw_noscat_banded_reduced"]
            assert torch.equal(auto.lw_cloud_cover(), solver.lw_cloud_cover())
        t_lw, _ = ref.update_fluxes()
        assert _rel(f_lw, t_lw) <= TOL["lw_clear_mega"]
        assert torch.equal(solver.lw_cloud_cover(), ref.lw_cloud_cover())
        L = solver.lookups
        one = lambda a, b, s, off: solve_lw(L.lookup_lw, a, b, n_gauss_angles=n, lkp_cld=L.lookup_lw_cld,
                                            lkp_aero=L.lookup_lw_aero, cld_mask_seed=s, col_offset=off,
                                            impl="kernel")
        c_lw, c_diag = solve_chunked(one, atm, bl, 128, cld_mask_seed=solver._mcica_key(0))
        assert all(torch.equal(x, y) for x, y in zip(c_lw, f_lw))
        assert torch.equal(c_diag.cld_cover, solver.lw_cloud_cover())


def test_allsky_kernels_are_deterministic(cuda):
    lw, sw, atm, cld, aero, lw_args, sw_args, masks = _allsky_case(cuda, 64, 4, 500, 20)
    for fn, args, lkp, c, a, m, delta in ((mega.lw2_mega, lw_args, lw, cld[0], aero[0], masks[0], False),
                                          (mega.sw_clear_mega, sw_args, sw, cld[1], aero[1], masks[1], True)):
        for comp in _compositions(lkp, atm, c, a, m, delta):
            for x, y in zip(fn(*args, comp), fn(*args, comp)):
                assert torch.equal(x, y)


def test_allsky_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    lw, sw, atm, cld, aero, lw_args, sw_args, masks = _allsky_case(cuda, 8, 2, 16, 4)
    by_mask, seeded = _compositions(lw, atm, cld[0], aero[0], masks[0], False)
    mega.reset_launch_counts()
    bad = lambda **kw: seeded._replace(**kw)
    with pytest.raises(ValueError, match="shape"):
        mega.lw2_mega(*lw_args, bad(cld_bands=tuple(x[:, :-1] for x in seeded.cld_bands)))
    with pytest.raises(TypeError, match="bool"):
        mega.lw2_mega(*lw_args, by_mask._replace(cld_mask=by_mask.cld_mask.float()))
    with pytest.raises(ValueError, match="seed"):
        mega.lw2_mega(*lw_args, bad(seed=None))
    with pytest.raises(ValueError, match="exactly one"):
        mega.lw2_mega(*lw_args, bad(cld_mask=masks[0]))
    with pytest.raises(ValueError, match="shape"):
        mega.sw_clear_mega(*sw_args, bad(aero_mask=seeded.aero_mask[:, :-1].contiguous()))
    with pytest.raises(ValueError, match="non-negative"):
        mega.lw2_mega(*lw_args, bad(seed=-1))
    with pytest.raises(TypeError, match="float32"):
        ab.aerosol_bands(aero[0], atm.aerosol_state, atm.rel_hum.double())
    with pytest.raises(ValueError, match="species index"):
        ab.aerosol_bands(aero[0], atm.aerosol_state, atm.rel_hum, (0, 15))
    with pytest.raises(ValueError, match="n_gpt"):
        mega.mcica_mask_export(atm.cloud_state.cld_frac, 1, 0, 0)
    assert _counts() == {}


def test_solver_update_fluxes_takes_the_kernels(cuda):
    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        AllSkyRadiationWithClearSkyDiagnostics,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
    )

    ncol, nlay = 300, 12
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                               with_clouds=True, with_aerosols=True)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((16, ncol), 0.98))
    bs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((14, ncol), 0.2), sfc_alb_diffuse=f((14, ncol), 0.2))
    grid = RRTMGPGridParams(nlay=nlay, ncol=ncol)
    for method, n in ((AllSkyRadiation(aerosol_radiation=True), 1),
                      (AllSkyRadiationWithClearSkyDiagnostics(aerosol_radiation=True), 2)):
        solver = RRTMGPSolver(grid, method, RRTMGPParameters(), bl, bs, atm)
        mega.reset_launch_counts()
        f_lw, f_sw = solver.update_fluxes()
        torch.cuda.synchronize()
        # LW two-stream needs Planck at t_lev and t_sfc only, in one launch
        assert _counts() == {"planck_band": n, "lw2_mega": n, "sw_clear_mega": n, "aerosol_bands": 2 * n}
        assert all(torch.isfinite(x).all() for x in (*f_lw, *f_sw))
        assert solver.lw_cloud_cover().shape == solver.sw_cloud_cover().shape == (ncol,)


@pytest.mark.parametrize("method", ["clear", "allsky"])
def test_solver_on_a_mesh_of_two_on_one_card(cuda, method):
    """RRTMGPSolver(mesh=...) with two entries on the one card (clear: LW
    no-scattering; all-sky: LW two-stream, McICA by seed on a fractional
    cloud fraction, aerosols) launches each kernel once per entry and equals
    the unsplit solver bit for bit, fluxes and cloud cover."""
    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        ClearSkyRadiation,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
    )
    from rrtmgp_tpu_torch.parallel.sharding import make_column_mesh

    ncol, nlay = 300, 12
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                               with_clouds=True, with_aerosols=True)
    cs = atm.cloud_state
    atm = dataclasses.replace(atm, cloud_state=dataclasses.replace(cs, cld_frac=(cs.cld_frac * 0.6).contiguous()))
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((16, ncol), 0.98))
    bs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((14, ncol), 0.2), sfc_alb_diffuse=f((14, ncol), 0.2))
    allsky = method == "allsky"
    m = AllSkyRadiation(aerosol_radiation=True) if allsky else ClearSkyRadiation()
    mk = lambda **kw: RRTMGPSolver(RRTMGPGridParams(nlay=nlay, ncol=ncol), m, RRTMGPParameters(), bl, bs, atm,
                                   two_stream_lw=allsky, **kw)
    whole, split = mk(), mk(mesh=make_column_mesh([cuda, cuda]))
    f_whole = whole.update_fluxes()
    mega.reset_launch_counts()
    f_split = split.update_fluxes()
    torch.cuda.synchronize()
    if allsky:
        assert _counts() == {"planck_band": 2, "lw2_mega": 2, "sw_clear_mega": 2, "aerosol_bands": 4}
    else:
        assert _counts() == {"planck_band": 2, "lw_clear_mega": 2, "sw_clear_mega": 2}
    for a, b in zip(f_whole, f_split):
        for name in a._fields:
            assert np.array_equal(getattr(a, name).cpu().numpy(), np.asarray(getattr(b, name))), name
    if allsky:
        for name in ("lw_cloud_cover", "sw_cloud_cover"):
            cover = getattr(whole, name)().cpu().numpy()
            assert np.array_equal(cover, np.asarray(getattr(split, name)())), name
            assert 0.0 < cover.mean() < 1.0


# ---------------------------------------------------------------------------
# The two-kernel path: materialized optics, row-layout Planck, the sweeps
# ---------------------------------------------------------------------------


def _two_kernel_case(dev, ngpt, nbnd, ncol, nlay):
    """Arguments of the four kernels of the two-kernel path at one size, the
    sweeps' optics taken from the optics kernel, with incident fluxes and a
    random asymmetry."""
    _, lw_args, sw_args = _case(dev, ngpt, nbnd, ncol, nlay)
    lw = lw_args[1].lkp
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=dev)
    rng = np.random.default_rng(8)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    tau, pfrac = interp.optics_fused(*lw_args[:2])
    plk = [interp.planck_band_rows(*a) for a in plk_args]
    Ds, wts = angular_discretization(2)
    k12 = (tau, pfrac, plk[0].reshape(nlay, ncol, nbnd), plk[1].reshape(nlay + 1, ncol, nbnd), plk[2],
           lw_args[5], lw_args[1].gpt2band, float(Ds[1]), float(wts[1]), lw_args[6])
    tau_sw, ssa = interp.optics_fused(*sw_args[:2])
    k15 = (tau_sw, ssa, u(0.0, 0.8, nlay, ncol, ngpt), *sw_args[2:6], sw_args[1].gpt2band, sw_args[6])
    return lw_args[:2], sw_args[:2], plk_args, k12, k15


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2),
                                                 (1100, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_two_kernel_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay):
    """optics_fused (LW and SW), planck_band_rows, lw_noscat_banded_reduced
    (with and without incident flux) and sw_2stream_reduced (with and without
    asymmetry and incident flux) against their twins."""
    lw_in, sw_in, plk_args, k12, k15 = _two_kernel_case(cuda, ngpt, nbnd, ncol, nlay)
    mega.reset_launch_counts()
    for args in (lw_in, sw_in):
        out = interp.optics_fused(*args)
        assert out[0].shape == out[1].shape == (nlay, ncol, ngpt)
        for o, r in zip(out, interp.optics_fused_ref(*args)):
            assert _rel([o], [r]) <= TOL["optics_fused"]
        assert float(out[0].min()) >= 0.0
    for a in plk_args:
        out = interp.planck_band_rows(*a)
        assert out.shape == (a[0].numel(), nbnd)
        assert _rel([out], [interp.planck_band_rows_ref(*a)]) <= TOL["planck_band_rows"]
        assert torch.equal(out.T, mega.planck_band(*a))
    for args in (k12, (*k12[:-1], None)):
        up, dn = rte_kernels.lw_noscat_banded_reduced(*args)
        assert up.shape == dn.shape == (nlay + 1, ncol)
        assert _rel((up, dn), rte_kernels.lw_noscat_banded_reduced_ref(*args)) <= TOL["lw_noscat_banded_reduced"]
        assert torch.all(dn[-1] > 0.0) if args[-1] is not None else torch.all(dn[-1] == 0.0)
    for args in (k15, (*k15[:2], None, *k15[3:]), (*k15[:-1], None)):
        out = rte_kernels.sw_2stream_reduced(*args)
        assert out[0].shape == (nlay + 1, ncol)
        assert _rel(out, rte_kernels.sw_2stream_reduced_ref(*args)) <= TOL["sw_2stream_reduced"]
    torch.cuda.synchronize()
    assert _counts() == {"optics_fused": 2, "planck_band_rows": 3, "planck_band": 3,
                         "lw_noscat_banded_reduced": 2, "sw_2stream_reduced": 3}


def test_two_kernel_sweeps_equal_the_megakernels_on_equal_optics(cuda):
    """On the optics of the optics kernel the sweeps reproduce the
    megakernels: the SW sweep bit for bit (shared device code, equal
    optics; one block per column in both, and at 1100 g-points both over
    several blocks), the LW
    sweep to rounding (the megakernel stores the upward source, the sweep
    recomputes it)."""
    _, lw_args, sw_args = _case(cuda, 64, 4, 500, 20)
    lw_in, sw_in, _, k12, k15 = _two_kernel_case(cuda, 64, 4, 500, 20)
    clear = rte_kernels.sw_2stream_reduced(*k15[:2], None, *k15[3:])
    for a, b in zip(clear, mega.sw_clear_mega(*sw_args)):
        assert torch.equal(a, b)
    _, _, sw_big = _case(cuda, 1100, 4, 7, 5)
    _, _, _, _, k15_big = _two_kernel_case(cuda, 1100, 4, 7, 5)
    for a, b in zip(rte_kernels.sw_2stream_reduced(*k15_big[:2], None, *k15_big[3:]), mega.sw_clear_mega(*sw_big)):
        assert torch.equal(a, b)
    Ds, wts = angular_discretization(2)
    want = mega.lw_clear_mega(*lw_args[:7], float(Ds[1]), float(wts[1]))
    assert _rel(rte_kernels.lw_noscat_banded_reduced(*k12), want) <= 1e-6


def test_two_kernel_kernels_are_deterministic(cuda):
    lw_in, sw_in, plk_args, k12, k15 = _two_kernel_case(cuda, 64, 4, 500, 20)
    for fn, args in ((interp.optics_fused, lw_in), (interp.optics_fused, sw_in),
                     (rte_kernels.lw_noscat_banded_reduced, k12), (rte_kernels.sw_2stream_reduced, k15)):
        for a, b in zip(fn(*args), fn(*args)):
            assert torch.equal(a, b)


def test_two_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    lw_in, sw_in, plk_args, k12, k15 = _two_kernel_case(cuda, 8, 2, 16, 4)
    mega.reset_launch_counts()
    t, totplnk, t_min, t_delta = plk_args[0]
    with pytest.raises(TypeError, match="float32"):
        interp.planck_band_rows(t.double(), totplnk, t_min, t_delta)
    with pytest.raises(ValueError, match="contiguous"):
        interp.planck_band_rows(t.repeat(2)[::2], totplnk, t_min, t_delta)
    with pytest.raises(TypeError, match="float32"):
        interp.optics_fused(lw_in[0].to(dtype=torch.float64), lw_in[1])
    with pytest.raises((TypeError, ValueError)):
        interp.optics_fused(lw_in[0], sw_in[1])  # longwave inputs with a shortwave lookup
    with pytest.raises(ValueError, match="shape"):
        rte_kernels.lw_noscat_banded_reduced(k12[0], k12[1][:, :-1].contiguous(), *k12[2:])
    with pytest.raises(TypeError, match="int32"):
        rte_kernels.lw_noscat_banded_reduced(*k12[:6], k12[6].long(), *k12[7:])
    with pytest.raises(ValueError, match="on cpu"):
        rte_kernels.lw_noscat_banded_reduced(*k12[:-1], k12[-1].cpu())
    with pytest.raises(ValueError, match="shape"):
        rte_kernels.sw_2stream_reduced(*k15[:3], k15[3][:-1], *k15[4:])
    with pytest.raises(ValueError, match="contiguous"):
        rte_kernels.sw_2stream_reduced(k15[0], k15[1].transpose(0, 1).contiguous().transpose(0, 1), *k15[2:])
    with pytest.raises(TypeError, match="float32"):
        rte_kernels.sw_2stream_reduced(*k15[:2], k15[2].double(), *k15[3:])
    assert _counts() == {}


def test_sw_direct_beam_runs_with_the_default_impl(cuda):
    """solve_sw(two_stream=False) and RRTMGPSolver(two_stream_sw=False) on f32
    CUDA tensors with the default impl return the direct-beam fluxes through
    the optics kernel (clear and all-sky); impl="two_kernel" runs SW
    two-stream, several LW angles and LW two-stream."""
    from rrtmgp_tpu_torch import AllSkyRadiation, RRTMGPGridParams, RRTMGPParameters, RRTMGPSolver

    ncol, nlay = 300, 12
    sw = synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=1, dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    mu0 = f((ncol,), 0.6)
    mu0[::3] = -0.1
    bs = SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((4, ncol), 0.2), sfc_alb_diffuse=f((4, ncol), 0.2))
    mega.reset_launch_counts()
    beam, _ = solve_sw(sw, atm, bs, two_stream=False)
    assert _counts() == {"optics_fused": 1}
    ref, _ = solve_sw(sw, atm, bs, two_stream=False, impl="torch")
    assert _rel([beam.flux_dn_dir], [ref.flux_dn_dir]) <= TOL["optics_fused"]
    assert torch.all(beam.flux_up == 0.0) and torch.all(beam.flux_dn == 0.0)
    assert torch.all(beam.flux_dn_dir[:, mu0 <= 0] == 0.0) and float(beam.flux_dn_dir.max()) > 100.0
    assert torch.all(beam.flux_dn_dir[:-1] <= beam.flux_dn_dir[1:])
    with pytest.raises(ValueError, match="no direct-beam route.*impl=None or 'two_kernel'"):
        solve_sw(sw, atm, bs, two_stream=False, impl="kernel")
    # SW two-stream through the two-kernel path against the megakernel and the torch path
    mega.reset_launch_counts()
    two, _ = solve_sw(sw, atm, bs, impl="two_kernel")
    assert _counts() == {"optics_fused": 1, "sw_2stream_reduced": 1}
    assert _rel(two, solve_sw(sw, atm, bs, impl="kernel")[0]) <= TOL["sw_2stream_reduced"]
    assert _rel(two, solve_sw(sw, atm, bs, impl="torch")[0]) <= TOL["sw_2stream_reduced"]
    for flux in two:
        assert torch.all(flux[:, mu0 <= 0] == 0.0)
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((4, ncol), 0.98))
    mega.reset_launch_counts()
    lw2, _ = solve_lw(lw, atm, bl, two_stream=True, impl="two_kernel")
    assert _counts() == {"optics_fused": 1, "planck_band_rows": 1, "lw_2stream_reduced": 1}
    assert _rel(lw2, solve_lw(lw, atm, bl, two_stream=True, impl="torch")[0]) <= TOL["lw_2stream_reduced"]

    # the solver, all-sky with aerosols: LW two-stream on its megakernel, SW direct beam
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                               with_clouds=True, with_aerosols=True)
    bl = LwBCs(sfc_emis=f((16, ncol), 0.98))
    bs = SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0),
               sfc_alb_direct=f((14, ncol), 0.2), sfc_alb_diffuse=f((14, ncol), 0.2))
    mk = lambda **kw: RRTMGPSolver(RRTMGPGridParams(nlay=nlay, ncol=ncol), AllSkyRadiation(aerosol_radiation=True),
                                   RRTMGPParameters(), bl, bs, atm, two_stream_sw=False, **kw)
    solver, exact = mk(), mk(impl="torch")
    mega.reset_launch_counts()
    _, f_sw = solver.update_fluxes()
    assert _counts() == {"planck_band": 1, "lw2_mega": 1, "aerosol_bands": 2, "optics_fused": 1,
                         "mcica_mask_export": 1}
    _, t_sw = exact.update_fluxes()
    assert _rel([f_sw.flux_dn_dir], [t_sw.flux_dn_dir]) <= TOL["optics_fused"]
    assert torch.all(f_sw.flux_up == 0.0) and torch.all(f_sw.flux_dn_dir[:, mu0 <= 0] == 0.0)
    assert torch.equal(solver.sw_cloud_cover(), exact.sw_cloud_cover())


@pytest.mark.parametrize("n_angles", [2, 3, 4])
def test_multi_angle_routes_agree(cuda, n_angles):
    """Several LW angles, clear and all-sky (McICA by seed, aerosols), at a
    width where both routes fit in memory: the default impl takes the
    two-kernel path (the optics once, every angle in one sweep launch) and
    impl="kernel"
    one megakernel launch per angle; they agree within the LW sweep's gate,
    draw the same cloud cover, and both stay within it of the torch path."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    ncol, nlay = 300, 12
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    bl = LwBCs(sfc_emis=torch.full((4, ncol), 0.98, device=cuda))
    clear = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    cloudy = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                                  with_clouds=True, with_aerosols=True)
    allsky = dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                  lkp_aero=synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, device=cuda), cld_mask_seed=5)
    for atm, kw in ((clear, {}), (cloudy, allsky)):
        mega.reset_launch_counts()
        two, d_two = solve_lw(lw, atm, bl, n_gauss_angles=n_angles, **kw)
        counts = _counts()
        assert counts["optics_fused"] == 1 and counts["lw_noscat_banded_reduced"] == 1
        assert "lw_clear_mega" not in counts
        mega.reset_launch_counts()
        per_angle, d_per = solve_lw(lw, atm, bl, n_gauss_angles=n_angles, impl="kernel", **kw)
        assert _counts()["lw_clear_mega"] == n_angles
        exact, _ = solve_lw(lw, atm, bl, n_gauss_angles=n_angles, impl="torch", **kw)
        assert _rel(two[:2], per_angle[:2]) <= TOL["lw_noscat_banded_reduced"]
        assert _rel(two[:2], exact[:2]) <= TOL["lw_noscat_banded_reduced"]
        if kw:
            assert torch.equal(d_two.cld_cover, d_per.cld_cover)


# ---------------------------------------------------------------------------
# The sweeps from materialized optics and sources, and the paths that run them
# ---------------------------------------------------------------------------


def _sweep_case(dev, ngpt, nbnd, ncol, nlay):
    """Arguments of lw_noscat_reduced, lw_2stream_reduced, sw_2stream_gpt and
    lw_noscat_gpt at one size: the optics kernel's tau, numpy-seeded sources,
    scattering media and incident fluxes."""
    _, _, _, k12, k15 = _two_kernel_case(dev, ngpt, nbnd, ncol, nlay)
    rng = np.random.default_rng(9)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)
    tau, emis, g2b, ds, w, inc = k12[0], k12[5], k12[6], k12[7], k12[8], k12[9]
    lay, lev, sfc = u(0.5, 1.5, nlay, ncol, ngpt), u(0.5, 1.5, nlay + 1, ncol, ngpt), u(0.5, 1.5, ncol, ngpt)
    k13 = (tau, lay, lev, sfc, emis, g2b, ds, w, inc)
    k14 = (tau, u(0.0, 0.9, nlay, ncol, ngpt), u(0.0, 0.8, nlay, ncol, ngpt), lev * 30.0, sfc * 40.0, emis, g2b,
           inc * 20.0)
    k16b = (tau, lay, lev, sfc, emis.T[:, g2b.long()].contiguous(), ds, w, inc)
    tau_sw, ssa, g, mu0, toa, adir, adif, sg2b, sinc = k15
    expand = lambda x: x.T[:, sg2b.long()].contiguous()
    k16a = (tau_sw, ssa, g, mu0[:, None].expand(ncol, ngpt).contiguous(), toa, expand(adir), expand(adif), sinc)
    return k13, k14, k15, k16a, k16b


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2), (1024, 4, 7, 3),
                                                 (1100, 4, 7, 3),
                                                 (1000, 4, 7, 3)])
def test_sweep_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay):
    """The four sweeps from materialized optics and sources against their
    twins, with and without incident flux (and asymmetry); each per-g-point
    sweep summed over g-points equals its g-summed sibling to the sum's
    rounding."""
    k13, k14, k15, k16a, k16b = _sweep_case(cuda, ngpt, nbnd, ncol, nlay)
    mega.reset_launch_counts()
    no_inc = lambda a: (*a[:-1], None)
    for name, ref, args in (
        ("lw_noscat_reduced", rte_kernels.lw_noscat_reduced_ref, k13),
        ("lw_2stream_reduced", rte_kernels.lw_2stream_reduced_ref, k14),
        ("lw_noscat_gpt", rte_kernels.lw_noscat_gpt_ref, k16b),
        ("sw_2stream_gpt", rte_kernels.sw_2stream_gpt_ref, k16a),
    ):
        shape = (nlay + 1, ncol, ngpt) if name.endswith("gpt") else (nlay + 1, ncol)
        for a in (args, no_inc(args)):
            out = getattr(rte_kernels, name)(*a)
            assert all(o.shape == shape for o in out)
            assert _rel(out, ref(*a)) <= TOL[name], name
            if name.startswith("lw"):
                assert torch.all(out[1][-1] > 0.0) if a[-1] is not None else torch.all(out[1][-1] == 0.0)
    no_g = (*k16a[:2], None, *k16a[3:])
    assert _rel(rte_kernels.sw_2stream_gpt(*no_g), rte_kernels.sw_2stream_gpt_ref(*no_g)) <= TOL["sw_2stream_gpt"]
    summed = lambda out: [o.sum(-1) for o in out]
    assert _rel(summed(rte_kernels.lw_noscat_gpt(*k16b)), rte_kernels.lw_noscat_reduced(*k13)) <= 5e-6
    assert _rel(summed(rte_kernels.sw_2stream_gpt(*k16a)), rte_kernels.sw_2stream_reduced(*k15)) <= 5e-6
    torch.cuda.synchronize()
    assert _counts() == {"lw_noscat_reduced": 3, "lw_2stream_reduced": 2, "lw_noscat_gpt": 3, "sw_2stream_gpt": 4,
                         "sw_2stream_reduced": 1}


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2),
                                                 (1100, 4, 7, 3), (256, 16, 9, 800)])
def test_per_gpoint_sweeps_match_twins_at_every_cache_depth(cuda, monkeypatch, ngpt, nbnd, ncol, nlay):
    """sw_2stream_gpt (its state in its outputs) and lw_noscat_gpt (the
    bottom layers' upward sources kept from the downward pass) against
    their twins with and without asymmetry and incident flux, 1100
    g-points over two blocks, 800 layers; each gives the same bits
    whatever number of bottom levels or layers it keeps in shared memory
    (none, one, eight, the plan's most), as its design says."""
    _, _, _, k16a, k16b = _sweep_case(cuda, ngpt, nbnd, ncol, nlay)
    no_inc = lambda a: (*a[:-1], None)
    no_g = (*k16a[:2], None, *k16a[3:])
    for name, most, cases in (("sw_2stream_gpt", "SW_GPT_LEVELS", (k16a, no_inc(k16a), no_g, no_inc(no_g))),
                              ("lw_noscat_gpt", "LW_GPT_LAYERS", (k16b, no_inc(k16b)))):
        fn, ref = getattr(rte_kernels, name), getattr(rte_kernels, f"{name}_ref")
        for args in cases:
            out = fn(*args)
            assert all(o.shape == (nlay + 1, ncol, ngpt) for o in out)
            assert _rel(out, ref(*args)) <= TOL[name]
            for depth in (0, 1, 8, nlay):
                monkeypatch.setattr(rte_kernels, most, depth)
                assert all(torch.equal(a, b) for a, b in zip(fn(*args), out)), (name, depth)
            monkeypatch.undo()


def test_sw_2stream_gpt_allocates_no_scratch(cuda):
    """A call of sw_2stream_gpt allocates its three outputs and nothing
    else (the four (nlay, ncol, ngpt) scratch arrays of the four-array
    passes would be 63 MB here); lw_noscat_gpt likewise its two."""
    _, _, _, k16a, k16b = _sweep_case(cuda, 256, 16, 257, 60)
    for fn, args in ((rte_kernels.sw_2stream_gpt, k16a), (rte_kernels.lw_noscat_gpt, k16b)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = fn(*args)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - before
        outputs = sum(o.numel() * o.element_size() for o in out)
        assert outputs <= grown <= outputs + len(out) * 2**20, (fn.__name__, grown, outputs)


def test_sweep_kernels_are_deterministic_and_reject_what_they_do_not_take(cuda):
    k13, k14, k15, k16a, k16b = _sweep_case(cuda, 8, 2, 16, 4)
    for fn, args in ((rte_kernels.lw_noscat_reduced, k13), (rte_kernels.lw_2stream_reduced, k14),
                     (rte_kernels.sw_2stream_gpt, k16a), (rte_kernels.lw_noscat_gpt, k16b)):
        for a, b in zip(fn(*args), fn(*args)):
            assert torch.equal(a, b)
    mega.reset_launch_counts()
    with pytest.raises(ValueError, match="shape"):
        rte_kernels.lw_noscat_reduced(k13[0], k13[1][:, :-1].contiguous(), *k13[2:])
    with pytest.raises(TypeError, match="int32"):
        rte_kernels.lw_noscat_reduced(*k13[:5], k13[5].long(), *k13[6:])
    with pytest.raises(ValueError, match="shape"):  # band-valued emissivity where per-g-point is due
        rte_kernels.lw_noscat_gpt(*k16b[:4], k13[4], *k16b[5:])
    with pytest.raises(TypeError, match="float32"):
        rte_kernels.lw_2stream_reduced(k14[0], k14[1].double(), *k14[2:])
    with pytest.raises(ValueError, match="contiguous"):
        rte_kernels.lw_2stream_reduced(*k14[:3], k14[3].transpose(0, 1).contiguous().transpose(0, 1), *k14[4:])
    with pytest.raises(ValueError, match="on cpu"):
        rte_kernels.lw_2stream_reduced(*k14[:-1], k14[-1].cpu())
    with pytest.raises(ValueError, match="shape"):  # mu0 per column where per g-point is due
        rte_kernels.sw_2stream_gpt(*k16a[:3], k15[3], *k16a[4:])
    assert _counts() == {}


def test_lw_two_stream_sweep_equals_the_megakernel_on_equal_optics(cuda):
    """solve_lw(two_stream=True) through the two-kernel path reproduces the
    megakernel route bit for bit, clear and all-sky (McICA by seed,
    aerosols): the same coefficient function and recurrence on equal optics
    and sources; both stay within the gate of the torch path."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    ncol, nlay = 300, 12
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    bl = LwBCs(sfc_emis=torch.rand((4, ncol), device=cuda) * 0.1 + 0.9, inc_flux=torch.rand((ncol, 32), device=cuda))
    clear = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    cloudy = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                                  with_clouds=True, with_aerosols=True)
    allsky = dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                  lkp_aero=synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, device=cuda), cld_mask_seed=5)
    for atm, kw, extra in ((clear, {}, {}), (cloudy, allsky, {"aerosol_bands": 1, "mcica_mask_export": 1})):
        mega.reset_launch_counts()
        two, d_two = solve_lw(lw, atm, bl, two_stream=True, impl="two_kernel", **kw)
        assert _counts() == {"optics_fused": 1, "planck_band_rows": 1, "lw_2stream_reduced": 1, **extra}
        one, d_one = solve_lw(lw, atm, bl, two_stream=True, impl="kernel", **kw)
        exact, _ = solve_lw(lw, atm, bl, two_stream=True, impl="torch", **kw)
        for a, b in zip(two, one):
            assert torch.equal(a, b)
        assert _rel(two, exact) <= TOL["lw_2stream_reduced"]
        if kw:
            assert torch.equal(d_two.cld_cover, d_one.cld_cover)


def test_sweep_route_runs_the_sweeps_on_plain_optics(cuda):
    """impl="sweep": plain-torch optics and composition, then one sweep
    kernel per angle (LW no-scattering), the LW two-stream sweep or the SW
    sweep, clear and all-sky; no optics kernel is launched, the direct-beam
    solve launches none at all, and the default impl never takes the route."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    ncol, nlay = 300, 12
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=1, dtype=np.float32, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    bl = LwBCs(sfc_emis=f((4, ncol), 0.98))
    mu0 = f((ncol,), 0.6)
    mu0[::3] = -0.1
    bs = SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((4, ncol), 0.2),
               sfc_alb_diffuse=f((4, ncol), 0.2))
    clear = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    cloudy = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda,
                                  with_clouds=True, with_aerosols=True)
    kw = lambda seed: dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                           lkp_aero=synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                           cld_mask_seed=seed)
    for atm, lw_kw, sw_kw in ((clear, {}, {}), (cloudy, kw(5), kw(6))):
        for n in (1, 3):
            mega.reset_launch_counts()
            out, diag = solve_lw(lw, atm, bl, n_gauss_angles=n, impl="sweep", **lw_kw)
            assert _counts() == {"lw_noscat_reduced": 1}
            exact, ediag = solve_lw(lw, atm, bl, n_gauss_angles=n, impl="torch", **lw_kw)
            assert _rel(out, exact) <= TOL["lw_noscat_reduced"]
        mega.reset_launch_counts()
        out, _ = solve_lw(lw, atm, bl, two_stream=True, impl="sweep", **lw_kw)
        assert _counts() == {"lw_2stream_reduced": 1}
        assert _rel(out, solve_lw(lw, atm, bl, two_stream=True, impl="torch", **lw_kw)[0]) <= TOL["lw_2stream_reduced"]
        mega.reset_launch_counts()
        out, diag = solve_sw(sw, atm, bs, impl="sweep", **sw_kw)
        assert _counts() == {"sw_2stream_reduced": 1}
        exact, ediag = solve_sw(sw, atm, bs, impl="torch", **sw_kw)
        assert _rel(out, exact) <= TOL["sw_2stream_reduced"]
        assert all(torch.all(x[:, mu0 <= 0] == 0.0) for x in out)
        if lw_kw:
            assert torch.equal(diag.cld_cover, ediag.cld_cover) and torch.equal(diag.aod_sw_ext, ediag.aod_sw_ext)
        mega.reset_launch_counts()
        beam, _ = solve_sw(sw, atm, bs, two_stream=False, impl="sweep", **sw_kw)
        assert _counts() == {}
        assert all(torch.equal(a, b) for a, b in zip(beam, solve_sw(sw, atm, bs, two_stream=False, impl="torch", **sw_kw)[0]))
    mega.reset_launch_counts()
    solve_lw(lw, clear, bl, n_gauss_angles=2)
    solve_lw(lw, clear, bl, two_stream=True)
    solve_sw(sw, clear, bs)
    assert not {"lw_noscat_reduced", "lw_2stream_reduced"} & set(_counts())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_lw(synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float64, device=cuda),
                 synthetic_atmosphere(ncol=8, nlay=4, dtype=np.float64, device=cuda),
                 LwBCs(sfc_emis=torch.full((4, 8), 0.98, dtype=torch.float64, device=cuda)), impl="sweep")


@pytest.mark.parametrize("impl", [None, "kernel", "two_kernel", "sweep"])
def test_mixed_dtype_boundary_conditions_are_cast(cuda, impl):
    """Boundary conditions in f64 with an f32 atmosphere: every kernel route
    casts them to the state's dtype instead of raising in a wrapper; the
    fluxes are f32, equal to the cast input's bit for bit and within the
    gates of the torch path."""
    ncol, nlay = 64, 8
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=1, dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    r = lambda lo, hi, *shape: torch.rand(shape, dtype=torch.float64, device=cuda) * (hi - lo) + lo
    bl = LwBCs(sfc_emis=r(0.9, 1.0, 4, ncol), inc_flux=r(0.0, 1.0, ncol, 32))
    bs = SwBCs(cos_zenith=r(0.1, 1.0, ncol), toa_flux=r(1300.0, 1400.0, ncol), sfc_alb_direct=r(0.1, 0.3, 4, ncol),
               sfc_alb_diffuse=r(0.1, 0.3, 4, ncol), inc_flux_diffuse=r(0.0, 1.0, ncol, 32))
    f32 = lambda b: dataclasses.replace(b, **{f.name: getattr(b, f.name).float() for f in dataclasses.fields(b)})
    for solve, lkp, b, tol in ((solve_lw, lw, bl, TOL["lw_clear_mega"]), (solve_sw, sw, bs, TOL["sw_clear_mega"])):
        mixed, _ = solve(lkp, atm, b, impl=impl)
        cast, _ = solve(lkp, atm, f32(b), impl=impl)
        for m, c in zip(mixed, cast):
            assert m.dtype == torch.float32 and torch.equal(m, c)
        assert _rel(mixed, solve(lkp, atm, b, impl="torch")[0]) <= tol


def test_default_built_inputs_live_on_the_card_and_take_the_kernels(cuda):
    """Inputs built without naming a device lie on the card, so the solve
    with the default impl launches the kernels; device="cpu" keeps the
    plain version."""
    from rrtmgp_tpu_torch import convert

    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32)
    atm = synthetic_atmosphere(ncol=64, nlay=8, dtype=np.float32)
    bl = convert.lw_bcs_from_numpy(sfc_emis=np.full((4, 64), 0.98, np.float32))
    assert lw.kmajor.is_cuda and atm.p_lay.is_cuda and bl.sfc_emis.is_cuda
    mega.reset_launch_counts()
    out, _ = solve_lw(lw, atm, bl)
    assert out.flux_up.is_cuda and _counts() == {"planck_band": 1, "lw_clear_mega": 1}
    cpu = dict(dtype=np.float32, device="cpu")
    mega.reset_launch_counts()
    ref, _ = solve_lw(synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, **cpu),
                      synthetic_atmosphere(ncol=64, nlay=8, **cpu),
                      convert.lw_bcs_from_numpy(sfc_emis=np.full((4, 64), 0.98, np.float32), device="cpu"))
    assert not ref.flux_up.is_cuda and _counts() == {}
    assert _rel([out.flux_up.cpu()], [ref.flux_up]) <= TOL["lw_clear_mega"]


def _interp_calls(inp, tabs):
    """The three interp_pt_eta argument tuples of the unfused optics of
    ``inp`` (kmajor with col_mix; the Planck fraction, or the Rayleigh table
    at the troposphere side's slab with fpress = 0)."""
    eta = (inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tabs.gpt2band)
    calls = [(tabs.kmajor, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress, *eta, inp.col_mix1, inp.col_mix2)]
    if tabs.lkp.is_longwave:
        calls.append((tabs.second, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress, *eta))
    else:
        calls.append((tabs.second, inp.jtemp, inp.ftemp, (~inp.tropo_lower).to(torch.int32),
                      torch.zeros_like(inp.fpress), *eta))
    return calls


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (224, 14, 130, 60),
                                                 (5, 5, 3, 2), (1100, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_unfused_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay):
    """interp_pt_eta (each table the unfused optics read) and interp_minor
    against their twins within 1e-6 of the largest value, LW and SW, any
    g-point count (more than a block has threads too: no limit); the
    unfused optics equal the fused optics bit for bit."""
    for longwave in (True, False):
        lkp = synthetic_gas_lookup(longwave=longwave, n_gpt=ngpt, n_bnd=nbnd, seed=0 if longwave else 1,
                                   dtype=np.float32, device=cuda)
        atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
        inp, tabs = (mega_lw_inputs if longwave else mega_sw_inputs)(lkp, atm), lkp.kernel_tables
        mega.reset_launch_counts()
        for args in _interp_calls(inp, tabs):
            out = interp.interp_pt_eta(*args)
            assert out.shape == (nlay, ncol, ngpt)
            assert _rel([out], [interp.interp_pt_eta_ref(*args)]) <= TOL["interp_pt_eta"]
        minor = interp.interp_minor(inp, tabs)
        assert _rel([minor], [interp.interp_minor_ref(inp, tabs)]) <= TOL["interp_minor"]
        assert _counts() == {"interp_pt_eta": 2, "interp_minor": 1}
        if ngpt <= 1024:
            for a, b in zip(interp.optics_unfused(inp, tabs), interp.optics_fused(inp, tabs)):
                assert torch.equal(a, b)


def test_unfused_kernels_are_deterministic_and_reject_what_they_do_not_take(cuda):
    lkp = synthetic_gas_lookup(longwave=True, n_gpt=64, n_bnd=4, dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=200, nlay=12, dtype=np.float32, device=cuda)
    inp, tabs = mega_lw_inputs(lkp, atm), lkp.kernel_tables
    args = _interp_calls(inp, tabs)[0]
    assert torch.equal(interp.interp_pt_eta(*args), interp.interp_pt_eta(*args))
    assert torch.equal(interp.interp_minor(inp, tabs), interp.interp_minor(inp, tabs))
    mega.reset_launch_counts()
    with pytest.raises(ValueError, match="col_mix"):
        interp.interp_pt_eta(*args[:-1], None)
    with pytest.raises(TypeError, match="float32"):
        interp.interp_pt_eta(args[0].double(), *args[1:])
    with pytest.raises(TypeError, match="int32"):
        interp.interp_pt_eta(*args[:3], args[3].long(), *args[4:])
    with pytest.raises(ValueError, match="shape"):
        interp.interp_pt_eta(*args[:5], args[5][:, :-1].contiguous(), *args[6:])
    with pytest.raises(ValueError, match="on cpu"):
        interp.interp_pt_eta(*args[:9], args[9].cpu(), *args[10:])
    with pytest.raises(TypeError, match="float32"):
        interp.interp_minor(inp.to(dtype=torch.float64), tabs)
    assert _counts() == {}


def test_unfused_solves_take_the_unfused_kernels(cuda):
    """fused_optics=False on f32 CUDA tensors: every solve takes the
    two-kernel path with interp_pt_eta twice and interp_minor once in place
    of optics_fused, and equals the fused two-kernel route bit for bit (LW
    1 and 3 angles, LW two-stream, SW two-stream, SW direct beam, clear and
    all-sky); RRTMGPSolver passes it through."""
    from rrtmgp_tpu_torch import AllSkyRadiation, RRTMGPGridParams, RRTMGPParameters, RRTMGPSolver
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    ncol, nlay = 300, 12
    lw = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, dtype=np.float32, device=cuda)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=1, dtype=np.float32, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    mu0 = f((ncol,), 0.6)
    mu0[::3] = -0.1
    bl = LwBCs(sfc_emis=f((4, ncol), 0.98))
    bs = SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((4, ncol), 0.2),
               sfc_alb_diffuse=f((4, ncol), 0.2))
    clear = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    cloudy = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda, with_clouds=True,
                                  with_aerosols=True)
    kw_lw = dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, dtype=np.float32, device=cuda),
                 lkp_aero=synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32, device=cuda), cld_mask_seed=5)
    kw_sw = dict(lkp_cld=synthetic_cloud_lookup(n_bnd=4, seed=5, dtype=np.float32, device=cuda),
                 lkp_aero=synthetic_aerosol_lookup(n_bnd=4, seed=6, dtype=np.float32, device=cuda), cld_mask_seed=6)
    cases = [(solve_lw, lw, bl, dict(n_gauss_angles=1)), (solve_lw, lw, bl, dict(n_gauss_angles=3)),
             (solve_lw, lw, bl, dict(two_stream=True)), (solve_sw, sw, bs, {}),
             (solve_sw, sw, bs, dict(two_stream=False))]
    for atm, sky_lw, sky_sw in ((clear, {}, {}), (cloudy, kw_lw, kw_sw)):
        for solve, lkp, b, kw in cases:
            sky = sky_lw if solve is solve_lw else sky_sw
            mega.reset_launch_counts()
            out, d_out = solve(lkp, atm, b, fused_optics=False, **kw, **sky)
            counts = _counts()
            assert counts["interp_pt_eta"] == 2 and counts["interp_minor"] == 1, counts
            assert not {"optics_fused", "lw_clear_mega", "lw2_mega", "sw_clear_mega"} & set(counts), counts
            ref, d_ref = solve(lkp, atm, b, impl="two_kernel", **kw, **sky)
            assert all(torch.equal(x, y) for x, y in zip(out, ref)), (solve.__name__, kw)
            if sky:
                assert torch.equal(d_out.cld_cover, d_ref.cld_cover)
    with pytest.raises(ValueError, match="fused_optics"):
        solve_lw(lw, clear, bl, impl="kernel", fused_optics=False)
    bl16 = LwBCs(sfc_emis=f((16, ncol), 0.98))
    bs14 = SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((14, ncol), 0.2),
                 sfc_alb_diffuse=f((14, ncol), 0.2))
    mk = lambda **kw: RRTMGPSolver(RRTMGPGridParams(nlay=nlay, ncol=ncol), AllSkyRadiation(aerosol_radiation=True),
                                   RRTMGPParameters(), bl16, bs14, cloudy, **kw)
    mega.reset_launch_counts()
    unfused = mk(fused_optics=False).update_fluxes()
    counts = _counts()
    assert counts["interp_pt_eta"] == 4 and counts["interp_minor"] == 2 and "optics_fused" not in counts, counts
    fused = mk(impl="two_kernel").update_fluxes()
    for a, b in zip((*unfused[0], *unfused[1]), (*fused[0], *fused[1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The staged gas-optics gather (csrc/gather.cuh): optics_fused and
# lw_clear_mega at shapes that do not fill its tiles and chunks
# ---------------------------------------------------------------------------


def _rich_lookup(dev, longwave, ngpt, nbnd, n_per_side, seed):
    """A synthetic lookup whose band limits are not multiples of 16 and with
    n_per_side minor intervals a side (the synthetic lookup has three), each
    over a whole band, so that several cover a g-point."""
    from rrtmgp_tpu_torch.data.lookups import MinorInterval

    lkp = synthetic_gas_lookup(longwave=longwave, n_gpt=ngpt, n_bnd=nbnd, seed=seed, dtype=np.float32, device=dev)
    rng = np.random.default_rng(seed + 40)
    cuts = np.sort(rng.choice(np.arange(1, ngpt), nbnd - 1, replace=False)).tolist()
    edges = [0, *cuts, ngpt]
    lims = tuple(zip(edges[:-1], edges[1:]))

    def side():
        intervals, rows, k0 = [], [], 0
        for _ in range(n_per_side):
            g0, g1 = lims[int(rng.integers(nbnd))]
            intervals.append(MinorInterval(int(rng.choice([2, 3, 4, 5, 6])), int(rng.integers(2)),
                                           bool(rng.integers(2)), bool(rng.integers(2)), g0, g1, k0))
            rows.append(rng.uniform(1e-25, 5e-24, (g1 - g0, lkp.n_temp, lkp.n_eta)))
            k0 += g1 - g0
        return tuple(intervals), torch.from_numpy(np.concatenate(rows).astype(np.float32)).to(dev)

    (lower, k_lower), (upper, k_upper) = side(), side()
    assert any(b - a != 16 and b % 16 for a, b in lims)
    return dataclasses.replace(lkp, bnd_lims_gpt=lims, minor_lower=lower, kminor_lower=k_lower,
                               minor_upper=upper, kminor_upper=k_upper)


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay,n_minor", [(36, 3, 13, 13, 12), (256, 16, 1001, 13, 30),
                                                         (1100, 5, 9, 11, 20),
                                                         (1000, 5, 9, 11, 20)])
def test_staged_gather_kernels_match_twins(cuda, ngpt, nbnd, ncol, nlay, n_minor):
    """optics_fused (LW, SW) and lw_clear_mega (clear, mask given, McICA seed
    + aerosols, aerosols alone; f64 clear) against their twins where ncol is
    not a multiple of optics_fused's column tile nor nlay of lw_clear_mega's
    staging chunk, band limits are not multiples of 16 and more minor
    intervals than the synthetic three cover each g-point."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    assert ncol % interp.OPTICS_TILE and nlay % 8
    lw = _rich_lookup(cuda, True, ngpt, nbnd, n_minor, 0)
    sw = _rich_lookup(cuda, False, ngpt, nbnd, n_minor, 1)
    assert lw.kernel_tables.n_minor == 2 * n_minor
    _, _, atm, cld, aero, _, _, masks = _allsky_case(cuda, ngpt, nbnd, ncol, nlay)
    mega.reset_launch_counts()
    for lkp, inputs in ((lw, mega_lw_inputs), (sw, mega_sw_inputs)):
        args = (inputs(lkp, atm), lkp.kernel_tables)
        out = interp.optics_fused(*args)
        for o, r in zip(out, interp.optics_fused_ref(*args)):
            assert _rel([o], [r]) <= TOL["optics_fused"]
    rng = np.random.default_rng(12)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)
    plk = lambda t: mega.planck_band(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    Ds, wts = angular_discretization(1)
    args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lay), plk(atm.t_lev), plk(atm.t_sfc),
            u(0.8, 1.0, nbnd, ncol), u(0.0, 2.0, ncol, ngpt), float(Ds[0]), float(wts[0]))
    make = lambda c, a, m, s: _kernel_composition(lw, atm, c, a, m, s, 100, None, False, False)[0]
    for comp in (mega.CLEAR, make(cld[0], None, masks[0], None), make(cld[0], aero[0], None, 9),
                 make(None, aero[0], None, None)):
        out, want = mega.lw_clear_mega(*args, comp), mega.lw_clear_mega_ref(*args, comp)
        if comp.seeded:
            assert torch.equal(out[2], want[2])
        assert _rel(out[:2], want[:2]) <= TOL["lw_clear_mega"]
    lw64, atm64 = lw.to(dtype=torch.float64), atm.to(dtype=torch.float64)
    args64 = (mega_lw_inputs(lw64, atm64), lw64.kernel_tables, *(x.double() for x in args[2:7]), *args[7:])
    assert _rel(mega.lw_clear_mega(*args64), mega.lw_clear_mega_ref(*args64)) <= TOL64["lw_clear_mega"]
    torch.cuda.synchronize()
    assert _counts() == {"optics_fused": 2, "planck_band": 3, "lw_clear_mega": 5, "aerosol_bands": 2}


# ---------------------------------------------------------------------------
# interp_pt_eta on the staged gather and sw_2stream_reduced's three passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (1100, 4, 7, 5), (1000, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_staged_interp_pt_eta_equals_its_twin_bit_for_bit(cuda, ngpt, nbnd, ncol, nlay):
    """interp_pt_eta on each of the four tables of the unfused optics (LW
    kmajor with col_mix, the Planck fraction, SW kmajor with col_mix, the
    Rayleigh table at side 0 and 1 of its two slabs) and on kmajor without
    col_mix equals its twin bit for bit, past 1024 g-points too."""
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    mega.reset_launch_counts()
    for longwave in (True, False):
        lkp = synthetic_gas_lookup(longwave=longwave, n_gpt=ngpt, n_bnd=nbnd, seed=0 if longwave else 1,
                                   dtype=np.float32, device=cuda)
        inp, tabs = (mega_lw_inputs if longwave else mega_sw_inputs)(lkp, atm), lkp.kernel_tables
        calls = _interp_calls(inp, tabs)
        if not longwave:
            assert int(calls[1][3].min()) == 0 and int(calls[1][3].max()) == 1
        for args in (*calls, calls[0][:-2]):
            assert torch.equal(interp.interp_pt_eta(*args), interp.interp_pt_eta_ref(*args))
    torch.cuda.synchronize()
    assert _counts() == {"interp_pt_eta": 6}


@pytest.mark.parametrize("with_mix", [True, False])
def test_interp_pt_eta_reads_nothing_past_the_last_slab(cuda, with_mix):
    """A table followed in memory by NaN, with cells on its last pressure
    slab and a nonzero pressure weight (and a 2-slab Rayleigh-shaped table
    read at side 1): the kernel reads no node above the last slab, so the
    output is finite and equals the twin bit for bit, with col_mix and
    without."""
    rng = np.random.default_rng(21)
    ntemp, neta, ngpt, nbnd, nlay, ncol = 5, 6, 40, 3, 6, 37
    T = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt).to(cuda)
    for n_p, fp in ((3, rng.uniform(0.1, 1, (nlay, ncol))), (2, np.zeros((nlay, ncol)))):
        n = n_p * ntemp * neta * ngpt
        buf = torch.full((n + ntemp * neta * ngpt,), float("nan"), device=cuda)
        buf[:n] = T(rng.uniform(0.1, 2.0, n))
        table = buf[:n].view(n_p, ntemp, neta, ngpt)
        jpress = T(rng.integers(0, n_p, (nlay, ncol)), torch.int32)
        jpress[::2] = n_p - 1
        args = (table, T(rng.integers(0, ntemp - 1, (nlay, ncol)), torch.int32), T(rng.uniform(0, 1, (nlay, ncol))),
                jpress, T(fp), T(rng.integers(0, neta - 1, (nlay, ncol, nbnd)), torch.int32),
                T(rng.uniform(0, 1, (nlay, ncol, nbnd))), T(rng.integers(0, neta - 1, (nlay, ncol, nbnd)), torch.int32),
                T(rng.uniform(0, 1, (nlay, ncol, nbnd))), T(np.arange(ngpt) * nbnd // ngpt, torch.int32))
        if with_mix:
            args += (T(rng.uniform(0.5, 2, (nlay, ncol, nbnd))), T(rng.uniform(0.5, 2, (nlay, ncol, nbnd))))
        out = interp.interp_pt_eta(*args)
        assert torch.isfinite(out).all()
        assert torch.equal(out, interp.interp_pt_eta_ref(*args))


def _night_sw(k15, every=5):
    """k15 with every ``every``-th column at night (mu0 -0.1, one at 0)."""
    mu0 = k15[3].clone()
    mu0[::every] = -0.1
    mu0[1] = 0.0
    return (*k15[:3], mu0, *k15[4:])


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (224, 14, 130, 60), (1100, 4, 7, 5), (1000, 4, 7, 5),
                                                 (224, 14, 3, 2800)])
def test_sw_2stream_reduced_three_passes(cuda, ngpt, nbnd, ncol, nlay):
    """sw_2stream_reduced against its twin on its day columns, with and
    without g and incident diffuse flux, with night columns in the call; a
    second call, on scratch that holds the first call's values, gives the
    same bits, night columns included; past 1024 g-points over several
    blocks, and at 2800 layers with the level sums in device memory."""
    k15 = _night_sw(_two_kernel_case(cuda, ngpt, nbnd, ncol, nlay)[4])
    day = k15[3] > 0
    assert not bool(day.all())
    for args in (k15, (*k15[:2], None, *k15[3:]), (*k15[:-1], None), (*k15[:2], None, *k15[3:-1], None)):
        out = rte_kernels.sw_2stream_reduced(*args)
        want = rte_kernels.sw_2stream_reduced_ref(*args)
        assert _rel([o[:, day] for o in out], [w[:, day] for w in want]) <= TOL["sw_2stream_reduced"]
        for a, b in zip(out, rte_kernels.sw_2stream_reduced(*args)):
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


def test_sw_2stream_reduced_equals_the_megakernel_with_night_columns(cuda):
    """On the optics of the optics kernel, sw_2stream_reduced's three passes
    give sw_clear_mega's bits on every column, night columns included (the
    values a solve replaces by zeros)."""
    _, _, sw_args = _case(cuda, 64, 4, 500, 20)
    k15 = _night_sw(_two_kernel_case(cuda, 64, 4, 500, 20)[4])
    sw_args = (*sw_args[:2], k15[3], *sw_args[3:])
    for a, b in zip(rte_kernels.sw_2stream_reduced(*k15[:2], None, *k15[3:]), mega.sw_clear_mega(*sw_args)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


# ---------------------------------------------------------------------------
# interp_minor on the staged gather, and lw_noscat_banded over every angle
# of a solve in one launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay,n_minor", [(36, 3, 13, 13, 12), (36, 4, 1000, 30, 3),
                                                         (1100, 5, 9, 11, 20),
                                                         (1000, 5, 9, 11, 20)])
def test_staged_interp_minor_is_optics_fused_minor_part(cuda, ngpt, nbnd, ncol, nlay, n_minor):
    """interp_minor LW and SW against its twin where ncol is not a multiple
    of its column tile, cells lie on both troposphere sides and several
    intervals cover a g-point, at 36 and 1100 g-points (a column tile's
    g-points over two blocks); and bit for bit optics_fused's minor part:
    optics_fused with kmajor and the second table zeroed writes tau = max(0
    + minor, 0), the minor optical depth itself."""
    assert ncol % interp.MINOR_TILE
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    mega.reset_launch_counts()
    for seed, (longwave, inputs) in enumerate(((True, mega_lw_inputs), (False, mega_sw_inputs))):
        lkp = _rich_lookup(cuda, longwave, ngpt, nbnd, n_minor, seed)
        inp, tabs = inputs(lkp, atm), lkp.kernel_tables
        assert 0 < int(inp.tropo_lower.sum()) < inp.tropo_lower.numel()
        minor = interp.interp_minor(inp, tabs)
        assert minor.shape == (nlay, ncol, ngpt) and float(minor.max()) > 0.0
        assert _rel([minor], [interp.interp_minor_ref(inp, tabs)]) <= TOL["interp_minor"]
        no_major = dataclasses.replace(tabs, kmajor=torch.zeros_like(tabs.kmajor),
                                       second=torch.zeros_like(tabs.second))
        assert torch.equal(minor, interp.optics_fused(inp, no_major)[0])
        assert torch.equal(minor, interp.interp_minor(inp, tabs))
    torch.cuda.synchronize()
    assert _counts() == {"interp_minor": 4, "optics_fused": 2}


def _per_angle(args, ds, w, inc, one=rte_kernels.lw_noscat_banded_reduced):
    """A one-angle sweep (lw_noscat_banded_reduced, or lw_noscat_reduced)
    per angle, angle k with the incident flux inc * w_k, summed in the
    angles' order: the solves' sum before one launch took every angle."""
    up = dn = None
    for d, wk in zip(ds, w):
        u, v = one(*args, d, wk, None if inc is None else inc * wk)
        up, dn = (u, v) if up is None else (up + u, dn + v)
    return up, dn


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (1100, 4, 7, 5), (1000, 4, 7, 5),
                                                 (1000, 4, 7, 5)])
def test_lw_noscat_banded_angles_equal_per_angle_launches(cuda, ngpt, nbnd, ncol, nlay):
    """lw_noscat_banded_angles, 1 to 4 angles in one launch, with and
    without incident flux: against its twin, and bit for bit the one-angle
    launches summed in the angles' order, at 1100 g-points too (a column
    over two blocks, the sums completed per angle)."""
    k12 = _two_kernel_case(cuda, ngpt, nbnd, ncol, nlay)[3]
    args, inc = k12[:7], k12[9]
    for n in (1, 2, 3, 4):
        Ds, wts = angular_discretization(n)
        ds, w = [float(d) for d in Ds], [float(x) for x in wts]
        for flux in (inc, None):
            mega.reset_launch_counts()
            up, dn = rte_kernels.lw_noscat_banded_angles(*args, ds, w, flux)
            assert _counts() == {"lw_noscat_banded_reduced": 1}
            assert up.shape == dn.shape == (nlay + 1, ncol)
            want = _per_angle(args, ds, w, flux)
            assert torch.equal(up, want[0]) and torch.equal(dn, want[1]), (n, flux is None)
            assert _rel((up, dn), rte_kernels.lw_noscat_banded_angles_ref(*args, ds, w, flux)) <= \
                TOL["lw_noscat_banded_reduced"]
            assert torch.all(dn[-1] > 0.0) if flux is not None else torch.all(dn[-1] == 0.0)


def test_lw_noscat_banded_angles_on_deep_columns(cuda):
    """256 g-points x 3700 layers: the level sums of every angle count go
    to device memory (2 x nang fields), and 1 to 4 angles in one launch
    equal the one-angle launches summed bit for bit, with incident flux;
    2 angles against the twin."""
    from rrtmgp_tpu_torch.ops._launch import smem_limit

    ncol, nlay = 3, 3700
    k12 = _two_kernel_case(cuda, 256, 16, ncol, nlay)[3]
    args, inc = k12[:7], k12[9]
    for n in (1, 2, 3, 4):
        (_, n_groups, in_block), partials = rte_kernels.angles_plan("lw_noscat_banded", n, nlay, ncol, 256, cuda)
        assert n_groups == 1 and not in_block and partials.shape == (2 * n, nlay + 1, ncol, 8)
        assert smem_limit(cuda) < 2 * n * (nlay + 1) * 8 * 4
        Ds, wts = angular_discretization(n)
        ds, w = [float(d) for d in Ds], [float(x) for x in wts]
        out = rte_kernels.lw_noscat_banded_angles(*args, ds, w, inc)
        want = _per_angle(args, ds, w, inc)
        assert all(torch.equal(a, b) for a, b in zip(out, want)), n
        if n == 2:
            assert _rel(out, rte_kernels.lw_noscat_banded_angles_ref(*args, ds, w, inc)) <= \
                TOL["lw_noscat_banded_reduced"]


def test_lw_noscat_banded_angles_reject_what_the_kernel_does_not_take(cuda):
    """No angle, more than four, secants and weights of other lengths, or an
    incident flux of another shape raise before a launch; a CPU tensor among
    CUDA ones too."""
    k12 = _two_kernel_case(cuda, 8, 2, 16, 4)[3]
    args, inc = k12[:7], k12[9]
    mega.reset_launch_counts()
    for ds, w in (([], []), ([1.5] * 5, [0.2] * 5), ([1.5, 2.0], [1.0])):
        with pytest.raises(ValueError, match="angles"):
            rte_kernels.lw_noscat_banded_angles(*args, ds, w)
    with pytest.raises(ValueError, match="shape"):
        rte_kernels.lw_noscat_banded_angles(*args, [1.5], [1.0], inc[:, :-1].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        rte_kernels.lw_noscat_banded_angles(*args[:5], args[5].cpu(), args[6], [1.5], [1.0])
    assert _counts() == {}


# ---------------------------------------------------------------------------
# sw_clear_mega on the staged gather, and lw_noscat_reduced over every angle
# in one launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay,n_minor", [(36, 3, 13, 13, 12), (224, 14, 257, 60, 30),
                                                         (1100, 5, 9, 11, 20),
                                                         (1000, 5, 9, 11, 20)])
def test_staged_sw_clear_mega_matches_twin(cuda, ngpt, nbnd, ncol, nlay, n_minor):
    """sw_clear_mega on its staged chunks against its twin: clear, a cloud
    mask given (with and without aerosols), McICA by seed + aerosols (the
    cloud cover bit for bit) and aerosols alone, where nlay is not a multiple
    of the staging chunk, band limits are not multiples of 16, several minor
    intervals cover each g-point and, at 1100 g-points, a column spans two
    blocks; a second call equals the first bit for bit."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    assert nlay % mega.SW_CHUNK
    sw = _rich_lookup(cuda, False, ngpt, nbnd, n_minor, 1)
    _, _, atm, cld, aero, _, sw_args, masks = _allsky_case(cuda, ngpt, nbnd, ncol, nlay)
    args = (mega_sw_inputs(sw, atm), sw.kernel_tables, *sw_args[2:])
    make = lambda c, a, m, s: _kernel_composition(sw, atm, c, a, m, s, 100, None, True, False)[0]
    comps = (mega.CLEAR, make(cld[1], None, masks[1], None), make(cld[1], aero[1], masks[1], None),
             make(cld[1], aero[1], None, 9), make(None, aero[1], None, None))
    mega.reset_launch_counts()
    for comp in comps:
        out, want = mega.sw_clear_mega(*args, comp), mega.sw_clear_mega_ref(*args, comp)
        if comp.seeded:
            assert torch.equal(out[3], want[3])
        assert _rel(out[:3], want[:3]) <= TOL["sw_clear_mega"]
        assert all(torch.equal(a, b) for a, b in zip(out, mega.sw_clear_mega(*args, comp)))
    torch.cuda.synchronize()
    assert _counts()["sw_clear_mega"] == 2 * len(comps)


def test_staged_sw_clear_mega_on_deep_columns(cuda):
    """224 g-points x 2800 layers, seed + aerosols: the staging area beside
    level sums in device memory (the plan counts the staged bytes); the
    fluxes hold the twin and the cover is the twin's bit for bit."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    ngpt, nbnd, ncol, nlay = 224, 14, 3, 2800
    _, sw, atm, cld, aero, _, sw_args, _ = _allsky_case(cuda, ngpt, nbnd, ncol, nlay)
    comp = _kernel_composition(sw, atm, cld[1], aero[1], None, 9, 100, None, True, False)[0]
    design = mega.sw_clear_mega_design(*sw_args[:2], comp)
    assert design["n_groups"] == 1 and not design["in_block"] and design["chunk"] == mega.SW_CHUNK
    out, want = mega.sw_clear_mega(*sw_args, comp), mega.sw_clear_mega_ref(*sw_args, comp)
    assert torch.equal(out[3], want[3])
    assert _rel(out[:3], want[:3]) <= TOL["sw_clear_mega"]


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (1100, 4, 7, 5), (1000, 4, 7, 5),
                                                 (256, 16, 3, 3700)])
def test_lw_noscat_reduced_angles_equal_per_angle_launches(cuda, ngpt, nbnd, ncol, nlay):
    """lw_noscat_reduced_angles, 1 to 4 angles in one launch, with and
    without incident flux: bit for bit the one-angle launches summed in the
    angles' order, and against its twin; at 1100 g-points a column spans
    two blocks and at 3700 layers the level sums of every angle count go to
    device memory (2 x nang fields)."""
    k13 = _sweep_case(cuda, ngpt, nbnd, ncol, nlay)[0]
    args, inc = k13[:6], k13[8]
    for n in (1, 2, 3, 4):
        (_, _, in_block), partials = rte_kernels.angles_plan("lw_noscat_reduced", n, nlay, ncol, ngpt, cuda)
        assert in_block == (ngpt <= 1024 and nlay < 1000)
        Ds, wts = angular_discretization(n)
        ds, w = [float(d) for d in Ds], [float(x) for x in wts]
        for flux in (inc, None):
            mega.reset_launch_counts()
            up, dn = rte_kernels.lw_noscat_reduced_angles(*args, ds, w, flux)
            assert _counts() == {"lw_noscat_reduced": 1}
            assert up.shape == dn.shape == (nlay + 1, ncol)
            want = _per_angle(args, ds, w, flux, rte_kernels.lw_noscat_reduced)
            assert torch.equal(up, want[0]) and torch.equal(dn, want[1]), (n, flux is None)
            if nlay < 1000 or n == 2:
                assert _rel((up, dn), rte_kernels.lw_noscat_reduced_angles_ref(*args, ds, w, flux)) <= \
                    TOL["lw_noscat_reduced"]
            assert torch.all(dn[-1] > 0.0) if flux is not None else torch.all(dn[-1] == 0.0)


def test_lw_noscat_reduced_angles_reject_what_the_kernel_does_not_take(cuda):
    """No angle, more than four, secants and weights of other lengths, or an
    incident flux of another shape raise before a launch; a CPU tensor among
    CUDA ones too."""
    k13 = _sweep_case(cuda, 8, 2, 16, 4)[0]
    args, inc = k13[:6], k13[8]
    mega.reset_launch_counts()
    for ds, w in (([], []), ([1.5] * 5, [0.2] * 5), ([1.5, 2.0], [1.0])):
        with pytest.raises(ValueError, match="angles"):
            rte_kernels.lw_noscat_reduced_angles(*args, ds, w)
    with pytest.raises(ValueError, match="shape"):
        rte_kernels.lw_noscat_reduced_angles(*args, [1.5], [1.0], inc[:, :-1].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        rte_kernels.lw_noscat_reduced_angles(*args[:4], args[4].cpu(), args[5], [1.5], [1.0])
    assert _counts() == {}


@pytest.mark.parametrize("nlay", [1, 7, 8, 9, 61])
def test_lw_2stream_reduced_checkpoints_on_every_chunking(cuda, nlay):
    """K14 keeps its adding state at one checkpoint level per chunk of
    LW2_CHUNK layers and replays the chunks top-down: columns shallower than
    a chunk, one layer short of, exactly and one past a chunk, and 61 layers
    (a partial top chunk) hold the twin, with and without incident flux,
    run to run bitwise; with fewer checkpoint levels than the kernel needs
    the entry point refuses the launch."""
    k14 = _sweep_case(cuda, 256, 16, 33, nlay)[1]
    for args in (k14, (*k14[:7], None)):
        out = rte_kernels.lw_2stream_reduced(*args)
        assert _rel(out, rte_kernels.lw_2stream_reduced_ref(*args)) <= TOL["lw_2stream_reduced"]
        assert all(torch.equal(a, b) for a, b in zip(out, rte_kernels.lw_2stream_reduced(*args)))
    design = rte_kernels.lw_2stream_reduced_design(nlay, 256, cuda)
    assert design["checkpoints"] == -(-nlay // rte_kernels.LW2_CHUNK) and design["n_groups"] == 1


def test_lw_2stream_reduced_refuses_too_few_checkpoints(cuda, monkeypatch):
    k14 = _sweep_case(cuda, 32, 4, 5, 17)[1]
    scratch = rte_kernels.lw2_sweep_scratch
    monkeypatch.setattr(rte_kernels, "lw2_sweep_scratch", lambda *a: tuple(t[:-1] for t in scratch(*a)))
    with pytest.raises(RuntimeError, match="lw_2stream_reduced: CUDA error"):
        rte_kernels.lw_2stream_reduced(*k14)


def test_aerosol_bands_stage_what_fits_and_refuse_the_rest(cuda):
    """K5 stages its tables in each block's shared memory: the library's
    count (rrtmgp_aerosol_bands_smem) is the wrapper's staged_bytes, a block
    fits the SM at least once, and a lookup of more RH levels than a block's
    shared memory holds is refused before launch."""
    from rrtmgp_tpu_torch.ops import _build
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab
    from rrtmgp_tpu_torch.ops._launch import smem_limit

    lw, sw, atm, cld, aero, *_ = _allsky_case(cuda, 36, 4, 40, 6)
    for shape in ((16, 5, 7), (14, 5, 7), (16, 5, 36), (4, 3, 2), (15, 5, 9)):
        assert _build.library().rrtmgp_aerosol_bands_smem(*shape) == ab.staged_bytes(*shape)
    lkp = aero[0]
    design = ab.aerosol_bands_design(lkp, cuda)
    assert design["blocks_per_sm"] >= 1 and design["staged"] == ab.staged_bytes(
        lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0])
    nrh, nbnd = 800, lkp.dust.shape[-1]
    assert ab.staged_bytes(nbnd, lkp.size_bin_limits.shape[1], nrh) > smem_limit(cuda)
    big = dataclasses.replace(
        lkp, rh_levels=torch.linspace(0.0, 1.0, nrh, device=cuda),
        sea_salt=lkp.sea_salt[:, :1].expand(-1, nrh, -1, -1).contiguous(),
        sulfate=lkp.sulfate[:, :1].expand(-1, nrh, -1).contiguous(),
        black_carbon_rh=lkp.black_carbon_rh[:, :1].expand(-1, nrh, -1).contiguous(),
        organic_carbon_rh=lkp.organic_carbon_rh[:, :1].expand(-1, nrh, -1).contiguous())
    mega.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        ab.aerosol_bands(big, atm.aerosol_state, atm.rel_hum)
    assert _counts() == {}


# ---------------------------------------------------------------------------
# Gradients (kernel forward, torch backward) and the gray model on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wave,two_stream,impl", [("lw", False, None), ("lw", True, None), ("sw", False, None),
                                                  ("lw", False, "two_kernel"), ("sw", False, "two_kernel")])
def test_differentiable_solve_kernel_forward_torch_backward(cuda, monkeypatch, wave, two_stream, impl):
    """differentiable_solve_lw / _sw on CUDA tensors: the forward launches the
    route's kernels and equals solve_lw / solve_sw on that route bit for
    bit; the gradient of the summed TOA up / surface down flux equals
    torch.autograd.grad through impl="torch" over the same column chunks
    (grad_chunk patched to 384 of the 1000 columns) bit for bit."""
    from rrtmgp_tpu_torch import differentiable_solve_lw, differentiable_solve_sw
    from rrtmgp_tpu_torch.models import rrtmgp
    from rrtmgp_tpu_torch.states import slice_columns

    ncol, nlay, chunk = 1000, 30, 384
    monkeypatch.setattr(rrtmgp, "grad_chunk", lambda lkp, as_: chunk)
    lkp = synthetic_gas_lookup(longwave=wave == "lw", n_gpt=36, n_bnd=4, seed=0 if wave == "lw" else 1,
                               dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=cuda)
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=cuda)
    if wave == "lw":
        bcs, names, solve, make = LwBCs(sfc_emis=f((4, ncol), 0.98)), ("sfc_emis",), solve_lw, differentiable_solve_lw
        loss = lambda flux: flux.flux_up[-1].sum()
    else:
        bcs = SwBCs(cos_zenith=f((ncol,), 0.6), toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((4, ncol), 0.2),
                    sfc_alb_diffuse=f((4, ncol), 0.2))
        names, solve, make = ("cos_zenith", "sfc_alb_direct"), solve_sw, differentiable_solve_sw
        loss = lambda flux: flux.flux_dn[0].sum()
    kw = dict(two_stream=True) if two_stream else {}

    def leaves():
        a = dataclasses.replace(atm, t_lay=atm.t_lay.clone().requires_grad_(True))
        b = dataclasses.replace(bcs, **{n: getattr(bcs, n).clone().requires_grad_(True) for n in names})
        return a, b, [a.t_lay] + [getattr(b, n) for n in names]

    a, b, xs = leaves()
    mega.reset_launch_counts()
    flux = make(lkp, impl=impl, **kw)(a, b)
    assert _counts(), "no kernel launched in the forward"
    plain, _ = solve(lkp, atm, bcs, impl=impl, **kw)
    assert all(torch.equal(x, y) for x, y in zip(flux, plain))
    grads = torch.autograd.grad(loss(flux), xs)
    a, b, xs = leaves()
    ref = None
    for lo in range(0, ncol, chunk):
        hi = min(lo + chunk, ncol)
        part_flux, _ = solve(lkp, slice_columns(a, lo, hi, ncol), slice_columns(b, lo, hi, ncol), impl="torch", **kw)
        part = torch.autograd.grad(loss(part_flux), xs)
        ref = part if ref is None else tuple(r + p for r, p in zip(ref, part))
    for g, r in zip(grads, ref):
        assert torch.isfinite(g).all() and torch.equal(g, r)


def test_gray_equilibrium_graph_equals_eager(cuda):
    """gray_lw_equilibrium in blocks of 64 steps replayed as a CUDA graph
    equals the step-by-step loop bit for bit, ending on max_steps and on a
    tolerance reached mid-block."""
    from rrtmgp_tpu_torch import GrayOpticalThicknessSchneider2004, RRTMGPParameters, gray_lw_equilibrium
    from rrtmgp_tpu_torch import setup_gray_as_pr_grid

    P = RRTMGPParameters()
    atm = setup_gray_as_pr_grid(60, np.linspace(-90.0, 90.0, 9), 1e5, 9e3, GrayOpticalThicknessSchneider2004(), P,
                                dtype=torch.float64, device=cuda)
    emis = torch.ones(9, dtype=torch.float64, device=cuda)
    tol_mid = float(gray_lw_equilibrium(atm, emis, P, max_steps=100, block=1)[2]) * (1.0 + 1e-9)
    for max_steps, tol in ((200, 1e-5), (400, tol_mid)):
        one = gray_lw_equilibrium(atm, emis, P, max_steps=max_steps, flux_grad_tol=tol, block=1)
        graph = gray_lw_equilibrium(atm, emis, P, max_steps=max_steps, flux_grad_tol=tol, block=64)
        assert int(one[3]) == int(graph[3]) <= max_steps
        for x, y in ((one[0].t_lay, graph[0].t_lay), (one[0].t_lev, graph[0].t_lev), (one[1], graph[1]),
                     (one[2], graph[2])):
            assert torch.equal(x, y)
    assert int(one[3]) <= 101


@pytest.mark.parametrize("two_stream", [False, True])
def test_gray_solver_on_the_card_equals_the_cpu(cuda, two_stream):
    """RRTMGPSolver(GrayRadiation()) on CUDA tensors against the same solver
    on the CPU, f64: the same plain-torch operations (1e-12 of the largest
    flux: CUDA's exp and pow may differ from the CPU's by an ulp)."""
    from rrtmgp_tpu_torch import (GrayOpticalThicknessOGorman2008, GrayRadiation, RRTMGPGridParams,
                                  RRTMGPParameters, RRTMGPSolver, setup_gray_as_pr_grid)

    P, ncol, out = RRTMGPParameters(), 257, []
    for dev in (cuda, torch.device("cpu")):
        atm = setup_gray_as_pr_grid(60, np.linspace(-80.0, 80.0, ncol), 1e5, 9e3, GrayOpticalThicknessOGorman2008(), P,
                                    dtype=torch.float64, device=dev)
        f = lambda shape, v: torch.full(shape, v, dtype=torch.float64, device=dev)
        mu0 = torch.linspace(-0.3, 1.0, ncol, dtype=torch.float64, device=dev)
        s = RRTMGPSolver(RRTMGPGridParams(nlay=60, ncol=ncol, dtype=torch.float64), GrayRadiation(), P,
                         LwBCs(sfc_emis=f((1, ncol), 0.95)),
                         SwBCs(cos_zenith=mu0, toa_flux=f((ncol,), 1361.0), sfc_alb_direct=f((1, ncol), 0.1),
                               sfc_alb_diffuse=f((1, ncol), 0.1)), atm,
                         two_stream_lw=two_stream, two_stream_sw=two_stream)
        out.append(s.update_fluxes())
    for a, b in zip((*out[0][0], *out[0][1]), (*out[1][0], *out[1][1])):
        assert a.is_cuda
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-12 * max(scale, 1.0)
