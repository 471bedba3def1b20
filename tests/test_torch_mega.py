"""The kernel modules' plain twins (rrtmgp_tpu_torch.ops.mega *_ref) against
the JAX Pallas kernels they replace, run in interpret mode on the CPU.

- planck_band_ref vs planck_band_pallas_t and planck_band_windowed;
  planck_band_sets (one launch for every temperature set of a solve) on
  CPU tensors bit for bit the per-set twins, and so within 5e-5 of both;
  chip_smoke.py's grid_sample yardstick within 1e-6 (f32) and 1e-14 (f64)
  of the twin;
- lw_clear_mega_ref / sw_clear_mega_ref vs the JAX megakernel path of
  solve_lw / solve_sw, set up as tests/test_pallas_optics.py does (ncol 128),
  at 5e-5 (LW) and 1e-4 (SW) of max |flux|, the JAX megakernel-vs-XLA
  tolerances: the Pallas kernels contract bf16 hi/lo table splits;
- lw_clear_mega_ref composed (cloud mask, cloud mask + aerosols, McICA
  seed + aerosols, aerosols alone: absorption only) vs the JAX megakernel
  path in interpret mode at 1e-4 of max |flux| (the tolerance of
  tests/test_pallas_optics.py for the same comparison) and vs the JAX XLA
  path at 1e-5; cloud cover at rtol 1e-6;
- lw2_mega_ref and the all-sky sw_clear_mega_ref vs the JAX megakernel
  path (lw2_mega / sw_clear_mega in interpret mode) clear, with a cloud
  mask, with a cloud mask and aerosols, and with a McICA seed and some
  aerosol species (the JAX side then runs aerosol_bands_pallas; off the TPU
  it draws the same threefry mask), at 1e-4 of max |flux|; cloud cover at
  rtol 1e-6, AOD at 1e-6 (3e-5 through aerosol_bands_pallas);
- aerosol_bands_ref vs aerosol_bands_pallas;
- on CPU tensors the wrappers run their twins and launch nothing.

The CUDA kernels themselves run only on a GPU; chip_smoke.py holds them
against these twins there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.ops import gas_optics_pallas as gp
from rrtmgp_tpu.states import LwBCs, SwBCs
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.angular import angular_discretization
from rrtmgp_tpu_torch.ops import mega
from rrtmgp_tpu_torch.ops.cloud_bands import cloud_bands
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

NCOL, NLAY = 128, 6


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.numpy().astype(np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / (np.abs(ref).max() + 1e-300)


@pytest.fixture(autouse=True)
def _zero_counts():
    mega.reset_launch_counts()
    yield
    # CPU tensors run the plain twins: no kernel may have launched
    assert set(mega.launch_counts().values()) == {0}


def test_planck_band_ref_matches_pallas_kernels():
    """Both TPU band-Planck kernels (full table and windowed) against the
    twin at t_lay, t_lev and t_sfc, plus points beyond the table. 5e-5: the
    Pallas kernels drop the lo*lo term of their bf16 hi/lo product."""
    from rrtmgp_tpu.ops.pallas_mega import planck_band_pallas_t, planck_band_windowed

    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32)
    tl = convert.gas_lookup_from_object(jl)
    tabs = gp.build_pallas_tables(jl)
    kw = dict(n_t=int(jl.totplnk.shape[0]), t_min=float(jl.t_planck_min),
              t_delta=float(jl.t_planck_delta), nbp_sub=8)
    wr = gp.compute_planck_window(jl, ja)
    for t in (ja.t_lay, ja.t_lev, ja.t_sfc):
        t = np.array(t).reshape(-1)
        port = mega.planck_band(torch.from_numpy(t), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
        ref = mega.planck_band_ref(torch.from_numpy(t), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
        assert torch.equal(port, ref)
        assert port.shape == (jl.n_bnd, t.size)
        full = planck_band_pallas_t(jnp.asarray(t), tabs.totplnk_t, **kw)[: jl.n_bnd]
        win, ok = planck_band_windowed(jnp.asarray(t), tabs.totplnk_rows, wr=wr, **kw)
        assert bool(ok)
        assert _rel(port, full) < 5e-5, _rel(port, full)
        assert _rel(port, win[: jl.n_bnd]) < 5e-5, _rel(port, win[: jl.n_bnd])
    # beyond the table: clamped to the end values
    t = torch.tensor([100.0, 400.0], dtype=torch.float32)
    out = mega.planck_band_ref(t, tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    assert torch.equal(out[:, 0], tl.totplnk[0]) and torch.equal(out[:, 1], tl.totplnk[-1])


def test_planck_band_sets_equal_the_per_set_twins_and_hold_pallas():
    """The three sets of a solve in one call (the CPU runs the twins): bit
    for bit the per-set twins, and within 5e-5 of both TPU kernels."""
    from rrtmgp_tpu.ops.pallas_mega import planck_band_pallas_t, planck_band_windowed

    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32)
    tl = convert.gas_lookup_from_object(jl)
    tabs = gp.build_pallas_tables(jl)
    kw = dict(n_t=int(jl.totplnk.shape[0]), t_min=float(jl.t_planck_min),
              t_delta=float(jl.t_planck_delta), nbp_sub=8)
    wr = gp.compute_planck_window(jl, ja)
    ts = [np.array(t).reshape(-1) for t in (ja.t_lay, ja.t_lev, ja.t_sfc)]
    tab = (tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    for sets in (ts, ts[1:]):  # LW no-scattering, LW two-stream
        outs = mega.planck_band_sets([torch.from_numpy(t) for t in sets], *tab)
        assert len(outs) == len(sets)
        for out, t in zip(outs, sets):
            assert torch.equal(out, mega.planck_band_ref(torch.from_numpy(t), *tab))
            full = planck_band_pallas_t(jnp.asarray(t), tabs.totplnk_t, **kw)[: jl.n_bnd]
            win, ok = planck_band_windowed(jnp.asarray(t), tabs.totplnk_rows, wr=wr, **kw)
            assert bool(ok)
            assert _rel(out, full) < 5e-5 and _rel(out, win[: jl.n_bnd]) < 5e-5
    for bad in ((), [torch.from_numpy(ts[0])] * 4):
        with pytest.raises(ValueError, match="temperature sets"):
            mega.planck_band_sets(bad, *tab)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-14)])
def test_grid_sample_yardstick_holds_the_planck_twin(dtype, tol):
    """chip_smoke.py's library yardstick of K3 (grid_sample of the table as
    an image) against the twin, temperatures beyond both ends included."""
    import chip_smoke

    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=16, seed=2, dtype=dtype)
    tl = convert.gas_lookup_from_object(jl)
    tab = (tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    t_max = tl.t_planck_min + (tl.totplnk.shape[0] - 1) * tl.t_planck_delta
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.uniform(tl.t_planck_min - 20.0, t_max + 20.0, 5000).astype(dtype))
    want = mega.planck_band_ref(t, *tab)
    assert _rel(chip_smoke.grid_sample_bands(t, *tab), want.numpy()) <= tol


def test_lw_clear_mega_ref_matches_jax_megakernel():
    from rrtmgp_tpu.models.rrtmgp import solve_lw

    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32)
    bcs = LwBCs(sfc_emis=jnp.full((jl.n_bnd, NCOL), 0.98, jnp.float32))
    win = gp.compute_min_window(jl, ja, mega=True)
    ref, _ = solve_lw(
        jl, ja, bcs, pallas_tables=gp.build_pallas_tables(jl), pallas_rte=True,
        pallas_windowed="force", pallas_window=win,
    )

    tl, ta = convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja)
    tabs, inp = tl.kernel_tables, mega_lw_inputs(tl, ta)
    plk = lambda t: mega.planck_band(t.reshape(-1), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    Ds, wts = angular_discretization(1)
    args = (inp, tabs, plk(ta.t_lay), plk(ta.t_lev), plk(ta.t_sfc),
            torch.full((tl.n_bnd, NCOL), 0.98), None, float(Ds[0]), float(wts[0]))
    up, dn = mega.lw_clear_mega(*args)
    up_ref, dn_ref = mega.lw_clear_mega_ref(*args)
    assert torch.equal(up, up_ref) and torch.equal(dn, dn_ref)
    assert up.shape == (NLAY + 1, NCOL)
    assert _rel(up, ref.flux_up) < 5e-5, _rel(up, ref.flux_up)
    assert _rel(dn, ref.flux_dn) < 5e-5, _rel(dn, ref.flux_dn)
    assert torch.all(dn[-1] == 0.0)


def test_sw_clear_mega_ref_matches_jax_megakernel():
    from rrtmgp_tpu.models.rrtmgp import solve_sw

    jl = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32)
    mu0 = np.full((NCOL,), 0.6, np.float32)
    mu0[1::9] = 0.25  # day only: the twin does not zero night columns
    alb_dir = np.full((jl.n_bnd, NCOL), 0.2, np.float32)
    alb_dif = np.full((jl.n_bnd, NCOL), 0.25, np.float32)
    toa = np.full((NCOL,), 1361.0, np.float32)
    bcs = SwBCs(cos_zenith=jnp.asarray(mu0), toa_flux=jnp.asarray(toa),
                sfc_alb_direct=jnp.asarray(alb_dir), sfc_alb_diffuse=jnp.asarray(alb_dif))
    win = gp.compute_min_window(jl, ja, mega=True)
    ref, _ = solve_sw(
        jl, ja, bcs, pallas_tables=gp.build_pallas_tables(jl), pallas_rte=True,
        pallas_windowed="force", pallas_window=win,
    )

    tl, ta = convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja)
    tabs, inp = tl.kernel_tables, mega_sw_inputs(tl, ta)
    toa_gpt = torch.from_numpy(toa)[:, None] * tl.solar_src_scaled[None, :]
    args = (inp, tabs, torch.from_numpy(mu0), toa_gpt, torch.from_numpy(alb_dir),
            torch.from_numpy(alb_dif), None)
    out = mega.sw_clear_mega(*args)
    out_ref = mega.sw_clear_mega_ref(*args)
    for a, b in zip(out, out_ref):
        assert torch.equal(a, b)
    for name, port in zip(("flux_up", "flux_dn", "flux_dn_dir"), out):
        r = _rel(port, getattr(ref, name))
        assert r < 1e-4, (name, r)


def test_wrappers_reject_devices_other_than_cpu_and_cuda():
    """Only CPU tensors take the twin; anything else that is not CUDA raises
    instead of running somewhere else."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_cloud_lookup, synthetic_gas_lookup

    tl = synthetic_gas_lookup(n_gpt=8, n_bnd=2, dtype=np.float32)
    t = torch.full((4,), 250.0, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mega.planck_band(t, tl.totplnk.to("meta"), tl.t_planck_min, tl.t_planck_delta)
    cl = synthetic_cloud_lookup(n_bnd=2, dtype=np.float32)
    cs = synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float32, with_clouds=True).cloud_state
    with pytest.raises(ValueError, match="CUDA"):
        cloud_bands(cl.to("meta"), cs.to("meta"), True)


def test_launch_counts_report_and_reset_every_wrapper():
    """``launch_counts`` reads each kernel wrapper's count, the cloud band
    kernel's among them, and ``reset_launch_counts`` sets each to 0."""
    assert cloud_bands in mega.KERNEL_WRAPPERS
    for i, fn in enumerate(mega.KERNEL_WRAPPERS):
        fn.launches = i + 1
    counts = mega.launch_counts()
    assert counts["cloud_bands"] == mega.KERNEL_WRAPPERS.index(cloud_bands) + 1
    assert counts == {fn.__name__: i + 1 for i, fn in enumerate(mega.KERNEL_WRAPPERS)}
    mega.reset_launch_counts()
    assert set(mega.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# All-sky: lw2_mega, sw_clear_mega with clouds/aerosols, aerosol_bands
# ---------------------------------------------------------------------------

ALLSKY_CASES = {
    "clear": dict(),
    "cloud mask": dict(cloud="mask"),
    "cloud mask+aerosols": dict(cloud="mask", aero=None),
    "seed+aerosols": dict(cloud="seed", aero=(0, 1, 2, 4, 9, 13)),
}
# aero=None: all 15 species, summed by the JAX XLA path (AOD at rtol 1e-6);
# a species tuple: JAX runs aerosol_bands_pallas, whose bf16 hi/lo tables
# hold the AOD to rtol 3e-5 (test_aerosol_bands_ref_matches_pallas_kernel)
SPECIES = (0, 1, 2, 4)


def _random_aerosols(ae):
    """Aerosol mass in the lower half of the column (the synthetic
    atmosphere puts it below 800 hPa only, which a 6-layer column does not
    reach; the thin top layers stay clean, see tests/test_torch_solve.py),
    with empty cells."""
    import dataclasses

    rng = np.random.default_rng(12)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL)).astype(np.float32)
    mass[rng.random(mass.shape) < 0.3] = 0.0
    mass[:, NLAY // 2:] = 0.0
    mass[:, :, ::7] = 0.0  # aerosol-free columns
    size = rng.uniform(0.05, 12.0, (15, NLAY, NCOL)).astype(np.float32)
    return dataclasses.replace(ae, aero_mass=jnp.asarray(mass), aero_size=jnp.asarray(size))


def _allsky_setup(longwave):
    """JAX and port inputs of one all-sky case, fractional cloud fraction."""
    import dataclasses

    import jax

    from rrtmgp_tpu.ops.cloud_optics import build_cloud_mask_mcica

    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=32, n_bnd=4, seed=2, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=True,
                                   with_aerosols=True)
    cf = np.asarray(ja.cloud_state.cld_frac) * np.random.default_rng(8).uniform(
        0.2, 1.0, (NLAY, NCOL)).astype(np.float32)
    ja = dataclasses.replace(ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)),
                             aerosol_state=_random_aerosols(ja.aerosol_state))
    jc = jsyn.synthetic_cloud_lookup(n_bnd=4, dtype=np.float32)
    jae = jsyn.synthetic_aerosol_lookup(n_bnd=4, dtype=np.float32)
    mask = build_cloud_mask_mcica(jax.random.key(3), ja.cloud_state.cld_frac, jl.n_gpt, col_offset=256)
    port = (convert.gas_lookup_from_object(jl), convert.atmosphere_from_object(ja),
            convert.cloud_lookup_from_object(jc), convert.aerosol_lookup_from_object(jae))
    return (jl, ja, jc, jae, mask), port


def _jax_kw(case, jc, jae, mask):
    kw = {}
    if case.get("cloud") == "mask":
        kw.update(lkp_cld=jc, cld_mask=mask)
    elif case.get("cloud") == "seed":
        kw.update(lkp_cld=jc, cld_mask_seed=3, col_offset=256)
    if "aero" in case:
        kw.update(lkp_aero=jae, aero_species=case["aero"])
    return kw


def _port_comp(case, tl, ta, tc, tae, mask, delta):
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition

    cloud = case.get("cloud")
    comp, aod_ext, aod_sca = _kernel_composition(
        tl, ta, tc if cloud else None, tae if "aero" in case else None,
        torch.from_numpy(np.array(mask)) if cloud == "mask" else None, 3 if cloud == "seed" else None,
        256, case.get("aero"), delta, True,
    )
    return comp, aod_ext, aod_sca


@pytest.mark.parametrize("case", list(ALLSKY_CASES))
def test_lw2_mega_ref_matches_jax_megakernel(case):
    from rrtmgp_tpu.models.rrtmgp import solve_lw

    (jl, ja, jc, jae, mask), (tl, ta, tc, tae) = _allsky_setup(True)
    spec = ALLSKY_CASES[case]
    bcs = LwBCs(sfc_emis=jnp.full((jl.n_bnd, NCOL), 0.95, jnp.float32))
    ref, dref = solve_lw(
        jl, ja, bcs, two_stream=True, pallas_tables=gp.build_pallas_tables(jl), pallas_rte=True,
        pallas_windowed="force", pallas_window=gp.compute_min_window(jl, ja, mega=True),
        **_jax_kw(spec, jc, jae, mask),
    )
    comp, _, _ = _port_comp(spec, tl, ta, tc, tae, mask, False)
    plk = lambda t: mega.planck_band(t.reshape(-1), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    args = (mega_lw_inputs(tl, ta), tl.kernel_tables, plk(ta.t_lev), plk(ta.t_sfc),
            torch.full((tl.n_bnd, NCOL), 0.95), None, comp)
    out = mega.lw2_mega(*args)
    for a, b in zip(out, mega.lw2_mega_ref(*args)):
        assert torch.equal(a, b)
    assert _rel(out[0], ref.flux_up) < 1e-4, _rel(out[0], ref.flux_up)
    assert _rel(out[1], ref.flux_dn) < 1e-4, _rel(out[1], ref.flux_dn)
    if spec.get("cloud"):
        from rrtmgp_tpu_torch.ops.cloud_optics import cloud_cover_from_mask

        cover = out[2] if comp.seeded else cloud_cover_from_mask(comp.cld_mask)
        np.testing.assert_allclose(cover.numpy(), np.asarray(dref.cld_cover), rtol=1e-6)


@pytest.mark.parametrize("case", list(ALLSKY_CASES))
def test_allsky_sw_clear_mega_ref_matches_jax_megakernel(case):
    from rrtmgp_tpu.models.rrtmgp import solve_sw

    (jl, ja, jc, jae, mask), (tl, ta, tc, tae) = _allsky_setup(False)
    spec = ALLSKY_CASES[case]
    mu0 = np.full((NCOL,), 0.6, np.float32)
    mu0[1::9] = 0.25  # day only: the twin does not zero night columns
    alb = np.full((jl.n_bnd, NCOL), 0.2, np.float32)
    toa = np.full((NCOL,), 1361.0, np.float32)
    bcs = SwBCs(cos_zenith=jnp.asarray(mu0), toa_flux=jnp.asarray(toa),
                sfc_alb_direct=jnp.asarray(alb), sfc_alb_diffuse=jnp.asarray(alb + 0.05))
    ref, dref = solve_sw(
        jl, ja, bcs, pallas_tables=gp.build_pallas_tables(jl), pallas_rte=True,
        pallas_windowed="force", pallas_window=gp.compute_min_window(jl, ja, mega=True),
        **_jax_kw(spec, jc, jae, mask),
    )
    comp, aod_ext, aod_sca = _port_comp(spec, tl, ta, tc, tae, mask, True)
    toa_gpt = torch.from_numpy(toa)[:, None] * tl.solar_src_scaled[None, :]
    args = (mega_sw_inputs(tl, ta), tl.kernel_tables, torch.from_numpy(mu0), toa_gpt,
            torch.from_numpy(alb), torch.from_numpy(alb + 0.05), None, comp)
    out = mega.sw_clear_mega(*args)
    for a, b in zip(out, mega.sw_clear_mega_ref(*args)):
        assert torch.equal(a, b)
    for name, port in zip(("flux_up", "flux_dn", "flux_dn_dir"), out):
        assert _rel(port, getattr(ref, name)) < 1e-4, (name, _rel(port, getattr(ref, name)))
    if comp.seeded:
        np.testing.assert_allclose(out[3].numpy(), np.asarray(dref.cld_cover), rtol=1e-6)
    if "aero" in spec:
        rtol = 1e-6 if spec["aero"] is None else 3e-5
        np.testing.assert_allclose(aod_ext.numpy(), np.asarray(dref.aod_sw_ext), rtol=rtol)
        np.testing.assert_allclose(aod_sca.numpy(), np.asarray(dref.aod_sw_sca), rtol=rtol)


NOSCAT_CASES = {**{k: v for k, v in ALLSKY_CASES.items() if k != "clear"}, "aerosols": dict(aero=None)}


@pytest.mark.parametrize("case", list(NOSCAT_CASES))
def test_lw_clear_mega_ref_composed_matches_jax_megakernel(case):
    """The LW no-scattering twin with clouds and aerosols (absorption only)
    against the JAX lw_clear_mega in interpret mode, driven as
    tests/test_pallas_optics.py drives it, and against the JAX XLA path."""
    from rrtmgp_tpu.models.rrtmgp import solve_lw

    (jl, ja, jc, jae, mask), (tl, ta, tc, tae) = _allsky_setup(True)
    spec = NOSCAT_CASES[case]
    bcs = LwBCs(sfc_emis=jnp.full((jl.n_bnd, NCOL), 0.95, jnp.float32))
    kw = _jax_kw(spec, jc, jae, mask)
    ref, dref = solve_lw(
        jl, ja, bcs, pallas_tables=gp.build_pallas_tables(jl), pallas_rte=True,
        pallas_windowed="force", pallas_window=gp.compute_min_window(jl, ja, mega=True), **kw,
    )
    xla, dxla = solve_lw(jl, ja, bcs, pallas_rte=False, **kw)
    comp, _, _ = _port_comp(spec, tl, ta, tc, tae, mask, False)
    plk = lambda t: mega.planck_band(t.reshape(-1), tl.totplnk, tl.t_planck_min, tl.t_planck_delta)
    Ds, wts = angular_discretization(1)
    args = (mega_lw_inputs(tl, ta), tl.kernel_tables, plk(ta.t_lay), plk(ta.t_lev), plk(ta.t_sfc),
            torch.full((tl.n_bnd, NCOL), 0.95), None, float(Ds[0]), float(wts[0]))
    out = mega.lw_clear_mega(*args, comp)
    for a, b in zip(out, mega.lw_clear_mega_ref(*args, comp)):
        assert torch.equal(a, b)
    assert len(out) == (3 if comp.seeded else 2)
    clear = mega.lw_clear_mega_ref(*args)
    assert not torch.equal(out[0], clear[0])  # the composition is felt
    for name, port in zip(("flux_up", "flux_dn"), out):
        assert _rel(port, getattr(ref, name)) < 1e-4, (name, _rel(port, getattr(ref, name)))
        assert _rel(port, getattr(xla, name)) < 1e-5, (name, _rel(port, getattr(xla, name)))
    if spec.get("cloud"):
        from rrtmgp_tpu_torch.ops.cloud_optics import cloud_cover_from_mask

        cover = out[2] if comp.seeded else cloud_cover_from_mask(comp.cld_mask)
        np.testing.assert_allclose(cover.numpy(), np.asarray(dref.cld_cover), rtol=1e-6)
        np.testing.assert_allclose(cover.numpy(), np.asarray(dxla.cld_cover), rtol=1e-6)


@pytest.mark.parametrize("species", [None, SPECIES])
def test_aerosol_bands_ref_matches_pallas_kernel(species):
    """The raw band sums against aerosol_bands_pallas. Its bf16 hi/lo
    contraction keeps each table value to ~2^-18 relative, and tau*ssa*g
    multiplies three of them: rtol 3e-5 (1.1e-5 seen)."""
    from rrtmgp_tpu.ops.pallas_aerosol import aerosol_bands_pallas
    from rrtmgp_tpu_torch.ops.aerosol_bands import aerosol_bands, aerosol_bands_ref

    (_, ja, _, jae, _), (_, ta, _, tae) = _allsky_setup(True)
    rng = np.random.default_rng(9)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL)).astype(np.float32)
    mass[rng.random(mass.shape) < 0.3] = 0.0
    size = rng.uniform(0.05, 12.0, (15, NLAY, NCOL)).astype(np.float32)
    rh = rng.uniform(0.0, 1.1, (NLAY, NCOL)).astype(np.float32)
    from rrtmgp_tpu.states import AerosolState as JAerosolState
    from rrtmgp_tpu_torch import AerosolState

    ref = aerosol_bands_pallas(jae, JAerosolState(aero_size=jnp.asarray(size), aero_mass=jnp.asarray(mass)),
                               jnp.asarray(rh), tuple(range(15)) if species is None else species)
    ae = AerosolState(aero_size=torch.from_numpy(size), aero_mass=torch.from_numpy(mass))
    out = aerosol_bands(tae, ae, torch.from_numpy(rh), species)
    for a, b, r in zip(out, aerosol_bands_ref(tae, ae, torch.from_numpy(rh), species), ref):
        assert torch.equal(a, b)
        assert a.shape == (NLAY, tae.dust.shape[-1], NCOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(r)[:, : a.shape[1]], rtol=3e-5, atol=1e-12)
