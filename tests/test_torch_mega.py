"""The kernel modules' plain twins (rrtmgp_tpu_torch.ops.mega *_ref) against
the JAX Pallas kernels they replace, run in interpret mode on the CPU.

- planck_band_ref vs planck_band_pallas_t and planck_band_windowed;
- lw_clear_mega_ref / sw_clear_mega_ref vs the JAX megakernel path of
  solve_lw / solve_sw, set up as tests/test_pallas_optics.py does (ncol 128),
  at 5e-5 (LW) and 1e-4 (SW) of max |flux|, the JAX megakernel-vs-XLA
  tolerances: the Pallas kernels contract bf16 hi/lo table splits;
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
    assert mega.launch_counts() == {"planck_band": 0, "lw_clear_mega": 0, "sw_clear_mega": 0}


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
    from rrtmgp_tpu_torch.data.synthetic import synthetic_gas_lookup

    tl = synthetic_gas_lookup(n_gpt=8, n_bnd=2, dtype=np.float32)
    t = torch.full((4,), 250.0, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mega.planck_band(t, tl.totplnk.to("meta"), tl.t_planck_min, tl.t_planck_delta)
