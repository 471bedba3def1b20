"""The CUDA kernels of rrtmgp_tpu_torch.ops.mega on the card (marker ``gpu``).

Each test skips where ``torch.cuda.is_available()`` is false. On a machine
with an NVIDIA GPU, run them without the JAX test configuration of
tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

They cover what chip_smoke.py does not: the incident-flux inputs of both
megakernels, odd shapes, run-to-run determinism, the wrappers' argument
checks on CUDA tensors, and the launch counts of solve_lw / solve_sw.
Tolerances as chip_smoke.py: max |kernel - twin| / max |twin| <= 1e-6
(Planck), 5e-5 (LW), 1e-4 (SW).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rrtmgp_tpu_torch import LwBCs, SwBCs, solve_lw, solve_sw
from rrtmgp_tpu_torch.angular import angular_discretization
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu_torch.ops import mega
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

pytestmark = pytest.mark.gpu

TOL = {"planck_band": 1e-6, "lw_clear_mega": 5e-5, "sw_clear_mega": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    mega.reset_launch_counts()
    return torch.device("cuda")


def _rel(out, ref) -> float:
    err = scale = 0.0
    for a, b in zip(out, ref):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        err = max(err, (a.double() - b.double()).abs().max().item())
        scale = max(scale, b.double().abs().max().item())
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


@pytest.mark.parametrize("ngpt,nbnd,ncol,nlay", [(36, 4, 1000, 30), (256, 16, 257, 60), (5, 5, 3, 2)])
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
    assert mega.launch_counts() == {"planck_band": 3, "lw_clear_mega": 1, "sw_clear_mega": 1}


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
    assert mega.launch_counts() == {"planck_band": 3, "lw_clear_mega": 0, "sw_clear_mega": 0}


def test_more_than_1024_gpoints_raises(cuda):
    lkp = synthetic_gas_lookup(longwave=True, n_gpt=1040, n_bnd=4, n_eta=3, n_press=4, n_temp=3,
                               dtype=np.float32, device=cuda)
    atm = synthetic_atmosphere(ncol=4, nlay=3, dtype=np.float32, device=cuda)
    with pytest.raises(ValueError, match="1..1024"):
        solve_lw(lkp, atm, LwBCs(sfc_emis=torch.full((4, 4), 0.98, device=cuda)))


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
    assert mega.launch_counts() == {"planck_band": 3, "lw_clear_mega": 1, "sw_clear_mega": 1}
    t_lw, _ = solve_lw(lw, atm, bl, impl="torch")
    t_sw, _ = solve_sw(sw, atm, bs, impl="torch")
    assert mega.launch_counts()["lw_clear_mega"] == 1
    assert _rel(k_lw, t_lw) <= TOL["lw_clear_mega"]
    assert _rel(k_sw, t_sw) <= TOL["sw_clear_mega"]
    for flux in k_sw:
        assert torch.all(flux[:, mu0 <= 0] == 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve_lw(lw, atm, bl, n_gauss_angles=2)
    with pytest.raises(TypeError, match="float32"):
        solve_lw(lw.to(dtype=torch.float64), atm.to(dtype=torch.float64),
                 dataclasses.replace(bl, sfc_emis=bl.sfc_emis.double()))
