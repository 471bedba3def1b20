"""The port's utilities (rrtmgp_tpu_torch.utils.perf_accounting, .profiling,
.debug) against the JAX package's where both compute a number, and their
own contracts where the port's differ (torch.profiler, the NaN dispatch
check, compilations that really fail)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.utils import perf_accounting as jpa
from rrtmgp_tpu.utils import profiling as jprof
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere
from rrtmgp_tpu_torch.ops import _build
from rrtmgp_tpu_torch.states import tree_leaves
from rrtmgp_tpu_torch.utils import debug, perf_accounting, profiling

NCOL, NLAY = 16, 8


@pytest.mark.parametrize("two_stream", [False, True])
@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("shape", [(32, 4), (256, 16)], ids=["small", "full"])
def test_algorithmic_flops_equals_jax(shape, longwave, two_stream):
    n_gpt, n_bnd = shape
    jl = jsyn.synthetic_gas_lookup(longwave=longwave, n_gpt=n_gpt, n_bnd=n_bnd, n_press=12, n_temp=6)
    pl = convert.gas_lookup_from_object(jl, device="cpu")
    for ncol, nlay in ((NCOL, NLAY), (32768, 60)):
        want = jpa.algorithmic_flops(jl, ncol, nlay, longwave, two_stream)
        got = perf_accounting.algorithmic_flops(pl, ncol, nlay, longwave, two_stream)
        assert isinstance(got, int) and got == want


def test_algorithmic_flops_skips_gas_0():
    """A minor interval without a gas covers no g-point, as in JAX."""
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=4)
    pl = convert.gas_lookup_from_object(jl, device="cpu")
    zeroed = dataclasses.replace(pl, minor_lower=(pl.minor_lower[0]._replace(gas=0), *pl.minor_lower[1:]))
    jzero = dataclasses.replace(jl, minor_lower=(jl.minor_lower[0]._replace(gas=0), *jl.minor_lower[1:]))
    a = perf_accounting.algorithmic_flops(zeroed, NCOL, NLAY, True, False)
    assert a == jpa.algorithmic_flops(jzero, NCOL, NLAY, True, False)
    assert a != perf_accounting.algorithmic_flops(pl, NCOL, NLAY, True, False)


def test_tree_bytes_and_solve_bytes():
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, with_aerosols=True, device="cpu")
    want = sum(x.numel() * x.element_size() for x in tree_leaves(atm))
    assert perf_accounting.tree_bytes(atm) == want > 0
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, with_aerosols=True)
    assert want == jpa.tree_bytes(ja)  # the same leaves, the same dtypes
    flux = (torch.zeros(NLAY + 1, NCOL), torch.zeros(NLAY + 1, NCOL))
    tabs = torch.zeros(3, 5, dtype=torch.float64)
    got = perf_accounting.solve_hbm_bytes(atm, flux, tabs, (flux[0],))
    assert got == want + 2 * 4 * (NLAY + 1) * NCOL + 8 * 15 + 2 * 4 * (NLAY + 1) * NCOL
    assert perf_accounting.HBM_BYTES_PER_S == 3.35e12
    assert perf_accounting.PEAK_OPS_PER_S == {"f32": 67e12, "f64": 33.5e12}
    assert not hasattr(perf_accounting, "mega_mxu_flops")


def test_benchmark_keys_as_jax():
    f = lambda x: torch.cumsum(x, 0)
    out = profiling.benchmark(f, torch.ones(64), n_iters=3, warmup=1, label="cumsum")
    ref = jprof.benchmark(lambda x: jnp.cumsum(x), jnp.ones(64), n_iters=3, warmup=1, label="cumsum")
    assert set(out) == set(ref) == {"label", "median_s", "min_s", "n_iters"}
    assert out["label"] == "cumsum" and out["n_iters"] == 3
    assert 0 < out["min_s"] <= out["median_s"]


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.linalg.matmul(torch.ones(32, 32), torch.ones(32, 32))
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_memory_stats() == {}


def _gray_case():
    P = rt.RRTMGPParameters()
    atm = rt.setup_gray_as_pr_grid(NLAY, torch.linspace(-60.0, 60.0, NCOL, dtype=torch.float64), 1e5, 9e3,
                                   rt.GrayOpticalThicknessSchneider2004(), P, dtype=torch.float64, device="cpu")
    return atm, P


def test_strict_mode_clean_solve():
    """tests/test_debug_utils.py on the port: a gray solve runs clean under
    strict mode, and so do the full-physics solves of the all-sky solver."""
    atm, P = _gray_case()
    with debug.strict_mode():
        up, dn, net = rt.solve_gray_lw(atm, torch.ones(NCOL, dtype=torch.float64), P)
    assert torch.isfinite(up).all()

    L = rt.lookup_tables(rt.AllSkyRadiation(True), dtype=torch.float32, device="cpu")
    a = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=True, with_aerosols=True,
                             device="cpu")
    f = lambda shape, v: torch.full(shape, v)
    bl = rt.LwBCs(sfc_emis=f((16, NCOL), 0.98))
    bs = rt.SwBCs(cos_zenith=f((NCOL,), 0.6), toa_flux=f((NCOL,), 1361.0), sfc_alb_direct=f((14, NCOL), 0.2),
                  sfc_alb_diffuse=f((14, NCOL), 0.2))
    for two_stream in (True, False):
        s = rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL), rt.AllSkyRadiation(True),
                            rt.RRTMGPParameters(), bl, bs, a, lookups=L, two_stream_lw=two_stream)
        with debug.strict_mode():
            lw, sw = s.update_fluxes()
        assert all(torch.isfinite(x).all() for x in (*lw, *sw))


def test_strict_mode_catches_nan():
    with debug.strict_mode(leaks=False):
        with pytest.raises(FloatingPointError):
            torch.log(torch.zeros(4) - 1.0)
    torch.log(torch.zeros(4) - 1.0)  # outside the block: no check
    atm, P = _gray_case()
    t_lev = atm.t_lev.clone()
    t_lev[3, 2] = float("nan")
    bad = dataclasses.replace(atm, t_lev=t_lev)
    with debug.strict_mode(), pytest.raises(FloatingPointError):
        rt.solve_gray_lw(bad, torch.ones(NCOL, dtype=torch.float64), P)
    with debug.strict_mode(nans=False):
        torch.log(torch.zeros(4) - 1.0)


def test_strict_mode_checks_kernel_outputs():
    """A kernel wrapper's launch check raises on a NaN output only inside
    strict mode (the kernels write their outputs where no operation sees
    them); uninitialised storage does not count."""
    out = torch.tensor([1.0, float("nan")])
    _build.check(0, "lw_clear_mega", out)
    with debug.strict_mode():
        torch.empty(1000)
        with pytest.raises(FloatingPointError, match="lw_clear_mega"):
            _build.check(0, "lw_clear_mega", torch.ones(3), out)
        _build.check(0, "lw_clear_mega", torch.ones(3), None)


def test_assert_compiles_once():
    """Building one lookup's kernel tables twice fails; building each once,
    or reusing them, passes; the log names what was built."""
    L = rt.lookup_tables(rt.ClearSkyRadiation(), dtype=torch.float32, device="cpu")
    with debug.assert_compiles_once() as log:
        L.lookup_lw.kernel_tables
        L.lookup_sw.kernel_tables
        L.lookup_lw.kernel_tables  # cached: no rebuild
    assert log == ["kernel_tables LW 256 g-points float32 cpu", "kernel_tables SW 224 g-points float32 cpu"]
    with debug.assert_compiles_once() as log:
        L.lookup_lw.kernel_tables
    assert log == []
    with pytest.raises(AssertionError, match="kernel_tables LW 256"):
        with debug.assert_compiles_once():
            L.lookup_lw.to("cpu").kernel_tables  # a new lookup each step: rebuilt
            L.lookup_lw.to("cpu").kernel_tables
    with pytest.raises(AssertionError, match="nvcc"):
        with debug.assert_compiles_once("nvcc"):
            debug.note_compile("nvcc", "librrtmgp_kernels_0.so")
            debug.note_compile("nvcc", "librrtmgp_kernels_0.so")
    with debug.assert_compiles_once("nvcc"):
        L.lookup_lw.to("cpu").kernel_tables  # counted only by name
        L.lookup_lw.to("cpu").kernel_tables


def test_check_window_true():
    L = rt.lookup_tables(rt.ClearSkyRadiation(), dtype=torch.float32, device="cpu")
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, device="cpu")
    assert debug.check_window(L.lookup_lw, atm, 1) is True
