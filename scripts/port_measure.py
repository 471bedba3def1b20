"""Measurements of the PyTorch/CUDA port (rrtmgp_tpu_torch) on one NVIDIA GPU
that chip_smoke.py does not print. Run from the repository root:

    python3 scripts/port_measure.py [f64-memory] [angles] [profile] [profile-two-kernel]

With no argument it runs all four. Each line names what it measured; the
first line is the card's name and power limit. Problem sizes and inputs are
chip_smoke.py's (its set-up functions are imported). Needs CUDA and nvcc;
imports no JAX.

- ``f64-memory``: peak device bytes per column of the f64 torch path
  (``torch.cuda.max_memory_allocated()`` above what is allocated before the
  call), at two column counts, as a multiple of one f64 (nlay, ncol, ngpt)
  tensor: the factor behind RRTMGPSolver's f64 auto-chunk budget.
- ``angles``: time of solve_lw (LW no-scattering) with 1-4 quadrature angles
  on both kernel routes, impl="kernel" (one megakernel launch per angle) and
  impl="two_kernel" (the optics once, one sweep per angle): f32 clear sky at
  32768 x 60 and f32 all-sky with aerosols at 75748 x 60; f64 clear sky on
  the megakernel route (the two-kernel path is f32). Every f32 case is
  timed in three rounds, the routes taking turns (each time a median of 3
  calls), with the peak device memory of each all-sky solve: the numbers
  behind the routing of several angles.
- ``profile``: torch.profiler over 3 steps of the f64 clear solver (32768 x
  60) and of the all-sky no-scattering solver (75748 x 60): device time by
  kernel and the device's busy share of the step.
- ``profile-two-kernel``: the same over 3 steps of the two-kernel cell
  (solve_lw with 3 angles and solve_sw through impl="two_kernel", then the SW
  direct-beam solve with the default impl, f32 clear sky at 32768 x 60).
"""

from __future__ import annotations

import pathlib
import sys
import time
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def say(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def f64_memory() -> None:
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables, solve_lw, solve_sw

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float64, device=cs.DEVICE)
    lw, sw = L.lookup_lw, L.lookup_sw
    allsky_lw = dict(lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero, cld_mask_seed=3)
    allsky_sw = dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero, cld_mask_seed=3)
    cases = (
        ("LW no-scattering, clear", lw, solve_lw, dict()),
        ("LW no-scattering, clear, 3 angles", lw, solve_lw, dict(n_gauss_angles=3)),
        ("LW no-scattering, clouds + aerosols", lw, solve_lw, allsky_lw),
        ("LW two-stream, clouds + aerosols", lw, solve_lw, dict(two_stream=True, **allsky_lw)),
        ("SW two-stream, clear", sw, solve_sw, dict()),
        ("SW two-stream, clouds + aerosols", sw, solve_sw, allsky_sw),
    )
    for ncol in (1024, 2048):
        atm = cs.atmosphere(ncol, cs.NLAY, "float64", with_clouds=True, with_aerosols=True)
        bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, ncol)
        for what, lkp, solve, kw in cases:
            bcs = bcs_lw if lkp is lw else bcs_sw
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            flux, _ = solve(lkp, atm, bcs, impl="torch", **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del flux
            one = cs.NLAY * ncol * lkp.n_gpt * 8
            say("f64-memory", f"{what}, torch path, ncol {ncol} x {cs.NLAY} x {lkp.n_gpt}: peak {peak / 1e9:.3f} GB, "
                              f"{peak / ncol / 1e6:.3f} MB per column, {peak / one:.1f} tensor-equivalents")
    # the f64 kernel path: inputs and two scratch tensors
    ncol = 2048
    atm = cs.atmosphere(ncol, cs.NLAY, "float64")
    bcs_lw, _ = cs.boundary_conditions(lw, sw, ncol)
    solve_lw(lw, atm, bcs_lw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    solve_lw(lw, atm, bcs_lw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    say("f64-memory", f"LW no-scattering, clear, f64 kernel path, ncol {ncol}: peak {peak / 1e9:.3f} GB, "
                      f"{peak / ncol / 1e6:.3f} MB per column, {peak / (cs.NLAY * ncol * lw.n_gpt * 8):.1f} "
                      "tensor-equivalents")


def _rounds(impls, solve, rounds: int = 3) -> dict:
    """{impl: [median ms of 3 calls, one per round]}, the impls taking turns
    within a round so that a drift of the card's clock meets both alike."""
    ms = {impl: [] for impl in impls}
    for _ in range(rounds if len(impls) > 1 else 1):
        for impl in impls:
            ms[impl].append(cs.timed(lambda: solve(impl), 3))
    return ms


def _fmt(times) -> str:
    return " / ".join(f"{t:.3f}" for t in times)


def angles() -> None:
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables, solve_lw

    routes = {"float32": ("kernel", "two_kernel"), "float64": ("kernel",)}
    for dtype in ("float32", "float64"):
        lw, sw = cs.lookups(256, 16, 224, 14, dtype)
        atm = cs.atmosphere(cs.NCOL, cs.NLAY, dtype)
        bcs_lw, _ = cs.boundary_conditions(lw, sw, cs.NCOL)
        for n in (1, 2, 3, 4):
            ms = _rounds(routes[dtype], lambda impl: solve_lw(lw, atm, bcs_lw, n_gauss_angles=n, impl=impl))
            for impl in routes[dtype]:
                say("angles", f"solve_lw clear {dtype} {cs.NCOL} x {cs.NLAY}, {n} angle(s), impl={impl}: "
                              f"{_fmt(ms[impl])} ms")
        del lw, sw, atm, bcs_lw
        torch.cuda.empty_cache()
    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    atm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
    bcs_lw, _ = cs.boundary_conditions(L.lookup_lw, L.lookup_sw, cs.ALLSKY_NCOL)
    for n in (1, 2, 3, 4):
        solve = lambda impl: solve_lw(L.lookup_lw, atm, bcs_lw, n_gauss_angles=n, lkp_cld=L.lookup_lw_cld,
                                      lkp_aero=L.lookup_lw_aero, cld_mask_seed=cs.MCICA_SEED, impl=impl)
        ms = _rounds(routes["float32"], solve)
        for impl in routes["float32"]:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            solve(impl)
            torch.cuda.synchronize()
            say("angles", f"solve_lw all-sky + aerosols float32 {cs.ALLSKY_NCOL} x {cs.NLAY}, {n} angle(s), "
                          f"impl={impl}: {_fmt(ms[impl])} ms, peak memory "
                          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def _profile(tag: str, step, steps: int = 3) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = [(e.key, getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0), e.count)
            for e in prof.key_averages()]
    rows = [(k, t / 1e3 / steps, c / steps) for k, t, c in rows if t > 0 and not k.startswith(("aten::", "cuda"))]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t, _ in rows)
    say(tag, f"step under the profiler {wall_ms:.3f} ms; device kernels {busy:.3f} ms per step "
             f"({100 * busy / wall_ms:.1f}% busy), {sum(c for _, _, c in rows):.0f} launches per step")
    for k, t, c in rows[:12]:
        say(tag, f"  {t:10.3f} ms  {c:8.1f} launches  {k[:110]}")
    rest = rows[12:]
    say(tag, f"  {sum(t for _, t, _ in rest):10.3f} ms  {sum(c for _, _, c in rest):8.1f} launches  (all other kernels)")


def profile_cells() -> None:
    import torch

    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        ClearSkyRadiation,
        LookupBundle,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
        lookup_tables,
    )

    lw, sw = cs.lookups(256, 16, 224, 14, "float64")
    atm = cs.atmosphere(cs.NCOL, cs.NLAY, "float64")
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    solver = RRTMGPSolver(RRTMGPGridParams(nlay=cs.NLAY, ncol=cs.NCOL, dtype=torch.float64),
                          ClearSkyRadiation(False), RRTMGPParameters(), bcs_lw, bcs_sw, atm,
                          lookups=LookupBundle(lookup_lw=lw, lookup_sw=sw), two_stream_lw=False)
    _profile("profile f64 clear LW", solver.update_lw_fluxes)
    _profile("profile f64 clear SW", solver.update_sw_fluxes, steps=1)
    del solver, atm, bcs_lw, bcs_sw, lw, sw
    torch.cuda.empty_cache()

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    atm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(L.lookup_lw, L.lookup_sw, cs.ALLSKY_NCOL)
    solver = RRTMGPSolver(RRTMGPGridParams(nlay=cs.NLAY, ncol=cs.ALLSKY_NCOL), AllSkyRadiation(True),
                          RRTMGPParameters(), bcs_lw, bcs_sw, atm, lookups=L, two_stream_lw=False)

    def step():
        solver.advance_step()
        solver.update_fluxes()

    _profile("profile all-sky no-scattering", step)


def profile_two_kernel() -> None:
    from rrtmgp_tpu_torch import solve_lw, solve_sw

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)

    def step():
        solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="two_kernel")
        solve_sw(sw, atm, bcs_sw, impl="two_kernel")
        solve_sw(sw, atm, bcs_sw, two_stream=False)

    _profile("profile two-kernel", step)
    for name, fn in (("LW 3 angles", lambda: solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="two_kernel")),
                     ("SW two-stream", lambda: solve_sw(sw, atm, bcs_sw, impl="two_kernel")),
                     ("SW direct beam", lambda: solve_sw(sw, atm, bcs_sw, two_stream=False))):
        say("profile two-kernel", f"{name} alone, no profiler: {cs.timed(fn, 3):.3f} ms")


def main() -> None:
    want = sys.argv[1:] or ["f64-memory", "angles", "profile", "profile-two-kernel"]
    cs.phase_device()
    cs.phase_build()
    warnings.simplefilter("ignore")  # the f64 torch-path and auto-chunk notices
    for name, fn in (("f64-memory", f64_memory), ("angles", angles), ("profile", profile_cells),
                     ("profile-two-kernel", profile_two_kernel)):
        if name in want:
            fn()


if __name__ == "__main__":
    main()
