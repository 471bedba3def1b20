"""Measurements of the PyTorch/CUDA port (rrtmgp_tpu_torch) on one NVIDIA GPU
that chip_smoke.py does not print. Run from the repository root:

    python3 scripts/port_measure.py [f64-memory] [angles] [profile] [profile-two-kernel] [profile-sweep]
    python3 scripts/port_measure.py profile-two-kernel --unfused
    python3 scripts/port_measure.py --root CHECKOUT kernel-hashes
    python3 scripts/port_measure.py [--root CHECKOUT] megakernels
    python3 scripts/port_measure.py [--root CHECKOUT] gather [--tiles 4,8,16,32] [--k1]
    python3 scripts/port_measure.py [--root CHECKOUT] sw-sweep
    python3 scripts/port_measure.py [--root CHECKOUT] lw-sweep
    python3 scripts/port_measure.py [--root CHECKOUT] sw-mega
    python3 scripts/port_measure.py [--root CHECKOUT] lw2-sweep
    python3 scripts/port_measure.py [--root CHECKOUT] lw-gpt
    python3 scripts/port_measure.py [--root CHECKOUT] aerosol
    python3 scripts/port_measure.py [--root CHECKOUT] planck
    python3 scripts/port_measure.py mesh        # every visible card, e.g. four H100s on one host

With no argument it runs the first five. Each line names what it measured; the
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
  behind the routing of several angles. Then LW two-stream on its three
  kernel routes, in the same rounds: impl="kernel" (the megakernel),
  impl="two_kernel" (optics kernel, plain-torch sources and composition,
  the sweep from materialized sources) and impl="sweep" (plain-torch optics,
  the same sweep), clear at 32768 x 60 and all-sky at 75748 x 60 with each
  route's peak memory; the all-sky sweep route runs through solve_chunked in
  16384-column chunks (its plain-torch optics would not fit the card whole).
- ``profile``: torch.profiler over 3 steps of the f64 clear solver (32768 x
  60) and of the all-sky no-scattering solver (75748 x 60): device time by
  kernel and the device's busy share of the step.
- ``profile-two-kernel``: the same over 3 steps of the two-kernel cell
  (solve_lw with 3 angles and solve_sw through impl="two_kernel", then the SW
  direct-beam solve with the default impl, f32 clear sky at 32768 x 60).
  With ``--unfused`` also over the same step with ``fused_optics=False``
  (the unfused optics: interp_pt_eta twice and interp_minor once per solve
  in place of optics_fused), each solve of both steps timed alone, and the
  fused and the unfused optics of one LW and one SW solve timed alone.
- ``profile-sweep``: the same over the sweep cell's step (solve_lw with 3
  angles, solve_lw two-stream and solve_sw through impl="sweep", f32 clear
  sky at 32768 x 60), and over solve_lw two-stream through impl="two_kernel"
  and through impl="kernel" on the same inputs.
- ``kernel-hashes``: median time of 7 calls, sha256 of the outputs and
  register counts of the kernels whose device code lives in shared headers
  (sw_2stream_reduced, sw_clear_mega clear, lw_clear_mega, optics_fused,
  lw_noscat_banded_reduced at 1 angle and at 3 (with and without an
  incident flux; one launch where the checkout has lw_noscat_banded_angles,
  else one per angle, summed), solve_lw's LW fluxes with 3 angles on the
  two-kernel and the unfused route, interp_pt_eta for each table,
  interp_minor and the four sweeps from materialized sources on the clear
  cell (sw_2stream_gpt also with an incident diffuse flux and, at 8192
  columns, with ssa and g of an all-sky composition, with and without one;
  lw_noscat_gpt also with an incident flux), lw_noscat_reduced also at 1
  angle with an incident flux and at 3
  angles with and without one (one launch where the checkout has
  lw_noscat_reduced_angles, else one per angle, summed); lw_clear_mega
  built for f64 on the clear cell in f64; lw2_mega and the composed
  lw_clear_mega on the all-sky cell with McICA by seed + aerosols, lw2_mega
  also clear; mcica_mask_export; sw_clear_mega with a cloud mask given
  (with and without aerosols), McICA by seed + aerosols and aerosols alone
  on the all-sky cell, and clear and seeded at 1100 g-points (64 x 12) and
  at 800 layers (512 columns); the cloud cover is hashed with the
  fluxes). ``--root CHECKOUT``
  imports chip_smoke.py and the package from another checkout and builds
  there. To show that a change of a shared header left those kernels as
  they were, unpack the parent commit into a directory that .gitignore
  lists (``git archive <commit> | tar -x -C scratch_chip/parent``) and run
  this mode on the two roots in turns within one call (parent, change,
  change, parent): equal hashes are bitwise-equal fluxes on equal inputs,
  and the times compare on one card.
- ``megakernels``: the two-stream megakernels at full width, each the
  median of 7 synchronized calls: sw_clear_mega on the clear cell (32768 x
  60, 224 g-points) and on the all-sky cell (75748 x 60, McICA by seed +
  aerosols), lw2_mega on the all-sky cell (256 g-points, the same
  composition); then the step time (median of 5) and the peak device memory
  (``torch.cuda.max_memory_allocated()`` over the steps, after one warm-up) of
  the clear, two-kernel, all-sky and all-sky no-scattering cells as
  chip_smoke.py drives them. It uses only entry points that every commit of
  the port has, so ``--root`` runs it on an older checkout. Compare commits
  in one call, in turns (parent, change, change, parent).
- ``gather``: the kernels around the gas-optics table gather, each in 3
  rounds of a median of 7 synchronized calls with the sha256 of its
  outputs, and their ``ptxas`` registers: optics_fused LW and SW and
  interp_pt_eta on each table of the unfused optics and interp_minor LW and
  SW (with ``--tiles``, once per column tile, set through
  ``ops.interp.OPTICS_TILE``, ``ops.interp.INTERP_TILE`` and
  ``ops.interp.MINOR_TILE`` where the checkout has them), lw_clear_mega
  clear, and the sweeps that read optics_fused's outputs timed with it
  (lw_noscat_banded_reduced after the LW optics, sw_2stream_reduced after
  the SW optics), on the clear cell; with
  ``--k1`` lw_clear_mega alone: clear, built for f64 on the clear cell in
  f64, and composed (McICA by seed + aerosols) on the all-sky cell. For
  ablations and design variants: build each variant in its own checkout
  and run this mode on each in turns within one call.
- ``sw-sweep``: the SW sweeps on the clear cell's SW optics (32768 x 60,
  224 g-points), 3 rounds of a median of 7 synchronized calls, the cases
  taking turns within a round, each with the sha256 of its outputs and the
  device scratch of one call (peak allocated during the call less what is
  allocated after it): sw_2stream_reduced and sw_2stream_gpt, the latter
  with each number of bottom levels kept in shared memory in
  ``SW_GPT_DEPTHS`` (set through ``ops.rte_kernels.SW_GPT_LEVELS`` where
  the checkout has it; every depth gives the same bits), then
  sw_2stream_gpt's plan (``rte_kernels.sw_2stream_gpt_design``) and the
  ``ptxas`` registers of their kernels. For design variants and ablations
  of sw_2stream_reduced (the parent's four-array passes, a third scratch
  array, the level sums left out): build each in its own checkout and run
  this mode on each with ``--root``, in turns within one call.
- ``lw-sweep``: the LW no-scattering sweep of the two-kernel path (K12) on
  the clear cell's LW optics (32768 x 60, 256 g-points) at 1 and at 3
  quadrature angles as the checkout's solves launch it (see
  ``kernel-hashes``), 3 rounds of a median of 7 synchronized calls, the
  cases taking turns within a round, each with the sha256 of its fluxes,
  then the ``ptxas`` registers of the kernel's instantiations. For design
  variants (angles per launch, read-ahead): build each in its own checkout
  and run this mode on each with ``--root``, in turns within one call.
- ``sw-mega``: the SW megakernel (K2) on the clear cell (32768 x 60) and on
  the all-sky cell (75748 x 60, McICA by seed + aerosols), 3 rounds of a
  median of 7 synchronized calls, the cells taking turns within a round,
  each with the sha256 of its outputs (the cover with them), the device
  scratch of one call (peak allocated during the call less what is
  allocated after it), the staging chunk and staged bytes where the
  checkout reports them (``ops.mega.sw_clear_mega_design``), then the
  ``ptxas`` registers of every instantiation. For design variants (the
  staging chunk, the state layout): build each in its own checkout and run
  this mode on each with ``--root``, in turns within one call with the
  parent.
- ``lw2-sweep``: the LW two-stream sweep from materialized optics (K14) on
  the clear cell's LW optics and sources (32768 x 60, 256 g-points; ssa = g
  = 0 as the clear solves make them), without and with an incident flux,
  3 rounds of a median of 7 synchronized calls, the cases taking turns
  within a round, each with the sha256 of its fluxes and the device scratch
  of one call, then the design where the checkout reports it
  (``rte_kernels.lw_2stream_reduced_design``) and the ``ptxas`` registers.
  For design variants (the chunk, where the checkpoints live): build each
  in its own checkout and run this mode on each with ``--root``, in turns
  within one call with the parent.
- ``lw-gpt``: the per-g-point LW no-scattering sweep (K16b) on the clear
  cell's LW optics and sources (32768 x 60, 256 g-points) with each number
  of bottom layers kept in shared memory in ``LW_GPT_DEPTHS`` (set through
  ``ops.rte_kernels.LW_GPT_LAYERS`` where the checkout has it, else the
  checkout's one design) and with an incident flux, as ``lw2-sweep`` times
  K14, then the plan (``rte_kernels.lw_noscat_gpt_design``) and the
  registers. Every depth gives the same bits: equal hashes.
- ``aerosol``: the MERRA aerosol band sums (K5) on the all-sky cell
  (75748 x 60, LW 16 and SW 14 bands, all species), as ``lw2-sweep`` times
  K14, with the design where the checkout reports it
  (``aerosol_bands.aerosol_bands_design``: staged bytes, blocks an SM) and
  the registers. For ablations and design variants: one checkout each.
- ``planck``: the band Planck kernels, K3 in f32 and f64 and K11, on the
  clear cell's three temperature sets (t_lay, t_lev, t_sfc at 32768 x 60:
  4.0 M points, 256 MB out in f32), as the checkout's solves launch them
  (one launch for the three sets where the checkout has
  ``planck_band_sets`` / ``planck_band_rows_sets``, else one per set), 3
  rounds, the cases taking turns within a round, each the median of 7
  host-timed synchronized calls and the device time by CUDA events over 20
  calls back to back; where the checkout's chip_smoke.py has the library
  yardstick, ``torch.nn.functional.grid_sample`` for the same sets (bands
  leading a call per set; rows in one call per set and bands leading then
  transposed) in the same rounds, with its error against the twin; then
  each kernel case's sha256 and the ``ptxas`` registers of the band Planck
  kernels. For design variants: one checkout each, in turns with the
  parent within one call.
- ``mesh``: RRTMGPSolver(mesh=make_column_mesh()), one entry per card the
  process sees, all-sky (McICA by seed + aerosols, 75748 x 60) and clear
  (LW no-scattering, 32768 x 60), against the unsplit solver on cuda:0:
  the launches of one mesh step, every entry's fluxes (and all-sky LW cloud
  cover) bitwise the unsplit ones, and 5 steps each in turns of the
  unsplit solver, the mesh solver (every card synchronised) and one entry's
  share of the columns alone on cuda:0 (the work of each card: share /
  mesh near 1 is full overlap of the cards), each with the host time until
  update_fluxes() returns (the enqueue: near the step time, the one thread
  that launches every entry bounds the step). Then a world of as many
  processes as cards, one card each (chip_smoke.py ``phase_mesh_world``),
  each share bitwise the unsplit clear fluxes.
- ``kernel-hashes`` also hashes K5 on the all-sky cell (LW and SW, all
  species and a subset) and K14 with an incident flux, with ssa and g of an
  all-sky composition (8192 columns), at 61 layers, at 1100 and 1000
  g-points (64 x 12) and at 800 layers (512 columns), K16a and K16b at
  those g-point counts and that depth too; and K3 (f32 and
  f64) and K11 on the clear cell's three sets and on three sets of odd
  sizes whose temperatures lie below the table, on every node, inside the
  last interval, on the last node and above it.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys
import time
import warnings

ARGS = sys.argv[1:]
UNFUSED = "--unfused" in ARGS
K1_ONLY = "--k1" in ARGS
TILES = None
if "--tiles" in ARGS:
    TILES = [int(t) for t in ARGS[ARGS.index("--tiles") + 1].split(",")]
    del ARGS[ARGS.index("--tiles"):ARGS.index("--tiles") + 2]
ARGS = [a for a in ARGS if a not in ("--unfused", "--k1")]
ROOT = pathlib.Path(__file__).resolve().parent.parent
if ARGS[:1] == ["--root"]:
    ROOT, ARGS = pathlib.Path(ARGS[1]).resolve(), ARGS[2:]
sys.path.insert(0, str(ROOT))

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


SWEEP_ALLSKY_CHUNK = 16384


def lw_two_stream_routes(lw, atm, bcs_lw, what: str, chunked_sweep: bool = False, **kw) -> None:
    """solve_lw(two_stream=True) on the three kernel routes, three rounds
    with the routes taking turns, and each route's peak memory."""
    import torch

    from rrtmgp_tpu_torch import solve_lw
    from rrtmgp_tpu_torch.models.rrtmgp import solve_chunked

    def solve(impl):
        if impl == "sweep" and chunked_sweep:
            rest = {k: v for k, v in kw.items() if k != "cld_mask_seed"}
            return solve_chunked(
                lambda a, b, seed, off: solve_lw(lw, a, b, two_stream=True, impl=impl, cld_mask_seed=seed,
                                                 col_offset=off, **rest),
                atm, bcs_lw, SWEEP_ALLSKY_CHUNK, cld_mask_seed=kw["cld_mask_seed"])
        return solve_lw(lw, atm, bcs_lw, two_stream=True, impl=impl, **kw)

    impls = ("kernel", "two_kernel", "sweep")
    ms = _rounds(impls, solve)
    for impl in impls:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        solve(impl)
        torch.cuda.synchronize()
        note = f" (solve_chunked, {SWEEP_ALLSKY_CHUNK}-column chunks)" if impl == "sweep" and chunked_sweep else ""
        say("angles", f"solve_lw two-stream {what}, impl={impl}{note}: {_fmt(ms[impl])} ms, peak memory "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


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
        if dtype == "float32":
            lw_two_stream_routes(lw, atm, bcs_lw, f"clear float32 {cs.NCOL} x {cs.NLAY}")
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
    lw_two_stream_routes(L.lookup_lw, atm, bcs_lw, f"all-sky + aerosols float32 {cs.ALLSKY_NCOL} x {cs.NLAY}",
                         chunked_sweep=True, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero,
                         cld_mask_seed=cs.MCICA_SEED)


def _profile(tag: str, step, steps: int = 3) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the warm-up step runs under a profiler of its own: the first profiler
    # session of a process starts the device tracing, which takes seconds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
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
    from rrtmgp_tpu_torch.ops import interp
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    cells = [("two-kernel", dict(impl="two_kernel"), {})]
    if UNFUSED:
        cells.append(("unfused two-kernel", dict(fused_optics=False), dict(fused_optics=False)))
    for tag, kw, beam_kw in cells:
        parts = (("LW 3 angles", lambda: solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, **kw)),
                 ("SW two-stream", lambda: solve_sw(sw, atm, bcs_sw, **kw)),
                 ("SW direct beam", lambda: solve_sw(sw, atm, bcs_sw, two_stream=False, **beam_kw)))
        _profile(f"profile {tag}", lambda: [fn() for _, fn in parts])
        for name, fn in parts:
            say(f"profile {tag}", f"{name} alone, no profiler: {cs.timed(fn, 3):.3f} ms")
    if UNFUSED:
        for wave, inp, tabs in (("LW", mega_lw_inputs(lw, atm), lw.kernel_tables),
                                ("SW", mega_sw_inputs(sw, atm), sw.kernel_tables)):
            for name, fn in (("optics_fused", interp.optics_fused), ("optics_unfused", interp.optics_unfused)):
                say("profile unfused two-kernel",
                    f"{wave} {name} alone (the prologue excluded): {cs.timed(lambda: fn(inp, tabs), 3):.3f} ms")


def profile_sweep() -> None:
    from rrtmgp_tpu_torch import solve_lw, solve_sw

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    parts = (("LW 3 angles", lambda: solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="sweep")),
             ("LW two-stream", lambda: solve_lw(lw, atm, bcs_lw, two_stream=True, impl="sweep")),
             ("SW two-stream", lambda: solve_sw(sw, atm, bcs_sw, impl="sweep")))

    def step():
        for _, fn in parts:
            fn()

    _profile("profile sweep", step)
    for name, fn in parts:
        say("profile sweep", f"{name} alone, no profiler: {cs.timed(fn, 3):.3f} ms")
    for impl in ("two_kernel", "kernel"):
        _profile(f"profile LW two-stream {impl}", lambda: solve_lw(lw, atm, bcs_lw, two_stream=True, impl=impl))


REGISTERS_OF = ("sw_clear_mega_kernel", "lw2_mega_kernelILb0ELb0", "lw2_mega_kernelILb1ELb1ELi2",
                "sw_2stream_reduced_kernel", "lw_clear_mega_kernelIfLb0ELb0", "lw_clear_mega_kernelIfLb1ELb1ELi2",
                "lw_clear_mega_kernelIdLb0ELb0", "lw_noscat_banded_kernel", "lw_noscat_sources_kernel",
                "lw_noscat_reduced_kernel", "lw_noscat_gpt_kernel", "lw_2stream_reduced_kernel",
                "optics_fused_kernel", "interp_pt_eta_kernel", "interp_minor_kernel", "sw_2stream_gpt_kernel",
                "aerosol_bands_kernel", "planck_band")


def angles_call(multi: str, one: str, head, n: int, inc=None):
    """A multi-angle LW sweep at solve_lw's n angles on ``head`` (the
    one-angle wrapper's arguments before the angle) with the incident flux
    ``inc``, as the checkout's solves launch it: ``rte_kernels.<multi>``
    (one launch) where the checkout has it, else ``rte_kernels.<one>`` per
    angle with the incident flux split by weight, summed in the angles'
    order (the solves before it)."""
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops import rte_kernels

    Ds, wts = angular_discretization(n)
    ds, w = [float(d) for d in Ds], [float(x) for x in wts]
    if hasattr(rte_kernels, multi):
        return lambda: getattr(rte_kernels, multi)(*head, ds, w, inc)

    def per_angle():
        up = dn = None
        for d, x in zip(ds, w):
            u, v = getattr(rte_kernels, one)(*head, d, x, None if inc is None else inc * x)
            up, dn = (u, v) if up is None else (up + u, dn + v)
        return up, dn

    return per_angle


def k12_angles(k12, n: int):
    """K12 (lw_noscat_banded) at n angles on k12's optics (see angles_call)."""
    return angles_call("lw_noscat_banded_angles", "lw_noscat_banded_reduced", k12[:7], n, k12[9])


def k13_angles(k13, n: int, inc=None):
    """K13 (lw_noscat_reduced) at n angles on k13's sources with the
    incident flux ``inc`` (see angles_call)."""
    return angles_call("lw_noscat_reduced_angles", "lw_noscat_reduced", k13[:6], n, inc)


def sw_mega_cases(L, atm):
    """sw_clear_mega on the all-sky cell's inputs as solve_sw builds them
    (delta-scaled band properties): a cloud mask given (McICA mask of the
    seed) with aerosols, clouds without aerosols by mask, McICA by seed +
    aerosols (the cover is hashed with the fluxes), aerosols alone. Returns
    (name, composition) pairs and the wrapper's other arguments."""
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_sw_inputs

    sw = L.lookup_sw
    _, bcs_sw = cs.boundary_conditions(L.lookup_lw, sw, atm.ncol)
    mask = build_cloud_mask_mcica(atm.cloud_state.cld_frac, sw.n_gpt, cs.MCICA_SEED, cs.COL_OFFSET)

    def comp(cld, aero, seeded):
        return _kernel_composition(sw, atm, cld, aero, None if seeded else mask, cs.MCICA_SEED if seeded else None,
                                   cs.COL_OFFSET, None, True, False)[0]

    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    args = (mega_sw_inputs(sw, atm), sw.kernel_tables, bcs_sw.cos_zenith, toa_gpt, bcs_sw.sfc_alb_direct,
            bcs_sw.sfc_alb_diffuse, None)
    cases = [("cloud mask+aerosols", comp(L.lookup_sw_cld, L.lookup_sw_aero, False)),
             ("cloud mask", comp(L.lookup_sw_cld, None, False)),
             ("seed+aerosols", comp(L.lookup_sw_cld, L.lookup_sw_aero, True)),
             ("aerosols", comp(None, L.lookup_sw_aero, False))]
    return cases, args


AEROSOL_SUBSET = (0, 2, 4, 11)  # dust1, sulfate, BC, sea salt 2


def aerosol_hashes(report, L) -> None:
    """K5 (aerosol_bands) at the all-sky cell's width (75748 x 60) on its
    aerosol-laden atmosphere: LW 16 bands and SW 14 bands, all species and a
    subset."""
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    atm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
    for wave, lkp in (("LW", L.lookup_lw_aero), ("SW", L.lookup_sw_aero)):
        a = (lkp, atm.aerosol_state, atm.rel_hum)
        report(f"aerosol_bands {wave} {lkp.dust.shape[-1]} bands", lambda: ab.aerosol_bands(*a))
        report(f"aerosol_bands {wave} species {AEROSOL_SUBSET}", lambda: ab.aerosol_bands(*a, AEROSOL_SUBSET))


def _lw2_allsky_args(L, ncol, nlay):
    """K14's arguments with ssa and g of an all-sky composition (McICA by
    seed + aerosols at g-point resolution), as chip_smoke.py builds them."""
    import torch

    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw

    lw, atm = L.lookup_lw, cs.allsky_atmosphere(ncol, nlay)
    bcs_lw, _ = cs.boundary_conditions(lw, L.lookup_sw, ncol)
    tau, src = gas_optics_lw(lw, atm, need_lay_source=False)
    comp = _kernel_composition(lw, atm, L.lookup_lw_cld, L.lookup_lw_aero, None, cs.MCICA_SEED, cs.COL_OFFSET,
                               None, False, False)[0]
    zeros = torch.zeros_like(tau)
    tau, ssa, g, _ = mega._compose_ref(comp, lw, tau, zeros, zeros)
    return (tau.contiguous(), ssa.contiguous(), g.contiguous(), src.lev_source, src.sfc_source, bcs_lw.sfc_emis,
            lw.kernel_tables.gpt2band, None)


def _incident(like):
    """A smooth incident flux of tau's (ncol, ngpt) shape."""
    import torch

    n = like[0].numel()
    return 0.5 + 0.25 * torch.sin(torch.arange(n, device=cs.DEVICE, dtype=torch.float32)).view(like.shape[1:])


def _sw_allsky_gpt_args(L, ncol, nlay):
    """sw_2stream_gpt's arguments with the ssa and g of an all-sky
    composition (McICA by seed + aerosols, delta-scaled, at g-point
    resolution) at ncol x nlay, as chip_smoke.py's sw sweep check builds
    them (mu0 in [0.05, 1] from seed 5; no incident flux)."""
    import torch

    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import interp, mega
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_sw_inputs

    sw, atm = L.lookup_sw, cs.allsky_atmosphere(ncol, nlay)
    _, bcs_sw = cs.boundary_conditions(L.lookup_lw, sw, ncol)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(5)
    mu0 = 0.05 + 0.95 * torch.rand(ncol, generator=gen, device=cs.DEVICE)
    tau, ssa = interp.optics_fused(mega_sw_inputs(sw, atm), sw.kernel_tables)
    comp = _kernel_composition(sw, atm, L.lookup_sw_cld, L.lookup_sw_aero, None, cs.MCICA_SEED, cs.COL_OFFSET,
                               None, True, False)[0]
    tau, ssa, g, _ = mega._compose_ref(comp, sw, tau, ssa, torch.zeros_like(tau))
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    return cs.per_gpt_sw_args((tau.contiguous(), ssa.contiguous(), g.contiguous(), mu0, toa_gpt,
                               bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse, sw.kernel_tables.gpt2band, None))


def lw2_sweep_hashes(report) -> None:
    """K14 (lw_2stream_reduced) beyond the clear cell: with an incident flux,
    with ssa and g of an all-sky composition (8192 columns), at 61 layers
    (not a multiple of a chunk), at 1100 and 1000 g-points (64 x 12) and at
    800 layers (512 columns); the per-g-point sweeps K16a and K16b at those
    g-point counts and that depth too."""
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.ops import rte_kernels

    def sweep(lw, sw, ncol, nlay, which=1):
        atm = cs.atmosphere(ncol, nlay)
        return cs.sweep_args(lw, sw, atm, *cs.boundary_conditions(lw, sw, ncol))[which]

    def per_gpt(tag, lw, sw, ncol, nlay):
        k16a, k16b = (sweep(lw, sw, ncol, nlay, which) for which in (3, 4))
        report(f"sw_2stream_gpt {tag}", lambda: rte_kernels.sw_2stream_gpt(*k16a))
        report(f"lw_noscat_gpt {tag}", lambda: rte_kernels.lw_noscat_gpt(*k16b))

    lw, sw = cs.lookups(256, 16, 224, 14)
    k14 = sweep(lw, sw, cs.NCOL, cs.NLAY)
    report("lw_2stream_reduced with incident flux", lambda: rte_kernels.lw_2stream_reduced(
        *k14[:7], _incident(k14[0])))
    del k14
    k14 = sweep(lw, sw, cs.NCOL, 61)
    report("lw_2stream_reduced 61 layers", lambda: rte_kernels.lw_2stream_reduced(*k14))
    del k14
    torch.cuda.empty_cache()
    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    k14 = _lw2_allsky_args(L, 8192, cs.NLAY)
    report("lw_2stream_reduced all-sky ssa and g", lambda: rte_kernels.lw_2stream_reduced(*k14))
    report("lw_2stream_reduced all-sky ssa and g with incident flux", lambda: rte_kernels.lw_2stream_reduced(
        *k14[:7], _incident(k14[0])))
    del k14, L
    torch.cuda.empty_cache()
    for ngpt in (1100, 1000):
        k14 = sweep(*cs.lookups(ngpt, 4, ngpt, 4), 64, 12)
        report(f"lw_2stream_reduced {ngpt} g-points", lambda: rte_kernels.lw_2stream_reduced(*k14))
        report(f"lw_2stream_reduced {ngpt} g-points with incident flux", lambda: rte_kernels.lw_2stream_reduced(
            *k14[:7], _incident(k14[0])))
        per_gpt(f"{ngpt} g-points", *cs.lookups(ngpt, 4, ngpt, 4), 64, 12)
    k14 = sweep(lw, sw, 512, 800)
    report("lw_2stream_reduced 800 layers", lambda: rte_kernels.lw_2stream_reduced(*k14))
    del k14
    per_gpt("800 layers", lw, sw, 512, 800)


def _device_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call by CUDA events around ``reps`` calls back to
    back, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _planck_calls(lkp, ts):
    """K3 and K11 over the sets ``ts`` as the checkout's solves launch them:
    one launch where it has the sets wrappers, else one per set."""
    from rrtmgp_tpu_torch.ops import interp, mega

    tab = (lkp.totplnk, lkp.t_planck_min, lkp.t_planck_delta)
    calls = {}
    for name, one, many in (("planck_band", mega.planck_band, "planck_band_sets"),
                            ("planck_band_rows", interp.planck_band_rows, "planck_band_rows_sets")):
        if hasattr(mega if name == "planck_band" else interp, many):
            fn = getattr(mega if name == "planck_band" else interp, many)
            calls[name] = lambda fn=fn: fn(tuple(ts), *tab)
        else:
            calls[name] = lambda one=one: tuple(one(t, *tab) for t in ts)
    return calls


def _edge_temperatures(lkp, sizes=(257, 4099, 1)):
    """Three sets of odd sizes: below the table, every node, inside the last
    interval, the last node, above it, and uniform draws across and beyond
    the table (numpy seed 9)."""
    import numpy as np
    import torch

    n_t = lkp.totplnk.shape[0]
    t_min, dt = float(lkp.t_planck_min), float(lkp.t_planck_delta)
    t_max = t_min + (n_t - 1) * dt
    edges = [t_min - 50.0, t_min - 1e-3, *(t_min + k * dt for k in range(n_t)), t_max - 0.5 * dt, t_max - 1e-3,
             t_max + 1e-3, t_max + 50.0]
    rng = np.random.default_rng(9)
    t = np.concatenate([edges, rng.uniform(t_min - 30.0, t_max + 30.0, sum(sizes) - len(edges))])
    t = torch.from_numpy(t).to(dtype=lkp.totplnk.dtype, device=lkp.totplnk.device)
    return list(torch.split(t, list(sizes)))


def planck() -> None:
    import torch

    from rrtmgp_tpu_torch.ops import _build

    cases = []
    for kind in ("float32", "float64"):
        lw = cs.lookups(256, 16, 224, 14, kind)[0]
        atm = cs.atmosphere(cs.NCOL, cs.NLAY, kind)
        ts = [t.reshape(-1) for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
        calls = _planck_calls(lw, ts)
        tab = (lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
        tag = "f32" if kind == "float32" else "f64"
        cases.append((f"planck_band {tag} (K3), 3 sets", calls["planck_band"], None))
        if kind == "float32":
            cases.append(("planck_band_rows (K11), 3 sets", calls["planck_band_rows"], None))
        if hasattr(cs, "grid_sample_bands"):
            from rrtmgp_tpu_torch.ops import interp, mega

            want = lambda ts=ts, tab=tab: tuple(mega.planck_band_ref(t, *tab) for t in ts)
            cases.append((f"grid_sample {tag} bands leading, a call per set",
                          lambda ts=ts, tab=tab: tuple(cs.grid_sample_bands(t, *tab) for t in ts), want))
            if kind == "float32":
                rows = lambda ts=ts, tab=tab: tuple(interp.planck_band_rows_ref(t, *tab) for t in ts)
                cases.append(("grid_sample rows, one call per set",
                              lambda ts=ts, tab=tab: tuple(cs.grid_sample_rows(t, *tab) for t in ts), rows))
                cases.append(("grid_sample rows, bands leading then .T.contiguous()",
                              lambda ts=ts, tab=tab: tuple(cs.grid_sample_bands(t, *tab).T.contiguous()
                                                           for t in ts), rows))
    # the card's write rate on the same output bytes: one fill of an f32 and
    # an f64 buffer of the three sets' size
    n_out = sum(t.numel() for t in ts) * lw.totplnk.shape[1]
    for dtype in (torch.float32, torch.float64):
        buf = torch.empty(n_out, dtype=dtype, device=cs.DEVICE)
        cases.append((f"fill_ of {n_out * buf.element_size() / 1e6:.0f} MB ({dtype}), the write rate",
                      lambda buf=buf: (buf.fill_(1.0),), None))
    host = {name: [] for name, _, _ in cases}
    device = {name: [] for name, _, _ in cases}
    for _ in range(3):
        for name, fn, _ in cases:
            host[name].append(cs.timed(fn, 7))
            device[name].append(_device_ms(fn))
    for name, fn, want in cases:
        if name.startswith("fill_"):
            check = f"{float(fn()[0].numel() * fn()[0].element_size()) / device[name][-1] / 1e9:.3f} TB/s"
        elif want is None:
            h = hashlib.sha256()
            for t in fn():
                h.update(t.cpu().numpy().tobytes())
            check = f"sha256 {h.hexdigest()[:16]}"
        else:
            err, rel = cs.rel_err(fn(), want())
            check = f"max|d|={err:.3e} rel={rel:.3e} against the twin"
        say("planck", f"{ROOT} {name}: host {_fmt(host[name])} ms, device {_fmt(device[name])} ms, {check}")
    torch.cuda.empty_cache()
    _registers(_build.library_path().with_suffix(".log"), ("planck_band",), "planck")


def kernel_hashes() -> None:
    import torch

    import rrtmgp_tpu_torch
    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import _build, interp, mega, rte_kernels
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs

    if not rrtmgp_tpu_torch.__file__.startswith(str(ROOT)):
        raise SystemExit(f"imported {rrtmgp_tpu_torch.__file__}, not the package under {ROOT}")

    def report(name, fn):
        ms = cs.timed(fn, 7)
        h = hashlib.sha256()
        for t in fn():
            h.update(t.cpu().numpy().tobytes())
        say("kernel-hashes", f"{ROOT} {name}: {ms:.3f} ms, sha256 {h.hexdigest()[:16]}")

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    for kind in ("float32", "float64"):
        lkp = lw if kind == "float32" else cs.lookups(256, 16, 224, 14, kind)[0]
        a = atm if kind == "float32" else cs.atmosphere(cs.NCOL, cs.NLAY, kind)
        tag = "f32" if kind == "float32" else "f64"
        for what, ts in (("clear cell", [t.reshape(-1) for t in (a.t_lay, a.t_lev, a.t_sfc)]),
                         ("edge temperatures", _edge_temperatures(lkp))):
            calls = _planck_calls(lkp, ts)
            report(f"planck_band {tag} (K3) {what}", calls["planck_band"])
            if kind == "float32":
                report(f"planck_band_rows (K11) {what}", calls["planck_band_rows"])
        del lkp, a, calls, ts
    lw_in, sw_in, _, k12, k15 = cs.two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    _, k1, k2 = cs.kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    report("sw_2stream_reduced clear", lambda: rte_kernels.sw_2stream_reduced(*k15))
    report("sw_clear_mega clear", lambda: mega.sw_clear_mega(*k2))
    report("lw_clear_mega clear", lambda: mega.lw_clear_mega(*k1))
    report("optics_fused LW", lambda: interp.optics_fused(*lw_in))
    report("optics_fused SW", lambda: interp.optics_fused(*sw_in))
    report("lw_noscat_banded_reduced", lambda: rte_kernels.lw_noscat_banded_reduced(*k12))
    report("lw_noscat_banded_reduced 3 angles", k12_angles(k12, 3))
    inc = 0.5 + 0.25 * torch.sin(torch.arange(k12[0][0].numel(), device=cs.DEVICE, dtype=torch.float32)).view(
        k12[0].shape[1:])
    report("lw_noscat_banded_reduced 3 angles with incident flux", k12_angles((*k12[:9], inc), 3))
    report("lw_noscat_banded_reduced 1 angle with incident flux", k12_angles((*k12[:9], inc), 1))
    del inc
    for name, kw in (("two-kernel", dict(impl="two_kernel")), ("unfused", dict(fused_optics=False))):
        report(f"solve_lw 3 angles {name}", lambda: rrtmgp_tpu_torch.solve_lw(lw, atm, bcs_lw, n_gauss_angles=3,
                                                                              **kw)[0])
    for wave, (inp, tabs) in (("LW", lw_in), ("SW", sw_in)):
        second = (tabs.second, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress) if wave == "LW" else (
            tabs.second, inp.jtemp, inp.ftemp, (~inp.tropo_lower).to(torch.int32), torch.zeros_like(inp.fpress))
        eta = (inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tabs.gpt2band)
        kmajor = (tabs.kmajor, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress, *eta, inp.col_mix1, inp.col_mix2)
        report(f"interp_pt_eta {wave} kmajor", lambda: (interp.interp_pt_eta(*kmajor),))
        report(f"interp_pt_eta {wave} {'Planck fraction' if wave == 'LW' else 'Rayleigh'}",
               lambda: (interp.interp_pt_eta(*second, *eta),))
        report(f"interp_minor {wave}", lambda: (interp.interp_minor(inp, tabs),))
    del k1, k2, k12, k15, lw_in, sw_in, kmajor, second
    torch.cuda.empty_cache()
    k13, k14, _, k16a, k16b = cs.sweep_args(lw, sw, atm, bcs_lw, bcs_sw)
    report("lw_noscat_reduced", lambda: rte_kernels.lw_noscat_reduced(*k13))
    inc = 0.5 + 0.25 * torch.sin(torch.arange(k13[0][0].numel(), device=cs.DEVICE, dtype=torch.float32)).view(
        k13[0].shape[1:])
    report("lw_noscat_reduced 1 angle with incident flux", k13_angles(k13, 1, inc))
    report("lw_noscat_reduced 3 angles", k13_angles(k13, 3))
    report("lw_noscat_reduced 3 angles with incident flux", k13_angles(k13, 3, inc))
    del inc
    report("lw_2stream_reduced", lambda: rte_kernels.lw_2stream_reduced(*k14))
    report("sw_2stream_gpt", lambda: rte_kernels.sw_2stream_gpt(*k16a))
    report("sw_2stream_gpt with incident diffuse flux", lambda: rte_kernels.sw_2stream_gpt(
        *k16a[:7], _incident(k16a[0])))
    report("lw_noscat_gpt", lambda: rte_kernels.lw_noscat_gpt(*k16b))
    report("lw_noscat_gpt with incident flux", lambda: rte_kernels.lw_noscat_gpt(*k16b[:7], _incident(k16b[0])))
    del atm, k13, k14, k16a, k16b
    torch.cuda.empty_cache()
    lw64, sw64 = cs.lookups(256, 16, 224, 14, "float64")
    atm64 = cs.atmosphere(cs.NCOL, cs.NLAY, "float64")
    k7 = cs.kernel_args(lw64, None, atm64, cs.boundary_conditions(lw64, sw64, cs.NCOL)[0], None)[1]
    report("lw_clear_mega f64 clear (K7)", lambda: mega.lw_clear_mega(*k7))
    del lw64, sw64, atm64, k7
    torch.cuda.empty_cache()

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    k16a = _sw_allsky_gpt_args(L, cs.TWIN_CHUNK, cs.NLAY)
    report("sw_2stream_gpt all-sky ssa and g", lambda: rte_kernels.sw_2stream_gpt(*k16a))
    report("sw_2stream_gpt all-sky ssa and g with incident diffuse flux", lambda: rte_kernels.sw_2stream_gpt(
        *k16a[:7], _incident(k16a[0])))
    del k16a
    torch.cuda.empty_cache()
    lw = L.lookup_lw
    atm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
    bcs_lw, _ = cs.boundary_conditions(lw, L.lookup_sw, cs.ALLSKY_NCOL)
    plk = cs.plk_fn(lw)
    comp = _kernel_composition(lw, atm, L.lookup_lw_cld, L.lookup_lw_aero, None, cs.MCICA_SEED, cs.COL_OFFSET,
                               None, False, False)[0]
    args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lev), plk(atm.t_sfc), bcs_lw.sfc_emis, None)
    report("lw2_mega seed+aerosols", lambda: mega.lw2_mega(*args, comp))
    Ds, wts = angular_discretization(1)
    ns_args = (*args[:2], plk(atm.t_lay), *args[2:], float(Ds[0]), float(wts[0]))
    report("lw_clear_mega composed seed+aerosols", lambda: mega.lw_clear_mega(*ns_args, comp))
    del ns_args
    report("lw2_mega clear", lambda: mega.lw2_mega(*args)[:2])
    report("mcica_mask_export", lambda: mega.mcica_mask_export(atm.cloud_state.cld_frac, cs.MCICA_SEED,
                                                               cs.COL_OFFSET, lw.n_gpt))
    del args, comp
    torch.cuda.empty_cache()
    cases, sw_args = sw_mega_cases(L, atm)
    for what, c in cases:
        report(f"sw_clear_mega {what}", lambda: mega.sw_clear_mega(*sw_args, c))
    del cases, sw_args, atm
    torch.cuda.empty_cache()
    # more g-points than a block has threads, and the deep column
    for tag, lkps, a in (
            (f"{cs.WIDE_NGPT} g-points", cs.small_allsky_lookups(cs.WIDE_NGPT),
             cs.allsky_atmosphere(cs.WIDE_NCOL, cs.WIDE_NLAY)),
            (f"{cs.DEEP_NLAY} layers", L, cs.allsky_atmosphere(cs.DEEP_NCOL, cs.DEEP_NLAY))):
        cases, sw_args = sw_mega_cases(lkps, a)
        report(f"sw_clear_mega clear {tag}", lambda: mega.sw_clear_mega(*sw_args))
        for what, c in cases[2:3]:
            report(f"sw_clear_mega {what} {tag}", lambda: mega.sw_clear_mega(*sw_args, c))
    del cases, sw_args, a
    torch.cuda.empty_cache()
    aerosol_hashes(report, L)
    torch.cuda.empty_cache()
    lw2_sweep_hashes(report)
    plain_hashes(report, L)
    del L

    entry = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and any(k in entry for k in REGISTERS_OF):
            say("kernel-hashes", f"{ROOT} {entry[:72]}: {line.split(':', 1)[1].strip()}")


def plain_hashes(report, L) -> None:
    """The plain arithmetic the kernels are held against and the torch path
    computes, on CMP_NCOL columns: the twins of lw_clear_mega, sw_clear_mega,
    lw2_mega, lw_2stream_reduced and sw_2stream_reduced on the clear cell,
    and solve_lw (no-scattering, two-stream) and solve_sw through
    impl="torch", clear and all-sky (McICA by seed + aerosols). Equal hashes
    of two checkouts: the same bits from the plain paths."""
    import torch

    import rrtmgp_tpu_torch
    from rrtmgp_tpu_torch.ops import mega, rte_kernels

    ncol = cs.CMP_NCOL
    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(ncol, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, ncol)
    _, k1, k2 = cs.kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    plk = cs.plk_fn(lw)
    report("twin of lw_clear_mega clear", lambda: mega.lw_clear_mega_ref(*k1))
    report("twin of sw_clear_mega clear", lambda: mega.sw_clear_mega_ref(*k2))
    report("twin of lw2_mega clear", lambda: mega.lw2_mega_ref(k1[0], k1[1], plk(atm.t_lev), plk(atm.t_sfc),
                                                              bcs_lw.sfc_emis, None)[:2])
    _, _, _, _, k15 = cs.two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    report("twin of sw_2stream_reduced clear", lambda: rte_kernels.sw_2stream_reduced_ref(*k15))
    k14 = cs.sweep_args(lw, sw, atm, bcs_lw, bcs_sw)[1]
    report("twin of lw_2stream_reduced clear", lambda: rte_kernels.lw_2stream_reduced_ref(*k14))
    del k1, k2, k14, k15
    for kw in ({}, {"two_stream": True}):
        report(f"solve_lw torch clear {kw}", lambda: rrtmgp_tpu_torch.solve_lw(lw, atm, bcs_lw, impl="torch", **kw)[0])
    report("solve_sw torch clear", lambda: rrtmgp_tpu_torch.solve_sw(sw, atm, bcs_sw, impl="torch")[0])
    atm = cs.allsky_atmosphere(ncol, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(L.lookup_lw, L.lookup_sw, ncol)
    seeded = dict(cld_mask_seed=cs.MCICA_SEED, col_offset=cs.COL_OFFSET, impl="torch")
    flat = lambda out: (*out[0], *(x for x in out[1] if x is not None))  # fluxes, cover, AOD
    for kw in ({}, {"two_stream": True}):
        report(f"solve_lw torch seed+aerosols {kw}", lambda: flat(rrtmgp_tpu_torch.solve_lw(
            L.lookup_lw, atm, bcs_lw, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero, **seeded, **kw)))
    report("solve_sw torch seed+aerosols", lambda: flat(rrtmgp_tpu_torch.solve_sw(
        L.lookup_sw, atm, bcs_sw, lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero, **seeded)))
    torch.cuda.empty_cache()


GATHER_KERNELS = ("optics_fused_kernel", "lw_clear_mega_kernelIfLb0ELb0ELi0ELb0", "lw_clear_mega_kernelIdLb0ELb0ELi0ELb0",
                  "lw_clear_mega_kernelIfLb1ELb1ELi2ELb0", "interp_pt_eta_kernel", "interp_minor_kernel")


def gather() -> None:
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import _build, interp, mega, rte_kernels
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    k1 = cs.kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[1]
    cases = [("lw_clear_mega clear", lambda: mega.lw_clear_mega(*k1))]
    if K1_ONLY:
        lw64, sw64 = cs.lookups(256, 16, 224, 14, "float64")
        atm64 = cs.atmosphere(cs.NCOL, cs.NLAY, "float64")
        k7 = cs.kernel_args(lw64, None, atm64, cs.boundary_conditions(lw64, sw64, cs.NCOL)[0], None)[1]
        cases.append(("lw_clear_mega f64 clear (K7)", lambda: mega.lw_clear_mega(*k7)))
        L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
        alw = L.lookup_lw
        aatm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
        plk = cs.plk_fn(alw)
        comp = _kernel_composition(alw, aatm, L.lookup_lw_cld, L.lookup_lw_aero, None, cs.MCICA_SEED,
                                   cs.COL_OFFSET, None, False, False)[0]
        Ds, wts = angular_discretization(1)
        ns = (mega_lw_inputs(alw, aatm), alw.kernel_tables, plk(aatm.t_lay), plk(aatm.t_lev), plk(aatm.t_sfc),
              cs.boundary_conditions(alw, L.lookup_sw, cs.ALLSKY_NCOL)[0].sfc_emis, None, float(Ds[0]),
              float(wts[0]))
        cases.append(("lw_clear_mega composed seed+aerosols", lambda: mega.lw_clear_mega(*ns, comp)))
    else:
        lw_in = (mega_lw_inputs(lw, atm), lw.kernel_tables)
        sw_in = (mega_sw_inputs(sw, atm), sw.kernel_tables)
        for tile in TILES or [None]:
            def optics(args, tile=tile):
                if tile is not None:
                    interp.OPTICS_TILE = tile
                return interp.optics_fused(*args)

            cases += [(f"optics_fused LW tile {tile or 'default'}", lambda f=optics: f(lw_in)),
                      (f"optics_fused SW tile {tile or 'default'}", lambda f=optics: f(sw_in))]
        for tile in TILES or [None]:
            for what, args in cs.interp_cases(lw, sw, atm)[0]:
                def k9(args=args, tile=tile):
                    if tile is not None and hasattr(interp, "INTERP_TILE"):
                        interp.INTERP_TILE = tile
                    return (interp.interp_pt_eta(*args),)

                cases.append((f"interp_pt_eta {what} tile {tile or 'default'}", k9))
            for wave, args in (("LW", lw_in), ("SW", sw_in)):
                def k10(args=args, tile=tile):
                    if tile is not None and hasattr(interp, "MINOR_TILE"):
                        interp.MINOR_TILE = tile
                    return (interp.interp_minor(*args),)

                cases.append((f"interp_minor {wave} tile {tile or 'default'}", k10))
        _, _, _, k12, k15 = cs.two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
        cases += [("optics_fused LW + lw_noscat_banded_reduced",
                   lambda: (interp.optics_fused(*lw_in), rte_kernels.lw_noscat_banded_reduced(*k12))[1]),
                  ("optics_fused SW + sw_2stream_reduced",
                   lambda: (interp.optics_fused(*sw_in), rte_kernels.sw_2stream_reduced(*k15))[1])]
    for name, fn in cases:
        ms = [cs.timed(fn, 7) for _ in range(3)]
        h = hashlib.sha256()
        for t in fn():
            h.update(t.cpu().numpy().tobytes())
        say("gather", f"{ROOT} {name}: {_fmt(ms)} ms, sha256 {h.hexdigest()[:16]}")
    entry = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and any(k in entry for k in GATHER_KERNELS):
            say("gather", f"{ROOT} {entry[:72]}: {line.split(':', 1)[1].strip()}")


def _registers(log, kernels, tag):
    entry = None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and any(k in entry for k in kernels):
            say(tag, f"{ROOT} {entry[:72]}: {line.split(':', 1)[1].strip()}")


SW_GPT_DEPTHS = (0, 8, 16, 24, 32)  # bottom levels sw_2stream_gpt keeps on chip, as sw-sweep measures them
LW_GPT_DEPTHS = (0, 8, 12, 16, 32)  # layers lw_noscat_gpt keeps on chip, as lw-gpt measures them


def _depth_cases(attr: str, depths, label: str, fn, args) -> list:
    """(name, call) of a per-g-point sweep ``fn`` on ``args`` with each
    number of bottom levels or layers in ``depths`` that it keeps in shared
    memory, set through ``rte_kernels.<attr>`` where the checkout has it
    (restored after each call), else the checkout's one design."""
    from rrtmgp_tpu_torch.ops import rte_kernels

    if not hasattr(rte_kernels, attr):
        return [(f"{label} C=-", lambda: fn(*args))]

    def at(depth):
        def call():
            default = getattr(rte_kernels, attr)
            setattr(rte_kernels, attr, depth)
            try:
                return fn(*args)
            finally:
                setattr(rte_kernels, attr, default)
        return call

    return [(f"{label} C={c}", at(c)) for c in depths]


def sw_sweep() -> None:
    import torch

    from rrtmgp_tpu_torch.ops import _build, rte_kernels

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    k15 = cs.two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[4]
    del lw, atm, bcs_lw
    torch.cuda.empty_cache()
    k16a = cs.per_gpt_sw_args(k15)
    _rounds_of("sw-sweep", [("sw_2stream_reduced (K15)", lambda: rte_kernels.sw_2stream_reduced(*k15))]
               + _depth_cases("SW_GPT_LEVELS", SW_GPT_DEPTHS, "sw_2stream_gpt (K16a)", rte_kernels.sw_2stream_gpt,
                              k16a))
    if hasattr(rte_kernels, "sw_2stream_gpt_design"):
        say("sw-sweep", f"{ROOT} design: {rte_kernels.sw_2stream_gpt_design(cs.NLAY, sw.n_gpt, k15[0].device)}")
    _registers(_build.library_path().with_suffix(".log"), ("sw_2stream_reduced_kernel", "sw_2stream_gpt_kernel"),
               "sw-sweep")


def lw_sweep() -> None:
    from rrtmgp_tpu_torch.ops import _build

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    k12 = cs.two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[3]
    cases = [(f"lw_noscat_banded_reduced (K12) {n} angle(s)", k12_angles(k12, n)) for n in (1, 3)]
    ms = {name: [] for name, _ in cases}
    for _ in range(3):
        for name, fn in cases:
            ms[name].append(cs.timed(fn, 7))
    for name, fn in cases:
        h = hashlib.sha256()
        for t in fn():
            h.update(t.cpu().numpy().tobytes())
        say("lw-sweep", f"{ROOT} {name}: {_fmt(ms[name])} ms, sha256 {h.hexdigest()[:16]}")
    _registers(_build.library_path().with_suffix(".log"), ("lw_noscat_banded_kernel",), "lw-sweep")


def sw_mega() -> None:
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.ops import _build, mega

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    k2 = cs.kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[2]
    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    cases, args = sw_mega_cases(L, cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY))
    seeded = cases[2][1]
    runs = [(f"clear {cs.NCOL} x {cs.NLAY}", k2, mega.CLEAR),
            (f"all-sky McICA seed+aerosols {cs.ALLSKY_NCOL} x {cs.NLAY}", args, seeded)]
    ms = {name: [] for name, _, _ in runs}
    for _ in range(3):
        for name, a, c in runs:
            ms[name].append(cs.timed(lambda: mega.sw_clear_mega(*a, c), 7))
    for name, a, c in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = mega.sw_clear_mega(*a, c)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        del out
        design = ""
        if hasattr(mega, "sw_clear_mega_design"):
            dz = mega.sw_clear_mega_design(*a[:2], c)
            design = (f", chunk {dz['chunk']} layers, staged {dz['staged']} B, shared memory {dz['smem']} B, "
                      f"{dz['n_groups']} block(s) of {dz['group']}, state: {dz.get('state', 'four coefficients')}")
        say("sw-mega", f"{ROOT} sw_clear_mega {name}: {_fmt(ms[name])} ms, sha256 {h.hexdigest()[:16]}, device "
                       f"scratch of one call {scratch / 1e9:.3f} GB{design}")
    _registers(_build.library_path().with_suffix(".log"), ("sw_clear_mega_kernel",), "sw-mega")


def _rounds_of(tag: str, cases) -> None:
    """3 rounds of a median of 7 synchronized calls, the cases taking turns
    within a round; then each case's sha256 and the device scratch of one
    call (peak allocated during the call less what is allocated after it)."""
    import torch

    ms = {name: [] for name, _ in cases}
    for _ in range(3):
        for name, fn in cases:
            ms[name].append(cs.timed(fn, 7))
    for name, fn in cases:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        del out
        say(tag, f"{ROOT} {name}: {_fmt(ms[name])} ms, sha256 {h.hexdigest()[:16]}, device scratch of one call "
                 f"{scratch / 1e9:.3f} GB")


def lw2_sweep() -> None:
    import torch

    from rrtmgp_tpu_torch.ops import _build, rte_kernels

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    k14 = cs.sweep_args(lw, sw, atm, *cs.boundary_conditions(lw, sw, cs.NCOL))[1]
    del atm
    torch.cuda.empty_cache()
    inc = _incident(k14[0])
    _rounds_of("lw2-sweep", [("lw_2stream_reduced (K14)", lambda: rte_kernels.lw_2stream_reduced(*k14)),
                             ("lw_2stream_reduced (K14) with incident flux",
                              lambda: rte_kernels.lw_2stream_reduced(*k14[:7], inc))])
    if hasattr(rte_kernels, "lw_2stream_reduced_design"):
        say("lw2-sweep", f"{ROOT} design: {rte_kernels.lw_2stream_reduced_design(cs.NLAY, lw.n_gpt, inc.device)}")
    _registers(_build.library_path().with_suffix(".log"), ("lw_2stream_reduced_kernel",), "lw2-sweep")


def lw_gpt() -> None:
    import torch

    from rrtmgp_tpu_torch.ops import _build, rte_kernels

    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    k16b = cs.sweep_args(lw, sw, atm, *cs.boundary_conditions(lw, sw, cs.NCOL))[4]
    del atm
    torch.cuda.empty_cache()
    inc = (*k16b[:7], _incident(k16b[0]))
    label = "lw_noscat_gpt (K16b)"
    _rounds_of("lw-gpt", _depth_cases("LW_GPT_LAYERS", LW_GPT_DEPTHS, label, rte_kernels.lw_noscat_gpt, k16b)
               + [(f"{label} with incident flux", lambda: rte_kernels.lw_noscat_gpt(*inc))])
    if hasattr(rte_kernels, "lw_noscat_gpt_design"):
        say("lw-gpt", f"{ROOT} design: {rte_kernels.lw_noscat_gpt_design(cs.NLAY, lw.n_gpt, inc[0].device)}")
    _registers(_build.library_path().with_suffix(".log"), ("lw_noscat_gpt_kernel",), "lw-gpt")


def aerosol() -> None:
    import torch

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.ops import _build
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    atm = cs.allsky_atmosphere(cs.ALLSKY_NCOL, cs.NLAY)
    cases = []
    for wave, lkp in (("LW", L.lookup_lw_aero), ("SW", L.lookup_sw_aero)):
        a = (lkp, atm.aerosol_state, atm.rel_hum)
        cases.append((f"aerosol_bands (K5) {wave} {lkp.dust.shape[-1]} bands", lambda a=a: ab.aerosol_bands(*a)))
    _rounds_of("aerosol", cases)
    if hasattr(ab, "aerosol_bands_design"):
        for lkp in (L.lookup_lw_aero, L.lookup_sw_aero):
            design = ab.aerosol_bands_design(lkp, atm.rel_hum.device)
            say("aerosol", f"{ROOT} design {lkp.dust.shape[-1]} bands: {design}")
    _registers(_build.library_path().with_suffix(".log"), ("aerosol_bands_kernel",), "aerosol")


def _steps(tag: str, step, steps: int = 5) -> None:
    """Step time (median, min, max of ``steps``) and peak device memory."""
    import statistics

    import torch

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    say("megakernels", f"{ROOT} {tag}: step median {statistics.median(times):.3f} ms (min {min(times):.3f}, "
                       f"max {max(times):.3f}), peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    torch.cuda.empty_cache()


def megakernels() -> None:
    import torch

    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
        lookup_tables,
        solve_lw,
        solve_sw,
    )
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    tag = str(ROOT)
    lw, sw = cs.lookups(256, 16, 224, 14)
    atm = cs.atmosphere(cs.NCOL, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(lw, sw, cs.NCOL)
    k2 = cs.kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[2]
    ms = cs.timed(lambda: mega.sw_clear_mega(*k2), 7)
    say("megakernels", f"{tag} sw_clear_mega clear {cs.NCOL} x {cs.NLAY}: {ms:.3f} ms")
    del k2
    _steps(f"clear step (solve_lw + solve_sw, impl='kernel') {cs.NCOL} x {cs.NLAY}",
           lambda: (solve_lw(lw, atm, bcs_lw, impl="kernel"), solve_sw(sw, atm, bcs_sw, impl="kernel")))
    _steps(f"two-kernel step (solve_lw 3 angles + solve_sw, impl='two_kernel', + SW direct beam) "
           f"{cs.NCOL} x {cs.NLAY}",
           lambda: (solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="two_kernel"),
                    solve_sw(sw, atm, bcs_sw, impl="two_kernel"), solve_sw(sw, atm, bcs_sw, two_stream=False)))
    for name, part in (("solve_lw 3 angles", lambda: solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="two_kernel")),
                       ("solve_sw", lambda: solve_sw(sw, atm, bcs_sw, impl="two_kernel")),
                       ("solve_sw direct beam", lambda: solve_sw(sw, atm, bcs_sw, two_stream=False))):
        _steps(f"the two-kernel step's {name} alone {cs.NCOL} x {cs.NLAY}", part)
    _steps(f"unfused two-kernel step (the two-kernel step with fused_optics=False) {cs.NCOL} x {cs.NLAY}",
           lambda: (solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, fused_optics=False),
                    solve_sw(sw, atm, bcs_sw, fused_optics=False),
                    solve_sw(sw, atm, bcs_sw, two_stream=False, fused_optics=False)))
    _steps(f"sweep-route step (solve_lw 3 angles + solve_lw two-stream + solve_sw, impl='sweep') "
           f"{cs.NCOL} x {cs.NLAY}",
           lambda: (solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="sweep"),
                    solve_lw(lw, atm, bcs_lw, two_stream=True, impl="sweep"),
                    solve_sw(sw, atm, bcs_sw, impl="sweep")), steps=3)
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    ncol = cs.ALLSKY_NCOL
    atm = cs.allsky_atmosphere(ncol, cs.NLAY)
    bcs_lw, bcs_sw = cs.boundary_conditions(L.lookup_lw, L.lookup_sw, ncol)
    comp = lambda lkp, cld, aero, delta: _kernel_composition(lkp, atm, cld, aero, None, cs.MCICA_SEED, cs.COL_OFFSET,
                                                             None, delta, False)[0]
    lw, sw = L.lookup_lw, L.lookup_sw
    plk = cs.plk_fn(lw)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lev), plk(atm.t_sfc), bcs_lw.sfc_emis, None,
               comp(lw, L.lookup_lw_cld, L.lookup_lw_aero, False))
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, bcs_sw.cos_zenith, toa_gpt, bcs_sw.sfc_alb_direct,
               bcs_sw.sfc_alb_diffuse, None, comp(sw, L.lookup_sw_cld, L.lookup_sw_aero, True))
    for name, fn, args in (("lw2_mega", mega.lw2_mega, lw_args), ("sw_clear_mega", mega.sw_clear_mega, sw_args)):
        say("megakernels", f"{tag} {name} all-sky (McICA seed + aerosols) {ncol} x {cs.NLAY}: "
                           f"{cs.timed(lambda: fn(*args), 7):.3f} ms")
    del lw_args, sw_args
    torch.cuda.empty_cache()
    grid = RRTMGPGridParams(nlay=cs.NLAY, ncol=ncol, dtype=torch.float32)
    for two_stream_lw, what in ((True, "all-sky"), (False, "all-sky no-scattering")):
        solver = RRTMGPSolver(grid, AllSkyRadiation(aerosol_radiation=True), RRTMGPParameters(), bcs_lw, bcs_sw,
                              atm, lookups=L, two_stream_lw=two_stream_lw)

        def step():
            solver.advance_step()
            solver.update_fluxes()

        _steps(f"{what} step (RRTMGPSolver.update_fluxes) {ncol} x {cs.NLAY}", step)
        del solver


def mesh() -> None:
    """The column split over every card the process sees (module docstring,
    ``mesh``)."""
    import statistics

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
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.parallel.sharding import make_column_mesh
    from rrtmgp_tpu_torch.states import slice_columns

    grid_mesh = make_column_mesh()
    n = len(grid_mesh)

    def sync():
        for d in grid_mesh.devices:
            torch.cuda.synchronize(d)

    def timed_step(solver):
        """(ms until update_fluxes() returns: the host's enqueue, ms until every card is done)"""
        sync()
        t0 = time.perf_counter()
        solver.update_fluxes()
        t1 = time.perf_counter()
        sync()
        return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=cs.DEVICE)
    lw, sw = cs.lookups(256, 16, 224, 14)
    whole_clear = None
    for tag, ncol in (("all-sky", cs.ALLSKY_NCOL), ("clear", cs.NCOL)):
        allsky = tag == "all-sky"
        lk = L if allsky else LookupBundle(lookup_lw=lw, lookup_sw=sw)
        atm = cs.allsky_atmosphere(ncol, cs.NLAY) if allsky else cs.atmosphere(ncol, cs.NLAY)
        bcs_lw, bcs_sw = cs.boundary_conditions(lk.lookup_lw, lk.lookup_sw, ncol)
        method = AllSkyRadiation(aerosol_radiation=True) if allsky else ClearSkyRadiation()
        share = ncol // n
        mk = lambda a, bl, bs, nc, **kw: RRTMGPSolver(RRTMGPGridParams(nlay=cs.NLAY, ncol=nc), method,
                                                      RRTMGPParameters(), bl, bs, a, lookups=lk,
                                                      two_stream_lw=allsky, **kw)
        whole = mk(atm, bcs_lw, bcs_sw, ncol)
        split = mk(atm, bcs_lw, bcs_sw, ncol, mesh=grid_mesh)
        # one entry's share alone on cuda:0: what each card has to do
        part = mk(*(slice_columns(t, 0, share, ncol) for t in (atm, bcs_lw, bcs_sw)), share)
        for s in (whole, split, part):
            s.advance_step(5)
            s.update_fluxes()
        sync()
        mega.reset_launch_counts()
        f_split = split.update_fluxes()
        sync()
        launches = {k: v for k, v in mega.launch_counts().items() if v}
        f_whole = whole.update_fluxes()
        same = all(torch.equal(getattr(a, name)[..., o:o + share].to(t.device), t)
                   for a, b in zip(f_whole, f_split) for name in a._fields
                   for o, t in zip(getattr(b, name).offsets, getattr(b, name).shards))
        if allsky:
            same = same and all(torch.equal(whole.lw_cloud_cover()[o:o + share].to(t.device), t)
                                for o, t in zip(split.lw_cloud_cover().offsets, split.lw_cloud_cover().shards))
        say("mesh", f"{tag} {ncol} x {cs.NLAY} over {[str(d) for d in grid_mesh.devices]}: launches of one mesh "
                    f"step {launches}; bitwise the unsplit solver on cuda:0: {same}")
        cs.require(same, f"{tag}: the mesh solver differs from the unsplit one")
        times = {"unsplit": [], "mesh": [], "share": []}
        enqueue = {"unsplit": [], "mesh": [], "share": []}
        for i in range(5):
            order = [("unsplit", whole), ("mesh", split), ("share", part)]
            for name, s in (order if i % 2 == 0 else order[::-1]):
                host, total = timed_step(s)
                enqueue[name].append(host)
                times[name].append(total)
        med = {k: statistics.median(v) for k, v in times.items()}
        host = {k: statistics.median(v) for k, v in enqueue.items()}
        ms = lambda k: f"median {med[k]:.3f} ms ({_fmt(times[k])}; enqueued in {host[k]:.3f})"
        say("mesh", f"{tag} update_fluxes(), 5 steps each in turns: unsplit on cuda:0 {ms('unsplit')}; mesh of {n} "
                    f"{ms('mesh')}; one entry's {share} columns alone on cuda:0 {ms('share')}; unsplit / mesh "
                    f"{med['unsplit'] / med['mesh']:.3f}, share / mesh {med['share'] / med['mesh']:.3f}")
        if not allsky:
            whole_clear = tuple(f.clone() for f in (*whole.flux_lw, *whole.flux_sw))
        del whole, split, part, atm, bcs_lw, bcs_sw, f_split, f_whole
        torch.cuda.empty_cache()
    cs.phase_mesh_world(whole_clear, world=n)


def main() -> None:
    want = ARGS or ["f64-memory", "angles", "profile", "profile-two-kernel", "profile-sweep"]
    cs.phase_device()
    cs.phase_build()
    warnings.simplefilter("ignore")  # the f64 torch-path and auto-chunk notices
    for name, fn in (("f64-memory", f64_memory), ("angles", angles), ("profile", profile_cells),
                     ("profile-two-kernel", profile_two_kernel), ("profile-sweep", profile_sweep),
                     ("kernel-hashes", kernel_hashes), ("megakernels", megakernels), ("gather", gather),
                     ("sw-sweep", sw_sweep), ("lw-sweep", lw_sweep), ("sw-mega", sw_mega),
                     ("lw2-sweep", lw2_sweep), ("lw-gpt", lw_gpt), ("aerosol", aerosol), ("planck", planck),
                     ("mesh", mesh)):
        if name in want:
            fn()


if __name__ == "__main__":
    main()
