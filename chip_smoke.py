"""Drive the PyTorch/CUDA port (rrtmgp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of rrtmgp_tpu_torch/csrc;
3. kernels: each kernel against its plain torch twin on the card, first at
   small shapes (ncol 1000, 36 g-points in 4 bands, f32 and f64), then at
   the main paths' shapes: the clear-sky kernels at 32768 columns x 60
   layers in f32 and, for planck_band, lw_clear_mega and sw_clear_mega, in
   f64 (the f64 twins on 4096-column chunks; f64 against f32 too), the
   all-sky ones
   (lw2_mega clear / cloud mask / McICA seed + aerosols, lw_clear_mega with
   cloud mask / aerosols / seed + aerosols, sw_clear_mega with cloud mask +
   aerosols / seed + aerosols, aerosol_bands, mcica_mask_export) at 75748 x
   60, LW 256 / SW 224 g-points, their twins on 8192-column chunks, and
   cloud_bands (LW 16 bands, SW 14 delta-scaled) bit for bit its twin at
   full width); with
   each kernel's median time, its twin's, and its bound (the larger of its
   input and output bytes over 3.35 TB/s and its operations over the
   card's peak rate); band Planck as the solves launch it (planck_band,
   its f64 build and planck_band_rows: the three temperature sets in one
   launch) with its library yardstick, torch.nn.functional.grid_sample on
   the same sets (its error against the twin and its time, library_ms; for
   the rows the faster of one call and bands leading then transposed);
4. clear slice: solve_lw (LW no-scattering) + solve_sw (SW two-stream)
   through the kernels at 32768 x 60 on the synthetic tables and
   atmosphere of the JAX package's bench.py, with physics oracles, night
   columns, the kernel path against the torch path on the first 4096
   columns, launch counts, and the step time;
5. all-sky slice: RRTMGPSolver + AllSkyRadiation(aerosol_radiation=True)
   at the reference's all-sky DYAMOND size (75748 x 60, LW two-stream 256
   / SW two-stream 224 g-points; benchmarks/dyamond.py) on the synthetic
   cloudy, aerosol-laden atmosphere with fractional cloud fraction:
   update_fluxes() step time, columns/s and peak memory, launch counts,
   physics and McICA oracles, step reproducibility, column-split
   invariance, seed mode against the exported-mask mode (the path that
   launches mcica_mask_export), the kernel path against the torch path,
   and one AllSkyRadiationWithClearSkyDiagnostics step;
6. f64 slice: RRTMGPSolver in f64 with ClearSkyRadiation and LW
   no-scattering at 32768 x 60: LW through the f64 builds of planck_band
   and lw_clear_mega, SW through the f64 build of sw_clear_mega, both in
   the auto-chunk's column chunks; step time, columns/s, peak memory; LW
   within 1e-4 W/m2 of the exact f64 torch path and 5e-5 of the f32 slice,
   SW within 1e-12 of the exact f64 torch path, chunked SW equal to
   unchunked bit for bit, 3 angles, and the aerosol-laden clear-sky solver
   keeping its aerosols on the torch path;
7. all-sky no-scattering slice: RRTMGPSolver + AllSkyRadiation(aerosol_
   radiation=True) with two_stream_lw=False at 75748 x 60 in f32: LW
   through lw_clear_mega composed with in-kernel McICA and aerosols; step
   time, columns/s, peak memory, launch counts, the McICA oracles, the
   kernel path against the torch path, and 3 angles (one megakernel launch
   each);
8. two-kernel slice (run after the clear slice, on its inputs): the
   kernels of the two-kernel path (optics_fused LW and SW, planck_band_rows,
   lw_noscat_banded_reduced at 1 angle and at solve_lw's 3 angles in one
   launch, sw_2stream_reduced) against their twins at the small shape and at
   32768 x 60 (twins on 8192-column chunks; the SW sweep also with an
   asymmetry on an all-sky composition at 8192 columns), then
   solve_lw with 3 angles + solve_sw through impl="two_kernel" and the SW
   direct-beam solve with the default impl at 32768 x 60: step time,
   columns/s, peak memory, launches per step; the two-kernel path against
   the megakernel path at full width and against the torch path on 4096
   columns; direct beam monotone with flux_up = flux_dn = 0, night columns
   0, LW TOA down = 0; all-sky (McICA by seed + aerosols) through the
   two-kernel path against the torch path at 8192 columns. (The time of 1-4
   LW angles on both routes: scripts/port_measure.py angles.)
9. sweep slice (after the two-kernel slice, on the clear cell's inputs; its
   all-sky part after the all-sky slices, on theirs): the four sweeps from
   materialized optics and sources (lw_noscat_reduced, lw_2stream_reduced,
   sw_2stream_gpt, lw_noscat_gpt) against their twins at the small shape and
   at 32768 x 60 (lw_noscat_reduced at 1 angle and at solve_lw's 3 angles
   in one launch, bit for bit the one-angle launches summed; twins on
   8192-column chunks; lw_2stream_reduced and
   sw_2stream_gpt also with ssa and g of an all-sky composition at 8192
   columns; sw_2stream_gpt and lw_noscat_gpt also with an incident flux).
   Path A, LW two-stream on the two-kernel path:
   solve_lw(two_stream=True, impl="two_kernel") clear at 32768 x 60 against
   the megakernel route at full width and the torch path on 4096 columns,
   and all-sky (McICA by seed + aerosols) at 75748 x 60, unchunked if its
   memory (measured on 8192 columns and scaled) fits the card, else through
   solve_chunked, with the peak memory and the cloud cover bitwise. Path B,
   the sweep-only route: one step = solve_lw with 3 angles + solve_lw
   two-stream + solve_sw through impl="sweep" at 32768 x 60 (3 steps; the
   3 angles in one lw_noscat_reduced launch): step
   time, columns/s, peak memory, launches per step, against the torch path
   on 4096 columns, LW TOA down = 0, night columns 0. Path C: each
   per-g-point sweep, summed over g-points, against its g-summed sibling
   (5e-6 of the largest flux: the two add the same 224 or 256 values in
   another order). And boundary conditions in f64 with an f32 atmosphere
   through the default impl equal the cast input's result bit for bit.
10. unfused two-kernel slice (after the two-kernel slice, on the clear
   cell's inputs, nothing cut): the kernels of the unfused optics
   (interp_pt_eta for each table it reads: LW kmajor with col_mix, LW
   Planck fraction, SW kmajor, SW Rayleigh at the troposphere side's slab
   with fpress = 0; interp_minor LW and SW) against their twins at the small
   shape and at 32768 x 60 (twins on 8192-column chunks); then one step =
   the two-kernel slice's step with fused_optics=False (the JAX
   pallas_windowed="off"): solve_lw with 3 angles + solve_sw + the SW
   direct-beam solve, with the step time, columns/s, peak memory and
   launches per step; the unfused optics against optics_fused at full width
   (bitwise printed), the fluxes against the fused two-kernel route at full
   width (2e-6, bitwise printed) and the torch path on 4096 columns, the
   two-kernel slice's oracles, and all-sky (McICA by seed + aerosols)
   against the torch path at 8192 columns.

11. wide and deep (after the small shapes): every kernel against its twin
   at 1100 g-points, more than a block has threads, and at 1000, more than
   a block of the register-heavy kernels (lw2_mega, sw_clear_mega all-sky
   seeded) may have (ncol 64, 12 layers: the megakernels, the two-kernel
   path, the sweeps, the unfused optics, f64; every check line of a kernel
   of one thread per g-point prints its plan: blocks per column, threads a
   block and the kernel's maxThreadsPerBlock), and the all-sky kernels, lw2_mega and sw_clear_mega among them, at 800
   layers (ncol 512, LW 256 / SW 224 g-points), where their in-block level
   sums take more than the 48 KB of shared memory a block gets without
   asking. The lw2_mega and sw_clear_mega lines of every phase print their
   design (the adding state in device memory, blocks per column;
   sw_clear_mega also its staging chunk, staged bytes and registers) and
   the device scratch of one call, measured: the peak allocated during the
   call less what it returns. The optics_fused, interp_pt_eta, interp_minor and
   lw_clear_mega (clear, composed, f64) lines print theirs: the block shape,
   column tile or staging chunk, dynamic shared memory, ptxas registers and
   whether an L2 access-policy window is set (it is not: measured slower).
   The lw_noscat_banded_reduced and lw_noscat_reduced lines print their
   angles per launch, launch plan and registers at 1 and 3 angles. The
   sw_2stream_reduced line prints its passes, its scratch arrays, the
   device scratch of one call, measured, and its registers; the
   lw_2stream_reduced line its chunk, where its checkpoints live, the
   device scratch of one call, measured, and its registers; the
   sw_2stream_gpt line its passes, where its state lives (its outputs and,
   for the bottom levels, shared memory), the device scratch of one call,
   measured (none), and its registers; the
   lw_noscat_gpt line the bottom layers it keeps in shared memory, its
   plan, the device scratch of one call and its registers; the
   aerosol_bands line its staged bytes, blocks an SM and registers.
12. gradients (after the sweep slice, on the clear cell's inputs; then
   with aerosols on 8192 columns of the all-sky atmosphere after the
   all-sky slices): differentiable_solve_lw (no-scattering, two-stream)
   and differentiable_solve_sw with impl=None (the megakernels, K5 with
   aerosols) and "two_kernel", the gradient of the summed TOA upward LW /
   surface downward SW flux with respect to t_lay, t_lev, t_sfc and
   sfc_emis (LW) or t_lay and every SW boundary condition: the forward
   bitwise equal to solve_lw / solve_sw on the same route, the gradient
   bitwise equal to torch.autograd.grad through impl="torch" in the same
   column chunks, the kernels of the route launched; forward and backward
   ms, the chunk, the backward's peak memory and its elements per
   (column, layer, g-point); on 4096 columns a backward in chunks of 1024
   (grad_chunk patched to force them) within 1e-6 of one chunk; then
   differentiable_solve_lw (no-scattering) with 3 and 4 quadrature angles
   on 8192 columns, its backward in chunks of 4096: the elements per
   (column, layer, g-point) it holds (grad_chunk budgets
   GRAD_ELEMENTS_PER_POINT), the gradient bitwise the chunked torch
   path's, chunks of 1024 within 1e-6 of one chunk;
13. mesh (after the all-sky slices): RRTMGPSolver(mesh=make_column_mesh(
   [cuda:0, cuda:0])), two entries on the one card, against the unsplit
   solver on the same inputs: AllSkyRadiation(aerosol_radiation=True) at
   75748 x 60 (two entries of 37874 columns, LW two-stream, McICA by seed
   on the fractional cloud: K3, K4, K2 twice and K5 four times a step) and
   ClearSkyRadiation at 32768 x 60 (LW no-scattering: K3, K1, K2 twice a
   step): the launches of one mesh step, assert_compiles_once quiet over a
   second, update_fluxes() bitwise equal (fluxes and cloud cover, the mean
   cover strictly between 0 and 1), both steps' medians timed in turns.
   Then a world of two: two processes of this script (--mesh-worker) on
   cuda:0, joined by gloo on a free localhost port, each with a time limit,
   each building its half of the clear 32768 x 60 state and running
   globalize -> RRTMGPSolver(mesh=global_column_mesh()) -> local_values;
   both halves bitwise the unsplit clear solver's fluxes;
14. data (after the mesh phase): a fabricated rrtmgp-data v1.9
   checkout written with scipy (NetCDF3; scripts/fabricate_rrtmgp_data.py):
   the six lookup files from the full-width synthetic lookups with the
   loader's hard cases added (a minor gas not in gas_names, a shared
   g-point range, no scaling gas, the h2o alias, a 0/0 key species) and
   some variables' axes reversed, an RFMIP input (100 sites x 60 layers,
   2 experiments) and an all-sky example (60 layers); validated with the
   v1.9 sizes; each file loaded (its time printed) and every table held
   within 1e-12 of the one written; RRTMGPSolver(data_dir=...) on the
   RFMIP input tiled to 32768 x 60 (clear, LW no-scattering: K3, K1, K2)
   and on the all-sky example tiled to 75748 x 60 (AllSkyRadiation with
   aerosols: K3, K4, K2, K5), each against impl="torch" on 4096 columns
   and against the same step on the lookups and state in memory, timed by
   utils.profiling.benchmark; then utils.profiling.trace of a clear step
   (the kernels named in the trace), strict_mode (a clean step passes, a
   NaN in t_lay raises, a NaN a kernel writes is caught by its wrapper),
   assert_compiles_once over a step on new data, device_memory_stats;
15. gray (last): RRTMGPSolver(GrayRadiation()) at 32768 x 60 in f32 and
   f64, LW no-scattering + SW two-stream and LW two-stream + SW direct
   beam (O'Gorman 2008): update_fluxes() step time, LW TOA down 0, surface
   up sigma T^4, night columns 0, the direct beam within 1e-3 of
   Beer-Lambert; then gray_lw_equilibrium in f64 at 9 x 60 (Schneider
   2004) to the reference's 0.1 K gate, with its steps, seconds and time a
   step (blocks of 64 steps replayed as CUDA graphs).
16. routes (after the mesh phase, before the data phase): RRTMGPSolver
   with impl=None at 1024 x 60 on the all-sky lookups (LW 256 / SW 224
   g-points) and the cloudy, aerosol-laden atmosphere with fractional
   cloud. (a) The f64 solver with fused_optics=False (the JAX
   pallas_windowed="off", which the JAX package's f64 ignores): clear sky
   with LW no-scattering at 1 and at 3 angles (the f64 lw_clear_mega, K7:
   one launch per angle and one planck_band per LW solve), all-sky with
   aerosols with LW two-stream and with LW no-scattering at 3 angles (the
   torch path: no launch), SW two-stream (clear: the f64 sw_clear_mega)
   and the direct beam; each bitwise
   the fused f64 solver, and on a mesh of two entries on cuda:0 bitwise the
   unsplit one, with both steps' medians. (b) A covering set of the
   option matrix (every pair of two options' values in some configuration,
   pairwise_configs: radiation method with and without aerosols and clear
   diagnostics, f64_kernel, dtype, two_stream_lw, n_gauss_angles 1 / 3,
   two_stream_sw, fused_optics, metric_scaling, mesh, isothermal boundary
   layer): no refusal, the launches of the route table (route_launches),
   every flux within its route's tolerance of impl="torch" (the f64 torch
   route bit for bit), cloud cover bitwise, AOD within 1e-6; the phase's
   wall time.

The last lines are a JSON object per kernel, the card's name and power
limit, and {"ok": true, "device": {...}}. Needs CUDA and nvcc; imports no
JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

NCOL, NLAY = 32768, 60          # bench.py's DYAMOND-order clear-sky batch
ALLSKY_NCOL = 75748             # benchmarks/dyamond.py:27, the reference's all-sky DYAMOND size
TWIN_CHUNK = 8192               # the all-sky twins run on column chunks (bounds their memory)
F64_TWIN_CHUNK = 4096           # the f64 twin holds 8-byte (nlay, ncol, ngpt) tensors
ANGLES_NCOL = 8192              # the 3-angle all-sky comparison
SMALL_NCOL, SMALL_NLAY = 1000, 30
WIDE_NGPT, WIDE_NCOL, WIDE_NLAY = 1100, 64, 12  # more g-points than a block has threads
LIMIT_NGPT = 1000               # fewer than 1024, more than a block of the register-heavy kernels holds
DEEP_NCOL, DEEP_NLAY = 512, 800  # the megakernels' in-block level sums past 48 KB
CMP_NCOL = 4096                 # kernel vs torch path on the first columns
STEPS = 5
DEVICE = "cuda"
MCICA_SEED, COL_OFFSET = 11, 384
TOL = {"planck_band": 1e-6, "lw_clear_mega": 5e-5, "sw_clear_mega": 1e-4,
       "lw2_mega": 1e-4, "sw_clear_mega_allsky": 1e-4, "aerosol_bands": 1e-6,
       "mcica_mask_export": 0.0, "planck_band_f64": 1e-14, "lw_clear_mega_f64": 1e-12, "sw_clear_mega_f64": 1e-12,
       "lw_clear_mega_allsky": 5e-5, "optics_fused_lw": 1e-6, "optics_fused_sw": 1e-6,
       "planck_band_rows": 1e-6, "lw_noscat_banded_reduced": 5e-5, "sw_2stream_reduced": 1e-4,
       "lw_noscat_reduced": 5e-5, "lw_2stream_reduced": 1e-4, "sw_2stream_gpt": 1e-4, "lw_noscat_gpt": 5e-5,
       "interp_pt_eta": 1e-6, "interp_minor": 1e-6, "cloud_bands_lw": 0.0, "cloud_bands_sw": 0.0}
UNFUSED_TOL = 2e-6              # the unfused route's fluxes vs the fused two-kernel route's (bitwise expected)
SUM_TOL = 5e-6                  # a per-g-point sweep summed over g-points vs its g-summed sibling
F32_SW_TOL = 1e-2               # the f32 SW kernel vs the f64 one: f32's own error (3-4e-4 at the f64 cell)
F64_LW_TOL_WM2 = 1e-4           # the reference's f64 LW tolerance, absolute
SOURCES = {
    "planck_band": ("rrtmgp_tpu_torch/csrc/planck_band.cu", "rrtmgp_tpu/ops/pallas_mega.py:224"),
    "lw_clear_mega": ("rrtmgp_tpu_torch/csrc/lw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:522"),
    "sw_clear_mega": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
    "lw2_mega": ("rrtmgp_tpu_torch/csrc/lw2_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:1511"),
    "sw_clear_mega_allsky": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
    "aerosol_bands": ("rrtmgp_tpu_torch/csrc/aerosol_bands.cu", "rrtmgp_tpu/ops/pallas_aerosol.py:64"),
    "mcica_mask_export": ("rrtmgp_tpu_torch/csrc/mcica_export.cu", "rrtmgp_tpu/ops/pallas_mega.py:1983"),
    "planck_band_f64": ("rrtmgp_tpu_torch/csrc/planck_band.cu", "rrtmgp_tpu/ops/pallas_mega.py:224"),
    "lw_clear_mega_f64": ("rrtmgp_tpu_torch/csrc/lw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega_df.py:218"),
    "sw_clear_mega_f64": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
    "lw_clear_mega_allsky": ("rrtmgp_tpu_torch/csrc/lw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:522"),
    "optics_fused_lw": ("rrtmgp_tpu_torch/csrc/optics_fused.cu", "rrtmgp_tpu/ops/pallas_interp.py:530"),
    "optics_fused_sw": ("rrtmgp_tpu_torch/csrc/optics_fused.cu", "rrtmgp_tpu/ops/pallas_interp.py:530"),
    "planck_band_rows": ("rrtmgp_tpu_torch/csrc/planck_band.cu", "rrtmgp_tpu/ops/pallas_interp.py:828"),
    "lw_noscat_banded_reduced": ("rrtmgp_tpu_torch/csrc/lw_noscat_banded.cu", "rrtmgp_tpu/ops/pallas_rte.py:858"),
    "sw_2stream_reduced": ("rrtmgp_tpu_torch/csrc/sw_2stream_reduced.cu", "rrtmgp_tpu/ops/pallas_rte.py:225"),
    "lw_noscat_reduced": ("rrtmgp_tpu_torch/csrc/lw_noscat_sources.cu", "rrtmgp_tpu/ops/pallas_rte.py:567"),
    "lw_2stream_reduced": ("rrtmgp_tpu_torch/csrc/lw_2stream_reduced.cu", "rrtmgp_tpu/ops/pallas_rte.py:667"),
    "sw_2stream_gpt": ("rrtmgp_tpu_torch/csrc/sw_2stream_reduced.cu", "rrtmgp_tpu/ops/pallas_rte.py:104"),
    "lw_noscat_gpt": ("rrtmgp_tpu_torch/csrc/lw_noscat_sources.cu", "rrtmgp_tpu/ops/pallas_rte.py:513"),
    "interp_pt_eta": ("rrtmgp_tpu_torch/csrc/interp_pt_eta.cu", "rrtmgp_tpu/ops/pallas_interp.py:110"),
    "interp_minor": ("rrtmgp_tpu_torch/csrc/interp_minor.cu", "rrtmgp_tpu/ops/pallas_interp.py:405"),
    # new code: the JAX package computes cloud optics in XLA, with no pallas_call
    "cloud_bands_lw": ("rrtmgp_tpu_torch/csrc/cloud_bands.cu", "none (rrtmgp_tpu/ops/cloud_optics.py, XLA)"),
    "cloud_bands_sw": ("rrtmgp_tpu_torch/csrc/cloud_bands.cu", "none (rrtmgp_tpu/ops/cloud_optics.py, XLA)"),
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def rel_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, that over max |ref|) across a tuple of tensors;
    raises on a non-finite value."""
    import torch

    err = scale = 0.0
    for a, b in zip(out, ref):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite output")
        err = max(err, (a.double() - b.double()).abs().max().item())
        scale = max(scale, b.double().abs().max().item())
    return err, err / scale if scale else err


def timed(fn, reps: int) -> float:
    """Median wall milliseconds of fn() over reps, synchronised around each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Problem setup
# ---------------------------------------------------------------------------


def lookups(n_lw, b_lw, n_sw, b_sw, dtype="float32"):
    import numpy as np

    from rrtmgp_tpu_torch.data.synthetic import synthetic_gas_lookup

    dt = np.dtype(dtype).type
    lw = synthetic_gas_lookup(longwave=True, n_gpt=n_lw, n_bnd=b_lw, dtype=dt, device=DEVICE)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=n_sw, n_bnd=b_sw, seed=1, dtype=dt, device=DEVICE)
    return lw, sw


def small_allsky_lookups(n_gpt=36, gas=None):
    """A LookupBundle at the small shapes (36 g-points in 4 bands); ``gas``:
    its (LW, SW) gas lookups when already built (``lookups(n_gpt, 4,
    n_gpt, 4)``: at 1000 g-points each takes ~15 s to generate)."""
    import numpy as np

    from rrtmgp_tpu_torch import LookupBundle
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    lw, sw = gas or lookups(n_gpt, 4, n_gpt, 4)
    kw = dict(n_bnd=4, dtype=np.float32, device=DEVICE)
    return LookupBundle(
        lookup_lw=lw, lookup_sw=sw,
        lookup_lw_cld=synthetic_cloud_lookup(**kw), lookup_sw_cld=synthetic_cloud_lookup(seed=5, **kw),
        lookup_lw_aero=synthetic_aerosol_lookup(**kw), lookup_sw_aero=synthetic_aerosol_lookup(seed=6, **kw),
    )


def atmosphere(ncol, nlay, dtype="float32", **kw):
    import numpy as np

    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere

    return synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.dtype(dtype).type, device=DEVICE, **kw)


def allsky_atmosphere(ncol, nlay, dtype="float32"):
    """The synthetic atmosphere with clouds and aerosols; its cloud
    fraction (0 or 1) times a numpy-seeded uniform in [0.2, 1], so that the
    McICA mask depends on the draws."""
    import numpy as np
    import torch

    atm = atmosphere(ncol, nlay, dtype, with_clouds=True, with_aerosols=True)
    scale = np.random.default_rng(17).uniform(0.2, 1.0, (nlay, ncol)).astype(dtype)
    cs = atm.cloud_state
    cf = (cs.cld_frac * torch.from_numpy(scale).to(DEVICE)).contiguous()
    return dataclasses.replace(atm, cloud_state=dataclasses.replace(cs, cld_frac=cf))


def boundary_conditions(lw, sw, ncol, mu0=None):
    """Boundary values of the cells, in the lookups' dtype."""
    import torch

    from rrtmgp_tpu_torch import LwBCs, SwBCs

    f = lambda shape, v: torch.full(shape, v, dtype=lw.kmajor.dtype, device=DEVICE)
    bcs_lw = LwBCs(sfc_emis=f((lw.n_bnd, ncol), 0.98))
    bcs_sw = SwBCs(
        cos_zenith=f((ncol,), 0.6) if mu0 is None else mu0,
        toa_flux=f((ncol,), 1361.0),
        sfc_alb_direct=f((sw.n_bnd, ncol), 0.2),
        sfc_alb_diffuse=f((sw.n_bnd, ncol), 0.2),
    )
    return bcs_lw, bcs_sw


def plk_fn(lw):
    from rrtmgp_tpu_torch.ops.mega import planck_band

    return lambda t: planck_band(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)


def kernel_args(lw, sw, atm, bcs_lw, bcs_sw):
    """The clear-sky wrappers' arguments exactly as solve_lw / solve_sw build
    them (LW only when ``sw`` is None)."""
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    Ds, wts = angular_discretization(1)
    plk = plk_fn(lw)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lay), plk(atm.t_lev),
               plk(atm.t_sfc), bcs_lw.sfc_emis, None, float(Ds[0]), float(wts[0]))
    sw_args = None
    if sw is not None:
        toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
        sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, bcs_sw.cos_zenith, toa_gpt,
                   bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse, None)
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    return plk_args, lw_args, sw_args


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# Arithmetic per (layer, column, g-point), counted from the kernels' sources
# with an exp, a sqrt or a divide as one operation: the table interpolations
# and blends, the transport or two-stream coefficients and adding, the
# sweeps and the shuffle sums of the levels.
OPS_PER_POINT = {"lw_clear_mega": 90, "sw_clear_mega": 150, "lw2_mega": 140,
                 # the optics alone: major tau and the Planck fraction, or major tau, Rayleigh and ssa
                 "optics_fused_lw": 50, "optics_fused_sw": 42,
                 # the minor gases alone: only the covering intervals' operations
                 "interp_minor": 0}
OPS_LW_SWEEP = 44         # two sweeps of exp, Clough factor (a divide), sqrt, two sources, recurrence, level sum
OPS_LW2_SWEEP = 70        # coefficients (two exp, a sqrt, two divides), Toon sources, adding (a divide), flux pass, sums
OPS_SW_SWEEP = 110        # beam, coefficients (three exp, a sqrt, two divides), adding, flux pass, level sums
OPS_PER_MINOR = 14        # one covering minor-gas interval: two eta blends, the temperature blend, scale, add
OPS_INCREMENT = {"lw_clear_mega": 3, "sw_clear_mega": 12, "lw2_mega": 12}  # one cloud or aerosol increment
OPS_MCICA = 85            # threefry2x32 (20 rounds of add, rotate, xor; integer) and the overlap recurrence
OPS_PLANCK = 10           # per band value
OPS_AEROSOL = 90          # per (layer, column, band): 15 species, a table blend and three sums each
OPS_CLOUD = 40            # per (layer, column, band): two phases' table blends and products, the ratios, delta scaling
OPS_INTERP = 26           # one table point: four pressure blends, two eta blends, two col_mix scales, the T blend


def nbytes(x) -> int:
    """Bytes of the tensors of a kernel argument (nested tuples,
    Compositions, containers). KernelTables count their own layouts, not
    the lookup they were built from."""
    import torch

    from rrtmgp_tpu_torch.states import TensorContainer

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, TensorContainer):
        return sum(nbytes(getattr(x, f.name)) for f in dataclasses.fields(x) if f.name != "lkp")
    if isinstance(x, (tuple, list)):
        return sum(nbytes(v) for v in x)
    return 0


def mega_ops(name, inp, tabs, comp=None) -> float:
    """Operations of one megakernel call on these inputs: the minor-gas
    loop counts the intervals that cover each g-point on the troposphere
    side of each cell, as this atmosphere has them."""
    per_side = (tabs.minor_start[:, 1:] - tabs.minor_start[:, :-1]).double().mean(dim=1)
    lower = inp.tropo_lower.double().mean().item()
    per_point = OPS_PER_POINT[name] + OPS_PER_MINOR * (lower * per_side[0].item() + (1 - lower) * per_side[1].item())
    if comp is not None:
        n_incr = (comp.cld_bands is not None) + (comp.aero_bands is not None)
        per_point += OPS_INCREMENT[name] * n_incr + (OPS_MCICA if comp.seeded else 0)
    return per_point * inp.nlay * inp.ncol * tabs.lkp.n_gpt


class Work(NamedTuple):
    """What a kernel call must do: the bytes of its inputs (its outputs are
    added when they exist), its operations and their type."""

    input_bytes: int
    ops: float
    kind: str = "f32"


def bound_ms(work: Work, out) -> tuple[float, str]:
    """(milliseconds, "bytes" or "operations"): the larger of the input and
    output bytes over the card's memory rate and the operations over its
    peak rate for their type (the H100 figures of utils.perf_accounting)."""
    from rrtmgp_tpu_torch.utils.perf_accounting import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    t_bytes = (work.input_bytes + nbytes(out)) / HBM_BYTES_PER_S
    t_ops = work.ops / PEAK_OPS_PER_S[work.kind]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    phase("device", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
                    f"{torch.cuda.device_count()} device(s)")
    phase("device", f"nvidia-smi: {smi}")
    return smi


def phase_build() -> float:
    from rrtmgp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    phase("build", f"{path.name} in {seconds:.1f} s (nvcc {_build.find_nvcc()}, one process per source)")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            phase("build", line.strip())
    return seconds


def call_scratch(kern) -> int:
    """The device scratch of one call ``kern()``, measured: the peak
    allocated during the call less what is allocated after it (its outputs
    kept)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = kern()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out
    return scratch


def print_design(label, name, kern, design) -> None:
    """The design lw2_mega runs (``mega.lw2_mega_design``), and the device
    scratch of one call ``kern``, measured: the peak allocated during the
    call less what is allocated after it (what was there before, and what
    the call returns)."""
    scratch = call_scratch(kern)
    sums = "in the block" if design["in_block"] else "warp partials in device memory"
    phase("kernels", f"{label} {name} design: adding state in device memory, {design['n_groups']} block(s) of "
                     f"{design['group']} threads per column (maxThreadsPerBlock {design['max_threads']}), level "
                     f"sums {sums}; device scratch of one call {scratch / 1e9:.3f} GB (measured)")


def print_sw_mega_design(label, name, kern, args, comp) -> None:
    """The design sw_clear_mega runs (csrc/sw_clear_mega.cu): the state
    layout, the staging chunk, the staged and the whole dynamic shared
    memory, the launch plan, ptxas registers of the variant launched, and
    the device scratch of one call ``kern``, measured as print_design
    measures it."""
    import torch

    from rrtmgp_tpu_torch.ops import mega

    design = mega.sw_clear_mega_design(*args[:2], comp)
    scratch = call_scratch(kern)
    mode = 2 if comp.seeded else int(comp.cld_mask is not None)
    real = "d" if args[0].ftemp.dtype == torch.float64 else "f"
    variant = (f"sw_clear_mega_kernelI{real}Lb{int(comp.cld_bands is not None)}ELb{int(comp.aero_bands is not None)}"
               f"ELi{mode}ELb{int(not design['in_block'])}")
    sums = "in the block" if design["in_block"] else "warp partials in device memory"
    phase("kernels", f"{label} {name} design: state four (nlay, ncol, ngpt) arrays in device memory "
                     f"({design['state']}), staged gather by "
                     f"chunks of {design['chunk']} layers (cp.async, double-buffered), staged {design['staged']} B, "
                     f"dynamic shared memory {design['smem']} B, {design['n_groups']} block(s) of {design['group']} "
                     f"threads per column, level sums {sums}; ptxas: {kernel_registers(variant)}; device scratch "
                     f"of one call {scratch / 1e9:.3f} GB (measured)")


def kernel_registers(fragment: str) -> str:
    """ptxas's resource line of the first kernel whose mangled name holds
    ``fragment`` (the build log beside the library)."""
    from rrtmgp_tpu_torch.ops import _build

    entry = None
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and fragment in entry:
            return line.split(":", 1)[1].strip()
    return "not in the build log"


def print_gather_design(label, name, design: dict, fragment: str) -> None:
    """The design optics_fused / lw_clear_mega run around the staged table
    gather (csrc/gather.cuh): block shape, column tile or staging chunk,
    dynamic shared memory, registers."""
    if "tile" in design:
        shape = (f"block = 1 layer x {design['tile']} columns (column tile) x {design['group']} threads, one "
                 f"per g-point, {design['n_groups']} block(s) per tile; streaming stores")
    else:
        sums = "in the block" if design["in_block"] else "in device memory"
        shape = (f"{design['n_groups']} block(s) of {design['group']} threads per column, staging chunk "
                 f"{design['chunk']} layers (cp.async, double-buffered), level sums {sums}")
    phase("kernels", f"{label} {name} design: {shape}; dynamic shared memory {design['smem']} B; "
                     f"ptxas: {kernel_registers(fragment)}; L2 access-policy window off")


def print_sw_sweep_design(label, kern, nlay, ncol, ngpt) -> None:
    """The design sw_2stream_reduced runs (csrc/sw_2stream_reduced.cu: three
    passes, coefficients recomputed) with the wrapper's launch plan, its
    scratch arrays and the device scratch of one call ``kern``, measured as
    print_design measures it."""
    import torch

    from rrtmgp_tpu_torch.ops import rte_kernels

    plan = rte_kernels.sweep_plan("sw_2stream_reduced", 3, nlay, ngpt, torch.device(DEVICE))
    scratch = call_scratch(kern)
    sums = "in the block" if plan.in_block else "warp partials in device memory"
    phase("kernels", f"{label} sw_2stream_reduced design: three passes (beam top-down; adding bottom-up and flux "
                     f"top-down with the coefficients recomputed), {plan.n_groups} block(s) of {plan.group} threads "
                     f"per column, level sums {sums}; 2 scratch arrays (the beam, then the albedo in its slots; the "
                     f"source) of {nlay * ncol * ngpt * 4 / 1e9:.3f} GB each; device scratch of one call "
                     f"{scratch / 1e9:.3f} GB (measured); ptxas: "
                     f"{kernel_registers('sw_2stream_reduced_kernelIfLb0ELb0')}")


def print_lw2_sweep_design(label, kern, nlay, ngpt) -> None:
    """The design lw_2stream_reduced runs (csrc/lw_2stream_reduced.cu: the
    adding state checkpointed every LW2_CHUNK levels in device memory and
    replayed a chunk at a time into shared memory) with the wrapper's launch plan,
    the device scratch of one call ``kern``, measured as print_design
    measures it, and its registers."""
    import torch

    from rrtmgp_tpu_torch.ops import rte_kernels

    design = rte_kernels.lw_2stream_reduced_design(nlay, ngpt, torch.device(DEVICE))
    scratch = call_scratch(kern)
    sums = "in the block" if design["in_block"] else "warp partials in device memory"
    variant = f"lw_2stream_reduced_kernelIfLb{int(not design['in_block'])}"
    phase("kernels", f"{label} lw_2stream_reduced design: chunks of C = {design['chunk']} layers, (alb, src) "
                     f"checkpoints at {design['checkpoints']} levels in device memory, each chunk's adding state "
                     f"replayed top-down into shared memory (4 x {design['chunk']} words a thread, "
                     f"{design['chunk_smem']} B a block); {design['n_groups']} block(s) of "
                     f"{design['group']} threads per column (maxThreadsPerBlock {design['max_threads']}), level "
                     f"sums {sums}; device scratch of one call {scratch / 1e9:.3f} GB (measured); ptxas: "
                     f"{kernel_registers(variant)}")


def print_gpt_sweep_designs(label, k16a, k16b) -> None:
    """The designs of the per-g-point sweeps on their arguments ``k16a`` /
    ``k16b`` (``rte_kernels.sw_2stream_gpt_design`` and
    ``lw_noscat_gpt_design``): sw_2stream_gpt's three passes with the state
    in its outputs and lw_noscat_gpt's upward sources from the downward
    pass, each with the bottom levels or layers it keeps in shared memory,
    its launch plan, the device scratch of one call, measured as
    print_design measures it, and its registers."""
    import torch

    from rrtmgp_tpu_torch.ops import rte_kernels

    dev = torch.device(DEVICE)
    for name, args, what, variant in (
            ("sw_2stream_gpt", k16a, "three passes (the beam top-down to flux_dir; adding bottom-up and flux "
             "top-down with the coefficients recomputed), the state in the outputs (each level's albedo and source "
             "in flux_up / flux_dn until the flux pass overwrites them), the bottom {} of {} levels' albedo and "
             "source", f"sw_2stream_gpt_kernelIfLb{int(k16a[2] is not None)}"),
            ("lw_noscat_gpt", k16b, "the bottom {} of {} layers' transmittance and upward source from the "
             "downward pass", "lw_noscat_gpt_kernelIfLb")):
        nlay, _, ngpt = args[0].shape
        design = (rte_kernels.sw_2stream_gpt_design(nlay, ngpt, dev, args[2] is not None) if name == "sw_2stream_gpt"
                  else rte_kernels.lw_noscat_gpt_design(nlay, ngpt, dev))
        gb = call_scratch(lambda: getattr(rte_kernels, name)(*args)) / 1e9
        split = int(design["n_groups"] > 1)
        regs = kernel_registers(f"{variant}ELb{split}" if name == "sw_2stream_gpt" else f"{variant}{split}")
        phase("kernels", f"{label} {name} design: {what.format(design['kept'], nlay)} in shared memory "
                         f"({design['smem']} B a block), {design['n_groups']} block(s) of {design['group']} threads "
                         f"per column (maxThreadsPerBlock {design['max_threads']}); device scratch of one call "
                         f"{gb:.3f} GB (measured); ptxas: {regs}")


def print_aerosol_design(label, lkp) -> None:
    """The design aerosol_bands runs (csrc/aerosol_bands.cu: the tables
    staged in each block's shared memory as odd-stride records, blocks
    looping over rows): staged bytes (the wrapper's count and the library's),
    blocks an SM and the grid, registers."""
    import torch

    from rrtmgp_tpu_torch.ops import _build
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    design = ab.aerosol_bands_design(lkp, torch.device(DEVICE))
    shape = (lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0])
    library = _build.library().rrtmgp_aerosol_bands_smem(*shape)
    require(library == design["staged"], f"aerosol_bands: staged {design['staged']} B, the library's {library}")
    phase("kernels", f"{label} aerosol_bands design: tables staged in shared memory ({shape[0]} bands, "
                     f"{shape[1]} size bins, {shape[2]} RH levels: {design['staged']} B, records "
                     f"{ab.record_stride(shape[0])} words apart), {design['blocks_per_sm']} block(s) of "
                     f"{design['threads']} threads an SM x {design['sms']} SMs looping over (layer, column) rows; "
                     f"ptxas, all species: {kernel_registers('aerosol_bands_kernelILb1E')}; a subset: "
                     f"{kernel_registers('aerosol_bands_kernelILb0E')}")


def check_case(label, name, kern, ref, reps, results, cover=False, work=None) -> None:
    """One kernel call against its twin on the same inputs (tuples of
    tensors). With ``cover`` the last output is the McICA cloud cover, which
    must agree bit for bit; mcica_mask_export must agree bit for bit
    throughout. Keeps the largest error of a name and, with reps, the times
    and the bound of ``work``; prints the launch plan of every kernel of one
    thread per g-point that the call made (blocks per column, threads a
    block, the kernel's maxThreadsPerBlock)."""
    import torch

    from rrtmgp_tpu_torch.ops._launch import LAST_PLANS

    LAST_PLANS.clear()
    out = kern()
    torch.cuda.synchronize()
    plans = "".join(f", {k} plan {p.n_groups} x {p.group} threads (maxThreadsPerBlock {most})"
                    for k, (p, most) in LAST_PLANS.items())
    want = ref()
    if cover:
        require(torch.equal(out[-1], want[-1]), f"{label} {name}: McICA cloud cover differs from the twin's")
    if work is not None:
        results.setdefault(name, {})["bound_ms"], results[name]["bound_by"] = bound_ms(work, out)
    if cover:
        out, want = out[:-1], want[:-1]
    if TOL[name] == 0.0:
        require(all(torch.equal(a, b) for a, b in zip(out, want)), f"{label} {name}: differs from the twin")
    err, rel = rel_err(out, want)
    del out, want
    res = results.setdefault(name, {})
    res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
    res["rel"] = max(res.get("rel", 0.0), rel)
    timing = ""
    if reps:
        res["ms"] = timed(kern, reps)
        res["plain_ms"] = timed(ref, reps)
        timing = f", kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms"
        if work is not None:
            timing += f", bound {res['bound_ms']:.3f} ms by {res['bound_by']}"
    torch.cuda.empty_cache()
    phase("kernels", f"{label} {name}: max|d|={err:.3e} rel={rel:.3e} (tol {TOL[name]:.0e}){timing}{plans}")
    require(rel <= TOL[name], f"{label} {name}: rel error {rel:.3e} > {TOL[name]:.0e}")


def planck_sets_args(plk_args):
    """The three sets' arguments (t_lay, t_lev, t_sfc) as one sets call
    (planck_band_sets, planck_band_rows_sets) takes them, as the solves
    launch it."""
    return (tuple(a[0] for a in plk_args), *plk_args[0][1:])


def planck_work(plk_args, kind="f32") -> Work:
    """The three sets' temperatures and the table read once, OPS_PLANCK
    operations per band value."""
    n = sum(a[0].numel() for a in plk_args)
    return Work(nbytes([a[0] for a in plk_args]) + nbytes(plk_args[0][1]), OPS_PLANCK * n * plk_args[0][1].shape[1],
                kind)


# The library yardstick (library_ms) of the band Planck kernels: one
# torch.nn.functional.grid_sample call per set computes the same linear
# interpolation, the table as a (1, nbnd, 1, n_t) image sampled at x =
# ((t - t_min) / t_delta) 2 / (n_t - 1) - 1 (align_corners: x = -1 and 1 are
# the first and last nodes; border padding: the end values outside). The
# port never calls it.


def grid_sample_bands(t, totplnk, t_min, t_delta):
    """(nbnd, N) band Planck values by grid_sample, bands leading."""
    import torch
    import torch.nn.functional as F

    n_t, nbnd = totplnk.shape
    img = totplnk.T.contiguous().view(1, nbnd, 1, n_t)
    x = (t - t_min) / t_delta * (2.0 / (n_t - 1)) - 1.0
    grid = torch.stack((x, torch.zeros_like(x)), -1).view(1, 1, -1, 2)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True).view(nbnd, -1)


def grid_sample_rows(t, totplnk, t_min, t_delta):
    """(N, nbnd) band Planck values by one grid_sample call: the table as a
    (1, 1, nbnd, n_t) image, the grid (1, N, nbnd, 2) with y picking the
    band."""
    import torch
    import torch.nn.functional as F

    n_t, nbnd = totplnk.shape
    img = totplnk.T.contiguous().view(1, 1, nbnd, n_t)
    x = (t - t_min) / t_delta * (2.0 / (n_t - 1)) - 1.0
    y = torch.linspace(-1.0, 1.0, nbnd, dtype=t.dtype, device=t.device)
    grid = torch.stack(torch.broadcast_tensors(x[:, None], y[None, :]), -1).view(1, -1, nbnd, 2)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="border", align_corners=True).view(-1, nbnd)


def check_library(label, name, forms, ref, reps, results) -> None:
    """The library yardstick of ``name``: each form (label -> a call over
    the sets) against the twin within the kernel's tolerance and timed;
    ``library_ms`` is the fastest form that holds it."""
    want = ref()
    best = None
    for form, fn in forms.items():
        err, rel = rel_err(fn(), want)
        ms = timed(fn, reps)
        ok = rel <= TOL[name]
        phase("kernels", f"{label} {name} library yardstick, {form}: max|d|={err:.3e} rel={rel:.3e} "
                         f"(tol {TOL[name]:.0e}), {ms:.3f} ms" + ("" if ok else ", outside the tolerance"))
        if ok and (best is None or ms < best[1]):
            best = (form, ms)
    require(best is not None, f"{label} {name}: no library form holds the twin")
    results[name]["library_ms"] = best[1]
    phase("kernels", f"{label} {name} library_ms {best[1]:.3f} ({best[0]})")


def check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, reps, results) -> None:
    """The clear-sky f32 kernels against their twins (band Planck as the
    solves launch it: the three sets in one launch), and band Planck's
    library yardstick."""
    from rrtmgp_tpu_torch.ops import mega

    plk_args, lw_args, sw_args = kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    sets = planck_sets_args(plk_args)
    cases = {
        "planck_band": (lambda: mega.planck_band_sets(*sets),
                        lambda: tuple(mega.planck_band_ref(*a) for a in plk_args), planck_work(plk_args)),
        "lw_clear_mega": (lambda: mega.lw_clear_mega(*lw_args), lambda: mega.lw_clear_mega_ref(*lw_args),
                          Work(nbytes(lw_args), mega_ops("lw_clear_mega", *lw_args[:2]))),
        "sw_clear_mega": (lambda: mega.sw_clear_mega(*sw_args), lambda: mega.sw_clear_mega_ref(*sw_args),
                          Work(nbytes(sw_args), mega_ops("sw_clear_mega", *sw_args[:2]))),
    }
    for name, (kern, ref, work) in cases.items():
        check_case(label, name, kern, ref, reps, results, work=work)
    if reps:
        check_library(label, "planck_band", {"grid_sample a set": lambda: tuple(
            grid_sample_bands(*a) for a in plk_args)}, cases["planck_band"][1], reps, results)
    design = mega.lw_clear_mega_design(*lw_args[:2])
    print_gather_design(label, "lw_clear_mega", design,
                        f"lw_clear_mega_kernelIfLb0ELb0ELi0ELb{int(not design['in_block'])}")
    print_sw_mega_design(label, "sw_clear_mega", cases["sw_clear_mega"][0], sw_args, mega.CLEAR)


def check_f64_kernels(label, lw64, sw64, atm64, bcs64, f32_args, reps, results, chunk=None,
                      f32_tol=TOL["lw_clear_mega"]) -> None:
    """planck_band, lw_clear_mega and sw_clear_mega built for f64 against
    their f64 twins (the megakernels' twins on column chunks), and the f64
    megakernels against the f32 ones (``f32_args``: their LW and SW
    arguments) on the f32 rounding of the same inputs: LW within
    ``f32_tol`` of the largest flux, a difference that is the f32
    algorithm's own (its Clough factor cancels in thin layers), not the
    kernel's; SW within F32_SW_TOL (f32 rounding near the Meador-Weaver
    singularity)."""
    import torch

    from rrtmgp_tpu_torch.ops import mega

    ncol = atm64.ncol
    plk_args, lw_args, sw_args = kernel_args(lw64, sw64, atm64, *bcs64)
    lw_f32_args, sw_f32_args = f32_args
    sets = planck_sets_args(plk_args)
    plk_ref = lambda: tuple(mega.planck_band_ref(*a) for a in plk_args)
    check_case(label, "planck_band_f64", lambda: mega.planck_band_sets(*sets), plk_ref, reps, results,
               work=planck_work(plk_args, "f64"))
    if reps:
        check_library(label, "planck_band_f64", {"grid_sample a set": lambda: tuple(
            grid_sample_bands(*a) for a in plk_args)}, plk_ref, reps, results)
    check_case(label, "lw_clear_mega_f64", lambda: mega.lw_clear_mega(*lw_args),
               lambda: by_columns(mega.lw_clear_mega_ref, lw_args, ncol, chunk), reps, results,
               work=Work(nbytes(lw_args), mega_ops("lw_clear_mega", *lw_args[:2]), "f64"))
    design = mega.lw_clear_mega_design(*lw_args[:2])
    print_gather_design(label, "lw_clear_mega_f64", design,
                        f"lw_clear_mega_kernelIdLb0ELb0ELi0ELb{int(not design['in_block'])}")
    out64, out32 = mega.lw_clear_mega(*lw_args), mega.lw_clear_mega(*lw_f32_args)
    require(out64[0].dtype == torch.float64, "the f64 kernel returned another dtype")
    err, rel = rel_err(out32, out64)
    phase("kernels", f"{label} lw_clear_mega f32 vs f64 kernel: max|d|={err:.3e} rel={rel:.3e} "
                     f"(tol {f32_tol:.0e})")
    require(rel <= f32_tol, f"lw_clear_mega f32 vs f64: rel error {rel:.3e} > {f32_tol:.0e}")
    del out64, out32
    check_case(label, "sw_clear_mega_f64", lambda: mega.sw_clear_mega(*sw_args),
               lambda: by_columns(mega.sw_clear_mega_ref, sw_args, ncol, chunk), reps, results,
               work=Work(nbytes(sw_args), mega_ops("sw_clear_mega", *sw_args[:2]), "f64"))
    kern = lambda: mega.sw_clear_mega(*sw_args)
    print_sw_mega_design(label, "sw_clear_mega_f64", kern, sw_args, mega.CLEAR)
    out64, again = kern(), kern()
    require(all(a.dtype == torch.float64 and torch.equal(a, b) for a, b in zip(out64, again)),
            "the f64 SW kernel returned another dtype or other bits on a second call")
    err, rel = rel_err(mega.sw_clear_mega(*sw_f32_args), out64)
    phase("kernels", f"{label} sw_clear_mega f32 vs f64 kernel: max|d|={err:.3e} rel={rel:.3e} "
                     f"(tol {F32_SW_TOL:.0e})")
    require(rel <= F32_SW_TOL, f"sw_clear_mega f32 vs f64: rel error {rel:.3e} > {F32_SW_TOL:.0e}")


class ColOffset(NamedTuple):
    """A global column offset, moved along by ``cut``."""

    value: int


def cut(x, lo, hi, ncol):
    """Columns [lo, hi) of a kernel argument: a tensor is cut on its first
    axis of size ncol (band Planck values, (nbnd, nlev*ncol), on their
    level-column axis); MegaInputs, AerosolState, tuples and Compositions
    field by field, with the McICA column offset moved by lo; anything else
    (tables, lookups, numbers) is kept."""
    import torch

    from rrtmgp_tpu_torch.ops.mega import Composition
    from rrtmgp_tpu_torch.ops.mega_inputs import MegaInputs
    from rrtmgp_tpu_torch.states import AerosolState, tree_map_columns

    c = lambda v: cut(v, lo, hi, ncol)
    if isinstance(x, Composition):
        return x._replace(**{k: c(v) for k, v in x._asdict().items() if k != "col_offset"},
                          col_offset=x.col_offset + lo)
    if isinstance(x, ColOffset):
        return ColOffset(x.value + lo)
    if isinstance(x, tuple):
        return tuple(c(v) for v in x)
    if isinstance(x, (MegaInputs, AerosolState)):
        return tree_map_columns(c, c, x)
    if isinstance(x, torch.Tensor):
        for axis, n in enumerate(x.shape):
            if n == ncol:
                return x.narrow(axis, lo, hi - lo).contiguous()
        if x.dim() == 2 and x.shape[1] % ncol == 0:
            return x.view(x.shape[0], -1, ncol)[..., lo:hi].reshape(x.shape[0], -1).contiguous()
    return x


def by_columns(fn, args, ncol, chunk):
    """fn(*args) evaluated on column chunks of ``chunk`` and put back
    together on each output's column axis: the plain twins at the main
    path's width in bounded memory. Every quantity is per column and the
    McICA stream is keyed on the global column, so this equals fn(*args)."""
    import torch

    if chunk is None or chunk >= ncol:
        return fn(*args)
    parts = [fn(*(cut(a, lo, min(lo + chunk, ncol), ncol) for a in args)) for lo in range(0, ncol, chunk)]
    axes = [list(t.shape).index(chunk) for t in parts[0]]
    return tuple(torch.cat([p[i] for p in parts], dim=ax) for i, ax in enumerate(axes))


def check_allsky_kernels(label, L, atm, reps, results, chunk=None) -> None:
    """The all-sky kernels against their twins, the Compositions built as
    solve_lw / solve_sw build them; with ``chunk`` the twins run on column
    chunks. lw_clear_mega's composed variants are the all-sky ones of the LW
    no-scattering kernel. Timed (with reps) in the main path's mode, McICA
    seed + aerosols."""
    import torch

    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab
    from rrtmgp_tpu_torch.ops import cloud_bands as cb
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    lw, sw = L.lookup_lw, L.lookup_sw
    ncol = atm.ncol
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, ncol)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    mu0 = 0.05 + 0.95 * torch.rand(ncol, generator=gen, device=DEVICE)  # day columns
    bcs_sw = dataclasses.replace(bcs_sw, cos_zenith=mu0)
    cf = atm.cloud_state.cld_frac
    seed, off = MCICA_SEED, COL_OFFSET

    def comp(lkp, cld, aero, mode, delta):
        mask = build_cloud_mask_mcica(cf, lkp.n_gpt, seed, off) if mode == "mask" else None
        return _kernel_composition(lkp, atm, cld, aero, mask, seed if mode == "seed" else None, off,
                                   None, delta, False)[0]

    plk = plk_fn(lw)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lev), plk(atm.t_sfc),
               bcs_lw.sfc_emis, None)
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, mu0, toa_gpt,
               bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse, None)
    twin = lambda fn, *args: by_columns(fn, args, ncol, chunk)
    work = lambda name, args, c: Work(nbytes((args, c)), mega_ops(name, *args[:2], c))
    lw_cases = (("clear", mega.CLEAR), ("cloud mask", comp(lw, L.lookup_lw_cld, None, "mask", False)),
                ("seed+aerosols", comp(lw, L.lookup_lw_cld, L.lookup_lw_aero, "seed", False)))
    for i, (what, c) in enumerate(lw_cases):
        check_case(f"{label} [{what}]", "lw2_mega", lambda: mega.lw2_mega(*lw_args, c),
                   lambda: twin(mega.lw2_mega_ref, *lw_args, c), reps if i == 2 else 0, results, c.seeded,
                   work("lw2_mega", lw_args, c))
    print_design(f"{label} [seed+aerosols]", "lw2_mega", lambda: mega.lw2_mega(*lw_args, lw_cases[2][1]),
                 mega.lw2_mega_design(*lw_args[:2], lw_cases[2][1]))
    # LW no-scattering composed (absorption only), one angle as solve_lw passes it
    Ds, wts = angular_discretization(1)
    ns_args = (*lw_args[:2], plk(atm.t_lay), *lw_args[2:], float(Ds[0]), float(wts[0]))
    ns_cases = (("cloud mask", lw_cases[1][1]), ("aerosols", comp(lw, None, L.lookup_lw_aero, None, False)),
                ("seed+aerosols", lw_cases[2][1]))
    for i, (what, c) in enumerate(ns_cases):
        check_case(f"{label} [{what}]", "lw_clear_mega_allsky", lambda: mega.lw_clear_mega(*ns_args, c),
                   lambda: twin(mega.lw_clear_mega_ref, *ns_args, c), reps if i == 2 else 0, results, c.seeded,
                   work("lw_clear_mega", ns_args, c))
    design = mega.lw_clear_mega_design(*ns_args[:2], ns_cases[2][1])
    print_gather_design(f"{label} [seed+aerosols]", "lw_clear_mega_allsky", design,
                        f"lw_clear_mega_kernelIfLb1ELb1ELi2ELb{int(not design['in_block'])}")
    del ns_args, ns_cases, lw_cases
    sw_cases = (("cloud mask+aerosols", comp(sw, L.lookup_sw_cld, L.lookup_sw_aero, "mask", True)),
                ("seed+aerosols", comp(sw, L.lookup_sw_cld, L.lookup_sw_aero, "seed", True)))
    for i, (what, c) in enumerate(sw_cases):
        check_case(f"{label} [{what}]", "sw_clear_mega_allsky", lambda: mega.sw_clear_mega(*sw_args, c),
                   lambda: twin(mega.sw_clear_mega_ref, *sw_args, c), reps if i == 1 else 0, results,
                   c.seeded, work("sw_clear_mega", sw_args, c))
    print_sw_mega_design(f"{label} [seed+aerosols]", "sw_clear_mega_allsky",
                         lambda: mega.sw_clear_mega(*sw_args, sw_cases[1][1]), sw_args, sw_cases[1][1])
    for i, lkp in enumerate((L.lookup_sw_aero, L.lookup_lw_aero)):
        a = (lkp, atm.aerosol_state, atm.rel_hum)
        nbnd = lkp.dust.shape[-1]
        check_case(f"{label} [{nbnd} bands]", "aerosol_bands",
                   lambda: ab.aerosol_bands(*a), lambda: twin(ab.aerosol_bands_ref, *a), reps if i == 1 else 0,
                   results, work=Work(nbytes(a), OPS_AEROSOL * atm.nlay * ncol * nbnd))
        print_aerosol_design(f"{label} [{nbnd} bands]", lkp)
    cs = atm.cloud_state
    fields = nbytes([getattr(cs, k) for k in cb.FIELDS])
    for wave, lkp, delta in (("lw", L.lookup_lw_cld, False), ("sw", L.lookup_sw_cld, True)):
        a = (lkp, cs, delta)
        nbnd = lkp.liq.shape[-1]
        check_case(f"{label} [{nbnd} bands]", f"cloud_bands_{wave}", lambda: cb.cloud_bands(*a),
                   lambda: cb.cloud_bands_ref(*a), reps, results,
                   work=Work(fields + nbytes(lkp.liq) + nbytes(lkp.ice) // lkp.nrghice,
                             OPS_CLOUD * atm.nlay * ncol * nbnd))
    export_ref = lambda f, o: mega.mcica_mask_export_ref(f, seed, o.value, lw.n_gpt)
    check_case(f"{label} [ngpt {lw.n_gpt}]", "mcica_mask_export",
               lambda: mega.mcica_mask_export(cf, seed, off, lw.n_gpt),
               lambda: twin(export_ref, cf, ColOffset(off)), reps, results,
               work=Work(nbytes(cf), OPS_MCICA * atm.nlay * ncol * lw.n_gpt))


def phase_kernels_small(ngpt=36, ncol=SMALL_NCOL, nlay=SMALL_NLAY) -> None:
    """Every kernel against its twin at a small shape (4 bands)."""
    import numpy as np
    import torch

    from rrtmgp_tpu_torch.data.synthetic import synthetic_gas_lookup

    lw, sw = lookups(ngpt, 4, ngpt, 4)
    atm = atmosphere(ncol, nlay)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    mu0 = 0.05 + 0.95 * torch.rand(ncol, generator=gen, device=DEVICE)  # day columns
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, ncol, mu0)
    label = f"small ncol={ncol} nlay={nlay} ngpt={ngpt}"
    check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 0, {})
    lw64 = synthetic_gas_lookup(longwave=True, n_gpt=ngpt, n_bnd=4, dtype=np.float64, device=DEVICE)
    sw64 = sw.to(dtype=torch.float64)
    check_f64_kernels(label, lw64, sw64, atmosphere(ncol, nlay, "float64"),
                      boundary_conditions(lw64, sw64, ncol, mu0.double()),
                      kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[1:], 0, {}, f32_tol=1e-4)
    small_L, small_allsky = small_allsky_lookups(ngpt, (lw, sw)), allsky_atmosphere(ncol, nlay)
    check_allsky_kernels(label, small_L, small_allsky, 0, {})
    check_two_kernel_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 0, {})
    check_sw_sweep_allsky(label, small_L, small_allsky, {})
    check_sweep_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 0, {})
    check_lw2_sweep_allsky(label, small_L, small_allsky, {})
    check_unfused_kernels(label, lw, sw, atm, 0, {})


def phase_kernels_deep(L) -> None:
    """The all-sky kernels, lw2_mega and sw_clear_mega among them, at 800
    layers, where the megakernels' in-block level sums (SW 3 x 801 x 7 warps,
    LW 2 x 801 x 8 warps of floats) take more than 48 KB of shared memory, as
    the launch asks for."""
    check_allsky_kernels(f"deep ncol={DEEP_NCOL} nlay={DEEP_NLAY} ngpt=256/224", L,
                         allsky_atmosphere(DEEP_NCOL, DEEP_NLAY), 0, {})


def phase_clear_slice(lw, sw, atm, bcs_lw, bcs_sw):
    """The clear f32 slice; returns (launch counts, step ms, LW fluxes)."""
    import torch

    from rrtmgp_tpu_torch import solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.states import slice_columns

    def step():
        f_lw, _ = solve_lw(lw, atm, bcs_lw, impl="kernel")
        f_sw, _ = solve_sw(sw, atm, bcs_sw, impl="kernel")
        return f_lw, f_sw

    step()  # warm-up: library loaded, allocator primed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        f_lw, f_sw = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = mega.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phase("slice", f"launches in {STEPS} steps: {launches}")
    for name in ("planck_band", "lw_clear_mega", "sw_clear_mega"):
        require(launches[name] > 0, f"{name} was not launched on the clear-sky path")
    require(launches["planck_band"] == STEPS, f"band Planck: {launches['planck_band']} launches in {STEPS} "
                                              "steps, one a solve_lw expected")

    # physics oracles
    for f in (*f_lw, *f_sw):
        require(torch.isfinite(f).all(), "non-finite flux")
    require(f_lw.flux_up.shape == (NLAY + 1, NCOL) and f_sw.flux_dn_dir.shape == (NLAY + 1, NCOL),
            "flux shape")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), "LW flux_dn at TOA is not 0 (no incident flux)")
    require(torch.all(f_sw.flux_dn_dir[:-1] <= f_sw.flux_dn_dir[1:]),
            "SW direct beam increases toward the surface")
    require(torch.all(f_sw.flux_up[-1] <= 1361.0 * 0.6), "SW TOA up flux exceeds the incoming flux")
    phase("slice", "oracles: finite, LW TOA dn = 0, SW direct beam monotone, TOA up <= incoming")

    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    phase("slice", f"prologue (plain torch mega inputs): LW {timed(lambda: mega_lw_inputs(lw, atm), 3):.3f} ms, "
                   f"SW {timed(lambda: mega_sw_inputs(sw, atm), 3):.3f} ms")
    check_night(sw, atm, bcs_sw, {}, "slice")

    # kernel path vs torch path on the first columns
    a, bl, bs = (slice_columns(x, 0, CMP_NCOL, NCOL) for x in (atm, bcs_lw, bcs_sw))
    t_lw, _ = solve_lw(lw, a, bl, impl="torch")
    t_sw, _ = solve_sw(sw, a, bs, impl="torch")
    for name, kern, ref, tol in (
        ("solve_lw", f_lw, t_lw, TOL["lw_clear_mega"]), ("solve_sw", f_sw, t_sw, TOL["sw_clear_mega"]),
    ):
        err, rel = rel_err(tuple(k[:, :CMP_NCOL] for k in kern), tuple(ref))
        phase("slice", f"{name} kernel vs torch on {CMP_NCOL} columns: max|d|={err:.3e} rel={rel:.3e} "
                       f"(tol {tol:.0e})")
        require(rel <= tol, f"{name}: kernel vs torch rel error {rel:.3e} > {tol:.0e}")

    step_ms = 1e3 * statistics.median(times)
    phase("slice", f"LW+SW step: median {step_ms:.3f} ms over {STEPS} steps "
                   f"(min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), "
                   f"{NCOL / (step_ms / 1e3):.1f} columns/s, peak memory {peak_gb:.2f} GB")
    return launches, step_ms, f_lw


def check_night(sw, atm, bcs_sw, kw, tag, impl="kernel") -> None:
    """Night columns come out exactly 0 on the path of ``impl``."""
    import torch

    from rrtmgp_tpu_torch import solve_sw

    mu0 = bcs_sw.cos_zenith.clone()
    mu0[::5] = -0.3
    mu0[1::5] = 0.0
    f_night, _ = solve_sw(sw, atm, dataclasses.replace(bcs_sw, cos_zenith=mu0), impl=impl, **kw)
    night = mu0 <= 0
    for f in f_night:
        require(torch.all(f[:, night] == 0.0), "night column not exactly 0")
    phase(tag, f"night columns exactly 0 ({int(night.sum())} of {atm.ncol})")


def phase_allsky_slice(L, atm, bcs_lw, bcs_sw, two_stream_lw=True) -> dict:
    """RRTMGPSolver all-sky with aerosols at full size, LW two-stream
    (lw2_mega) or, with two_stream_lw=False, LW no-scattering (lw_clear_mega
    composed); returns the launch counts of its update_fluxes() steps,
    cloud_bands split into its LW and SW launches, and of the exported-mask
    path. The no-scattering run repeats the LW oracles and
    adds 3 angles; the SW-only ones (night columns, clear-sky diagnostics)
    belong to the two-stream run."""
    import torch

    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        AllSkyRadiationWithClearSkyDiagnostics,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
        solve_lw,
        solve_sw,
    )
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.ops.cloud_bands import cloud_bands
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica
    from rrtmgp_tpu_torch.states import slice_columns

    ncol = atm.ncol
    tag = "allsky" if two_stream_lw else "allsky-noscat"
    lw_kernel = "lw2_mega" if two_stream_lw else "lw_clear_mega"
    columns = lambda x, lo, hi: slice_columns(x, lo, hi, ncol)
    grid = RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=torch.float32)
    solver = RRTMGPSolver(grid, AllSkyRadiation(aerosol_radiation=True), RRTMGPParameters(),
                          bcs_lw, bcs_sw, atm, lookups=L, two_stream_lw=two_stream_lw)
    lw_clouds = []

    def step():
        # update_fluxes() is these two calls; apart, they count each wave's cloud_bands launches
        before = cloud_bands.launches
        solver.update_lw_fluxes()
        lw_clouds.append(cloud_bands.launches - before)
        solver.update_sw_fluxes()
        return solver.flux_lw, solver.flux_sw

    step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    lw_clouds.clear()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        solver.advance_step()
        f_lw, f_sw = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = mega.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * statistics.median(times)
    launches["cloud_bands_lw"] = sum(lw_clouds)
    launches["cloud_bands_sw"] = launches.pop("cloud_bands") - launches["cloud_bands_lw"]
    phase(tag, f"launches in {STEPS} update_fluxes() steps: {launches}")
    for name in ("planck_band", lw_kernel, "sw_clear_mega", "aerosol_bands", "cloud_bands_lw", "cloud_bands_sw"):
        require(launches[name] > 0, f"{name} was not launched on the {tag} path")
    # per step: one Planck launch, at t_lev and t_sfc for LW two-stream, at t_lay too for no-scattering;
    # the aerosol and cloud band optics once a wave
    want = {"planck_band": 1, lw_kernel: 1, "sw_clear_mega": 1, "aerosol_bands": 2, "cloud_bands_lw": 1,
            "cloud_bands_sw": 1}
    per_step = {k: n / STEPS for k, n in launches.items() if n}
    require(per_step == want, f"launches per step {per_step}, expected {want}")
    phase(tag, f"update_fluxes() at {ncol} x {NLAY}: median {step_ms:.3f} ms over {STEPS} steps "
                    f"(min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), "
                    f"{ncol / (step_ms / 1e3):.1f} columns/s, peak memory {peak_gb:.2f} GB")

    # physics oracles
    for f in (*f_lw, *f_sw):
        require(torch.isfinite(f).all(), "non-finite flux")
    require(f_lw.flux_up.shape == (NLAY + 1, ncol), "flux shape")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), "LW flux_dn at TOA is not 0 (no incident flux)")
    require(torch.all(f_sw.flux_dn_dir[:-1] <= f_sw.flux_dn_dir[1:]),
            "SW direct beam increases toward the surface")
    require(torch.all(f_sw.flux_up[-1] <= 1361.0 * 0.6), "SW TOA up flux exceeds the incoming flux")
    clear = torch.arange(ncol, device=DEVICE) % 3 == 2
    for name in ("lw_cloud_cover", "sw_cloud_cover"):
        cov = getattr(solver, name)()
        require(cov.shape == (ncol,) and torch.all((cov >= 0) & (cov <= 1)), f"{name} outside [0, 1]")
        require(torch.all(cov[clear] == 0) and torch.all(cov[~clear] > 0),
                f"{name}: not 0 in the cloud-free columns and > 0 in the others")
    ext, sca = solver.aod_sw_extinction(), solver.aod_sw_scattering()
    require(torch.all(sca >= 0) and torch.all(ext >= sca), "AOD: not ext >= sca >= 0")
    phase(tag, "oracles: finite, LW TOA dn = 0, SW direct beam monotone, TOA up <= incoming, "
                    f"cloud cover in [0, 1], 0 in the {int(clear.sum())} cloud-free columns and > 0 "
                    f"elsewhere, AOD ext >= sca >= 0 (mean ext {ext.mean().item():.3e})")
    if two_stream_lw:
        check_night(L.lookup_sw, atm, bcs_sw, dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero,
                                                    cld_mask_seed=MCICA_SEED), tag)

    # the same step twice gives bitwise-equal fluxes; a new step new masks
    snap = lambda: [t.clone() for t in (*solver.flux_lw, *solver.flux_sw)]
    solver.advance_step(step=7)
    solver.update_fluxes()
    first = snap()
    solver.update_fluxes()
    require(all(torch.equal(a, b) for a, b in zip(first, snap())), "step 7 twice: fluxes differ")
    solver.advance_step()
    solver.update_fluxes()
    require(not torch.equal(first[0], solver.flux_lw.flux_up), "a new step drew the same masks")
    phase(tag, "same step twice: bitwise-equal fluxes; the next step: new masks")

    lw, sw = L.lookup_lw, L.lookup_sw
    lw_kw = dict(two_stream=two_stream_lw, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero)
    sw_kw = dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero)
    seed = solver._mcica_key(0)

    # column-split invariance: halves with col_offset equal the whole
    half = ncol // 2
    whole = (solve_lw(lw, atm, bcs_lw, cld_mask_seed=seed, **lw_kw)[0],
             solve_sw(sw, atm, bcs_sw, cld_mask_seed=seed + 1, **sw_kw)[0])
    for lo, hi in ((0, half), (half, ncol)):
        a, bl, bs = columns(atm, lo, hi), columns(bcs_lw, lo, hi), columns(bcs_sw, lo, hi)
        part = (solve_lw(lw, a, bl, cld_mask_seed=seed, col_offset=lo, **lw_kw)[0],
                solve_sw(sw, a, bs, cld_mask_seed=seed + 1, col_offset=lo, **sw_kw)[0])
        for fw, fp in zip(whole, part):
            require(all(torch.equal(w[:, lo:hi], p) for w, p in zip(fw, fp)),
                    f"columns [{lo}, {hi}) with col_offset differ from the whole")
    del whole
    phase(tag, f"column split at {half}: halves with col_offset equal the whole bitwise")

    # seed mode against the exported-mask mode; the exported-mask path is
    # the one that launches mcica_mask_export
    a, bl, bs = columns(atm, 0, CMP_NCOL), columns(bcs_lw, 0, CMP_NCOL), columns(bcs_sw, 0, CMP_NCOL)
    cf = a.cloud_state.cld_frac
    mega.reset_launch_counts()
    exported = []
    for lkp, s in ((lw, seed), (sw, seed + 1)):
        exported.append(mega.mcica_mask_export(cf, s, 0, lkp.n_gpt)[1].bool())
    k_lw_mask, d_lw_mask = solve_lw(lw, a, bl, cld_mask=exported[0], **lw_kw)
    k_sw_mask, d_sw_mask = solve_sw(sw, a, bs, cld_mask=exported[1], **sw_kw)
    export_launches = mega.launch_counts()
    phase(tag, f"exported-mask path launches: {export_launches}")
    require(export_launches["mcica_mask_export"] > 0, "mcica_mask_export was not launched")
    k_lw, d_lw = solve_lw(lw, a, bl, cld_mask_seed=seed, **lw_kw)
    k_sw, d_sw = solve_sw(sw, a, bs, cld_mask_seed=seed + 1, **sw_kw)
    for name, x, y in (("LW", (*k_lw, d_lw.cld_cover), (*k_lw_mask, d_lw_mask.cld_cover)),
                       ("SW", (*k_sw, d_sw.cld_cover), (*k_sw_mask, d_sw_mask.cld_cover))):
        require(all(torch.equal(p, q) for p, q in zip(x, y)), f"{name}: seed mode != exported-mask mode")
    phase(tag, f"seed mode equals the exported-mask mode bitwise (LW and SW, {CMP_NCOL} columns)")

    # kernel path against the torch path
    for lkp, s, mask in ((lw, seed, exported[0]), (sw, seed + 1, exported[1])):
        require(torch.equal(build_cloud_mask_mcica(cf, lkp.n_gpt, s, 0), mask),
                "McICA mask of the kernel differs from the torch twin's")
    t_lw, td_lw = solve_lw(lw, a, bl, cld_mask_seed=seed, impl="torch", **lw_kw)
    t_sw, td_sw = solve_sw(sw, a, bs, cld_mask_seed=seed + 1, impl="torch", **sw_kw)
    for name, kern, ref, tol in (("solve_lw", k_lw, t_lw, TOL["lw2_mega" if two_stream_lw else "lw_clear_mega_allsky"]),
                                 ("solve_sw", k_sw, t_sw, TOL["sw_clear_mega_allsky"])):
        err, rel = rel_err(tuple(kern), tuple(ref))
        phase(tag, f"{name} kernel vs torch on {CMP_NCOL} columns: max|d|={err:.3e} rel={rel:.3e} "
                        f"(tol {tol:.0e})")
        require(rel <= tol, f"{name}: kernel vs torch rel error {rel:.3e} > {tol:.0e}")
    require(torch.equal(d_lw.cld_cover, td_lw.cld_cover) and torch.equal(d_sw.cld_cover, td_sw.cld_cover),
            "cloud cover: kernel path differs from the torch path")
    _, rel = rel_err((d_sw.aod_sw_ext, d_sw.aod_sw_sca), (td_sw.aod_sw_ext, td_sw.aod_sw_sca))
    require(rel <= 1e-6, f"AOD: kernel path vs torch path rel error {rel:.3e} > 1e-6")
    phase(tag, f"masks bitwise, cloud cover bitwise, AOD rel {rel:.3e} against the torch path")
    del solver, first, exported
    if not two_stream_lw:
        # 3 quadrature angles: one launch each, the mask drawn alike in all
        a, bl = columns(atm, 0, ANGLES_NCOL), columns(bcs_lw, 0, ANGLES_NCOL)
        mega.reset_launch_counts()
        k3, d3 = solve_lw(lw, a, bl, cld_mask_seed=seed, n_gauss_angles=3, impl="kernel", **lw_kw)
        n3 = mega.launch_counts()
        require(n3["lw_clear_mega"] == 3 and n3["planck_band"] == 1 and n3["lw2_mega"] == 0,
                f"3 angles: launches {n3}")
        t3, td3 = solve_lw(lw, a, bl, cld_mask_seed=seed, n_gauss_angles=3, impl="torch", **lw_kw)
        err, rel = rel_err(tuple(k3), tuple(t3))
        phase(tag, f"3 angles on {ANGLES_NCOL} columns, kernel (3 launches) vs torch: max|d|={err:.3e} "
                   f"rel={rel:.3e} (tol {TOL['lw_clear_mega_allsky']:.0e}), cover bitwise")
        require(rel <= TOL["lw_clear_mega_allsky"], f"3 angles: rel error {rel:.3e}")
        require(torch.equal(d3.cld_cover, td3.cld_cover), "3 angles: cloud cover differs from the torch path")
        return {**launches, "mcica_mask_export": export_launches["mcica_mask_export"]}

    # the clear-sky diagnostics once
    diag = RRTMGPSolver(grid, AllSkyRadiationWithClearSkyDiagnostics(aerosol_radiation=True),
                        RRTMGPParameters(), bcs_lw, bcs_sw, atm, lookups=L)
    diag.update_fluxes()
    cloudy = ~clear
    for name in ("lw_flux_up", "sw_flux_up", "lw_flux_dn", "sw_flux_dn"):
        allsky, clr = getattr(diag, name)(), getattr(diag, "clear_" + name)()
        require(torch.isfinite(clr).all(), f"clear_{name} not finite")
        require(bool((allsky != clr)[:, cloudy].any(dim=0).all()),
                f"clear_{name} equals {name} in a cloudy column")
    diff = (diag.lw_flux_up() - diag.clear_lw_flux_up())[:, clear].abs().max().item()
    phase(tag, "AllSkyRadiationWithClearSkyDiagnostics: clear getters differ from all-sky in every "
                    f"cloudy column (cloud-free columns: max |LW up diff| {diff:.3e})")
    return {**launches, "mcica_mask_export": export_launches["mcica_mask_export"]}


def phase_f64_slice(lw, sw, atm, bcs_lw, bcs_sw, f32_lw) -> dict:
    """RRTMGPSolver in f64, clear sky, LW no-scattering, at full size: LW
    and SW through the f64 kernels, one launch a column chunk. ``f32_lw``
    is the f32 clear slice's LW flux on the f32 rounding of the same
    inputs. Returns the launch counts of the timed steps."""
    import warnings

    import torch

    from rrtmgp_tpu_torch import (
        ClearSkyRadiation,
        LookupBundle,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
        lookup_tables,
        solve_lw,
        solve_sw,
    )
    from rrtmgp_tpu_torch.models.rrtmgp import solve_chunked
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.states import slice_columns

    ncol, f64 = atm.ncol, torch.float64
    bundle = LookupBundle(lookup_lw=lw, lookup_sw=sw)

    def make(atm_, bl, bs, method=ClearSkyRadiation(False), lookups=bundle, **kw):
        """An f64 solver and the warnings of its construction."""
        grid = RRTMGPGridParams(nlay=NLAY, ncol=atm_.ncol, dtype=f64)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            solver = RRTMGPSolver(grid, method, RRTMGPParameters(), bl, bs, atm_, lookups=lookups,
                                  two_stream_lw=False, **kw)
        return solver, [str(w.message) for w in caught]

    solver, notes = make(atm, bcs_lw, bcs_sw)
    require(solver.auto_chunk is not None and any("auto-chunking" in n for n in notes),
            f"no auto-chunk at {ncol} columns in f64: {notes}")
    phase("f64", f"auto-chunk {solver.auto_chunk} columns: {notes[0]}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver.update_fluxes()  # warm-up
    require(not any("exact-precision torch path" in str(w.message) for w in caught),
            "a clear-sky f64 solve warned that it takes the torch path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    times = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(3):
            t0 = time.perf_counter()
            f_lw, f_sw = solver.update_fluxes()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = mega.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t_lw = timed(solver.update_lw_fluxes, 3)
    n_chunks = -(-ncol // solver.auto_chunk)
    phase("f64", f"launches in 3 update_fluxes() steps: {launches}")
    require(launches["lw_clear_mega"] == 3 * n_chunks and launches["planck_band"] == 3 * n_chunks,
            f"LW did not go through the f64 kernels once per chunk: {launches}")
    require(launches["sw_clear_mega"] == 3 * n_chunks, f"SW did not go through the f64 kernel once per chunk: "
                                                       f"{launches}")
    require(launches["lw2_mega"] == 0, "an f32-only kernel was launched")
    step_ms = 1e3 * statistics.median(times)
    phase("f64", f"update_fluxes() at {ncol} x {NLAY} f64: median {step_ms:.3f} ms over 3 steps "
                 f"(min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), "
                 f"{ncol / (step_ms / 1e3):.1f} columns/s, LW alone {t_lw:.3f} ms, "
                 f"peak memory {peak_gb:.2f} GB, {n_chunks} chunks of {solver.auto_chunk}")
    for f in (*f_lw, *f_sw):
        require(f.dtype == f64 and f.shape == (NLAY + 1, ncol) and torch.isfinite(f).all(), "f64 flux")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), "LW flux_dn at TOA is not 0 (no incident flux)")

    # LW against the exact f64 torch path, and against the f32 slice
    a, bl, bs = (slice_columns(x, 0, CMP_NCOL, ncol) for x in (atm, bcs_lw, bcs_sw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        e_lw, _ = solve_lw(lw, a, bl, impl="torch")
        err = max((k[:, :CMP_NCOL] - e).abs().max().item() for k, e in zip(f_lw, e_lw))
        phase("f64", f"LW kernel path vs exact f64 torch path on {CMP_NCOL} columns: max|d|={err:.3e} W/m2 "
                     f"(tol {F64_LW_TOL_WM2:.0e})")
        require(err <= F64_LW_TOL_WM2, f"f64 LW: {err:.3e} W/m2 from the exact torch path")
        err, rel = rel_err(tuple(f32_lw), tuple(f_lw))
        phase("f64", f"LW f32 slice vs f64 slice: max|d|={err:.3e} rel={rel:.3e} (tol {TOL['lw_clear_mega']:.0e})")
        require(rel <= TOL["lw_clear_mega"], f"f32 vs f64 LW: rel error {rel:.3e}")

        # SW: the f64 kernel chunked equals unchunked, bit for bit, and the
        # exact torch path to rounding
        mega.reset_launch_counts()
        whole, _ = solve_sw(sw, a, bs)
        require(mega.launch_counts()["sw_clear_mega"] == 1, "f64 clear SW did not launch its kernel")
        chunk = solver.auto_chunk
        parts, _ = solve_chunked(lambda x, y: solve_sw(sw, x, y), a, bs, chunk)
        require(all(torch.equal(p, w) for p, w in zip(parts, whole)), "SW chunked != unchunked")
        require(all(torch.equal(f[:, :CMP_NCOL], w) for f, w in zip(f_sw, whole)),
                "SW of the solver != the unchunked f64 kernel route")
        exact, _ = solve_sw(sw, a, bs, impl="torch")
        err, rel = rel_err(tuple(whole), tuple(exact))
        phase("f64", f"SW chunked ({chunk}) equals unchunked bitwise on {CMP_NCOL} columns, and the solver's "
                     f"SW equals both; vs exact f64 torch path: max|d|={err:.3e} W/m2 rel={rel:.3e} "
                     f"(tol {TOL['sw_clear_mega_f64']:.0e})")
        require(rel <= TOL["sw_clear_mega_f64"], f"f64 SW: rel error {rel:.3e} from the exact torch path")
        del whole, parts, exact

        # 3 angles through the solver
        s3, _ = make(a, bl, bs, n_gauss_angles=3)
        mega.reset_launch_counts()
        k3 = s3.update_lw_fluxes()
        n3 = mega.launch_counts()["lw_clear_mega"]
        require(n3 == 3 * -(-CMP_NCOL // s3.auto_chunk), f"3 angles: {n3} launches")
        e3, _ = solve_lw(lw, a, bl, n_gauss_angles=3, impl="torch")
        err = max((k - e).abs().max().item() for k, e in zip(k3, e3))
        phase("f64", f"3 angles ({n3} launches) vs exact f64 torch path: max|d|={err:.3e} W/m2")
        require(err <= F64_LW_TOL_WM2, f"f64 LW, 3 angles: {err:.3e} W/m2 from the exact torch path")
        del s3, k3, e3, a, bl, bs

        # clear sky with aerosols: no f64 kernel, the aerosols are kept
        n = CMP_NCOL // 2
        aero_atm = atmosphere(n, NLAY, "float64", with_aerosols=True)
        La = lookup_tables(ClearSkyRadiation(True), dtype=f64, device=DEVICE)
        bl, bs = boundary_conditions(La.lookup_lw, La.lookup_sw, n)
        with_aero, _ = make(aero_atm, bl, bs, ClearSkyRadiation(True), La)
        without, _ = make(aero_atm, bl, bs, ClearSkyRadiation(False), La)
        mega.reset_launch_counts()
        fa = with_aero.update_lw_fluxes()
        require(mega.launch_counts()["lw_clear_mega"] == 0, "f64 LW with aerosols launched the aerosol-free kernel")
        fn = without.update_lw_fluxes()
        require(mega.launch_counts()["lw_clear_mega"] > 0, "f64 clear LW did not launch its kernel")
        diff = (fa.flux_up - fn.flux_up).abs().max().item()
        phase("f64", f"ClearSkyRadiation(aerosol_radiation=True) in f64: torch path, LW up differs from the "
                     f"aerosol-free kernel solve by up to {diff:.3e} W/m2")
        require(diff > 1e-6, "the f64 aerosol solve dropped its aerosols")
    return launches


def two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw):
    """The arguments of the four kernels of the two-kernel path as solve_lw /
    solve_sw build them on clear sky: the sweeps read what the optics kernels
    wrote. Returns (optics LW, optics SW, Planck rows x 3, LW sweep, SW
    sweep)."""
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops import interp
    from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw_raw
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    Ds, wts = angular_discretization(1)
    lw_in = (mega_lw_inputs(lw, atm), lw.kernel_tables)
    sw_in = (mega_sw_inputs(sw, atm), sw.kernel_tables)
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    raw = gas_optics_lw_raw(lw, atm)
    k12 = (*raw, bcs_lw.sfc_emis, lw.kernel_tables.gpt2band, float(Ds[0]), float(wts[0]), None)
    tau, ssa = interp.optics_fused(*sw_in)
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    k15 = (tau, ssa, None, bcs_sw.cos_zenith, toa_gpt, bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse,
           sw.kernel_tables.gpt2band, None)
    return lw_in, sw_in, plk_args, k12, k15


def angles_args(head, inc, n: int):
    """The arguments of a multi-angle LW sweep (lw_noscat_banded_angles,
    lw_noscat_reduced_angles) as solve_lw builds them for n quadrature
    angles: the one-angle wrapper's arguments ``head`` that precede the
    angle, the secants and weights as lists, the incident flux ``inc``."""
    from rrtmgp_tpu_torch.angular import angular_discretization

    Ds, wts = angular_discretization(n)
    return (*head, [float(d) for d in Ds], [float(w) for w in wts], inc)


def print_angles_design(label, name, nang, nlay, ngpt) -> None:
    """The design of a multi-angle LW sweep (csrc/lw_noscat_banded.cu,
    the summed sweep of csrc/lw_noscat_sources.cu): angles per launch, the
    launch plan for their 2 x nang level sums, registers."""
    import torch

    from rrtmgp_tpu_torch.ops import rte_kernels

    kernel = {"lw_noscat_banded_reduced": "lw_noscat_banded", "lw_noscat_reduced": "lw_noscat_reduced"}[name]
    (group, n_groups, in_block), _ = rte_kernels.angles_plan(kernel, nang, nlay, 1, ngpt, torch.device(DEVICE))
    sums = "in the block" if in_block else "warp partials in device memory"
    phase("kernels", f"{label} {name} design: {nang} angle(s) per launch (one radiance per angle in "
                     f"registers, 2 x {nang} level sums, a level's angles reduced over the warp together), "
                     f"{n_groups} block(s) of {group} threads per column, level sums {sums}; ptxas: "
                     f"{kernel_registers(f'{kernel}_kernelIfLi{nang}ELb{int(not in_block)}')}")


def check_two_kernel_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, reps, results, chunk=None) -> None:
    """The kernels of the two-kernel path against their twins, the twins on
    column chunks when ``chunk`` is given."""
    from rrtmgp_tpu_torch.ops import interp, rte_kernels

    ncol = atm.ncol
    lw_in, sw_in, plk_args, k12, k15 = two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    twin = lambda fn, args: by_columns(fn, args, ncol, chunk)
    points = lambda lkp: atm.nlay * ncol * lkp.n_gpt
    sets = planck_sets_args(plk_args)
    plk_ref = lambda: tuple(interp.planck_band_rows_ref(*a) for a in plk_args)
    cases = (
        ("optics_fused_lw", lambda: interp.optics_fused(*lw_in), lambda: twin(interp.optics_fused_ref, lw_in),
         Work(nbytes(lw_in), mega_ops("optics_fused_lw", *lw_in))),
        ("optics_fused_sw", lambda: interp.optics_fused(*sw_in), lambda: twin(interp.optics_fused_ref, sw_in),
         Work(nbytes(sw_in), mega_ops("optics_fused_sw", *sw_in))),
        ("planck_band_rows", lambda: interp.planck_band_rows_sets(*sets), plk_ref, planck_work(plk_args)),
        ("lw_noscat_banded_reduced", lambda: rte_kernels.lw_noscat_banded_reduced(*k12),
         lambda: twin(rte_kernels.lw_noscat_banded_reduced_ref, k12),
         Work(nbytes(k12), OPS_LW_SWEEP * points(lw))),
        ("sw_2stream_reduced", lambda: rte_kernels.sw_2stream_reduced(*k15),
         lambda: twin(rte_kernels.sw_2stream_reduced_ref, k15),
         Work(nbytes(k15), OPS_SW_SWEEP * points(sw))),
    )
    for name, kern, ref, work in cases:
        check_case(label, name, kern, ref, reps, results, work=work)
    if reps:
        check_library(label, "planck_band_rows", {
            "grid_sample a set, one call": lambda: tuple(grid_sample_rows(*a) for a in plk_args),
            "grid_sample a set, bands leading, then .T.contiguous()": lambda: tuple(
                grid_sample_bands(*a).T.contiguous() for a in plk_args)}, plk_ref, reps, results)
    # K12 as the solves launch it: solve_lw's 3 angles in one launch (the
    # kernels line keeps this call's time), the same bytes as one angle and
    # 3 x the operations
    k12_3 = angles_args(k12[:7], k12[9], 3)
    check_case(f"{label} [3 angles, one launch]", "lw_noscat_banded_reduced",
               lambda: rte_kernels.lw_noscat_banded_angles(*k12_3),
               lambda: twin(rte_kernels.lw_noscat_banded_angles_ref, k12_3), reps, results,
               work=Work(nbytes(k12_3), 3 * OPS_LW_SWEEP * points(lw)))
    for nang in (1, 3):
        print_angles_design(label, "lw_noscat_banded_reduced", nang, atm.nlay, lw.n_gpt)
    for name, (inp, tabs) in (("optics_fused_lw", lw_in), ("optics_fused_sw", sw_in)):
        print_gather_design(label, name, interp.optics_fused_design(tabs),
                            f"optics_fused_kernelIfLb{int(name.endswith('sw'))}")
    print_sw_sweep_design(label, lambda: rte_kernels.sw_2stream_reduced(*k15), *k15[0].shape)


def check_sw_sweep_allsky(label, L, atm, results) -> None:
    """sw_2stream_reduced and sw_2stream_gpt with an asymmetry: the optics
    kernel's output composed with clouds (McICA by seed) and aerosols,
    delta-scaled, at g-point resolution."""
    import torch

    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import interp, mega, rte_kernels
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_sw_inputs

    sw, ncol = L.lookup_sw, atm.ncol
    _, bcs_sw = boundary_conditions(L.lookup_lw, sw, ncol)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    mu0 = 0.05 + 0.95 * torch.rand(ncol, generator=gen, device=DEVICE)
    tau, ssa = interp.optics_fused(mega_sw_inputs(sw, atm), sw.kernel_tables)
    comp = _kernel_composition(sw, atm, L.lookup_sw_cld, L.lookup_sw_aero, None, MCICA_SEED, COL_OFFSET,
                               None, True, False)[0]
    tau, ssa, g, _ = mega._compose_ref(comp, sw, tau, ssa, torch.zeros_like(tau))
    require(float(g.max()) > 0.1, "the all-sky composition has no asymmetry")
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    args = (tau.contiguous(), ssa.contiguous(), g.contiguous(), mu0, toa_gpt, bcs_sw.sfc_alb_direct,
            bcs_sw.sfc_alb_diffuse, sw.kernel_tables.gpt2band, None)
    check_case(f"{label} [with g, clouds+aerosols]", "sw_2stream_reduced",
               lambda: rte_kernels.sw_2stream_reduced(*args),
               lambda: rte_kernels.sw_2stream_reduced_ref(*args), 0, results)
    gpt_args = per_gpt_sw_args(args)
    check_case(f"{label} [with g, clouds+aerosols]", "sw_2stream_gpt",
               lambda: rte_kernels.sw_2stream_gpt(*gpt_args),
               lambda: rte_kernels.sw_2stream_gpt_ref(*gpt_args), 0, results)


def phase_two_kernel_slice(lw, sw, atm, bcs_lw, bcs_sw, mega_lw, L) -> dict:
    """The two-kernel slice at full width on the clear cell's inputs:
    solve_lw with 3 angles and solve_sw through impl="two_kernel", then the
    SW direct-beam solve with the default impl. ``mega_lw`` is the clear
    slice's one-angle LW flux through the megakernel, ``L`` the all-sky
    lookups of the all-sky comparison. Returns the launch counts of the
    timed steps, optics_fused split into its LW and SW launches."""
    import torch

    from rrtmgp_tpu_torch import solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import interp, mega
    from rrtmgp_tpu_torch.states import slice_columns

    tag, ncol = "two-kernel", atm.ncol
    lw_optics = []

    def step():
        before = interp.optics_fused.launches
        f_lw, _ = solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="two_kernel")
        lw_optics.append(interp.optics_fused.launches - before)
        f_sw, _ = solve_sw(sw, atm, bcs_sw, impl="two_kernel")
        f_dir, _ = solve_sw(sw, atm, bcs_sw, two_stream=False)  # default impl
        return f_lw, f_sw, f_dir

    step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    lw_optics.clear()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        f_lw, f_sw, f_dir = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = mega.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["optics_fused_lw"] = sum(lw_optics)
    launches["optics_fused_sw"] = launches.pop("optics_fused") - launches["optics_fused_lw"]
    per_step = {k: n / STEPS for k, n in launches.items() if n}
    want = {"optics_fused_lw": 1, "optics_fused_sw": 2, "planck_band_rows": 1,
            "lw_noscat_banded_reduced": 1, "sw_2stream_reduced": 1}
    phase(tag, f"launches in {STEPS} steps: {launches}")
    require(per_step == want, f"launches per step {per_step}, expected {want}")
    step_ms = 1e3 * statistics.median(times)
    phase(tag, f"LW 3 angles + SW two-stream + SW direct beam at {ncol} x {NLAY}: median {step_ms:.3f} ms over "
               f"{STEPS} steps (min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), "
               f"{ncol / (step_ms / 1e3):.1f} columns/s, peak memory {peak_gb:.2f} GB")

    # physics oracles
    for f in (*f_lw, *f_sw, *f_dir):
        require(f.shape == (NLAY + 1, ncol) and torch.isfinite(f).all(), "flux shape or non-finite flux")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), "LW flux_dn at TOA is not 0 (no incident flux)")
    for f in (f_sw, f_dir):
        require(torch.all(f.flux_dn_dir[:-1] <= f.flux_dn_dir[1:]), "SW direct beam increases toward the surface")
    require(torch.all(f_dir.flux_up == 0.0) and torch.all(f_dir.flux_dn == 0.0),
            "the direct-beam solve has a diffuse flux")
    require(rel_err((f_dir.flux_dn_dir,), (f_sw.flux_dn_dir,))[1] <= TOL["sw_2stream_reduced"],
            "the direct-beam solve's beam differs from the two-stream solve's")
    require(torch.all(f_sw.flux_up[-1] <= 1361.0 * 0.6), "SW TOA up flux exceeds the incoming flux")
    phase(tag, "oracles: finite, LW TOA dn = 0, direct beam monotone and equal in both SW solves, "
               "flux_up = flux_dn = 0 in the direct-beam solve, TOA up <= incoming")
    check_night(sw, atm, bcs_sw, {}, tag, impl="two_kernel")
    check_night(sw, atm, bcs_sw, dict(two_stream=False), tag, impl=None)

    # the two-kernel path against the megakernel path at full width
    one_lw, _ = solve_lw(lw, atm, bcs_lw, impl="two_kernel")
    k3_lw, _ = solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="kernel")
    k_sw, _ = solve_sw(sw, atm, bcs_sw, impl="kernel")
    for name, out, ref, tol in (
        ("solve_lw 1 angle", one_lw, mega_lw, TOL["lw_noscat_banded_reduced"]),
        ("solve_lw 3 angles", f_lw, k3_lw, TOL["lw_noscat_banded_reduced"]),
        ("solve_sw", f_sw, k_sw, TOL["sw_2stream_reduced"]),
    ):
        err, rel = rel_err(tuple(out), tuple(ref))
        phase(tag, f"{name} two-kernel vs megakernel path on {ncol} columns: max|d|={err:.3e} rel={rel:.3e} "
                   f"(tol {tol:.0e}), bitwise equal: {all(torch.equal(a, b) for a, b in zip(out, ref))}")
        require(rel <= tol, f"{name}: two-kernel vs megakernel rel error {rel:.3e} > {tol:.0e}")
    del one_lw, k3_lw, k_sw

    # against the torch path on the first columns
    a, bl, bs = (slice_columns(x, 0, CMP_NCOL, ncol) for x in (atm, bcs_lw, bcs_sw))
    t_lw, _ = solve_lw(lw, a, bl, n_gauss_angles=3, impl="torch")
    t_sw, _ = solve_sw(sw, a, bs, impl="torch")
    t_dir, _ = solve_sw(sw, a, bs, two_stream=False, impl="torch")
    for name, out, ref, tol in (
        ("solve_lw 3 angles", f_lw, t_lw, TOL["lw_noscat_banded_reduced"]),
        ("solve_sw", f_sw, t_sw, TOL["sw_2stream_reduced"]),
        ("solve_sw direct beam", f_dir, t_dir, TOL["sw_2stream_reduced"]),
    ):
        err, rel = rel_err(tuple(k[:, :CMP_NCOL] for k in out), tuple(ref))
        phase(tag, f"{name} two-kernel vs torch on {CMP_NCOL} columns: max|d|={err:.3e} rel={rel:.3e} "
                   f"(tol {tol:.0e})")
        require(rel <= tol, f"{name}: two-kernel vs torch rel error {rel:.3e} > {tol:.0e}")
    del t_lw, t_sw, t_dir, f_lw, f_sw, f_dir

    # all-sky (McICA by seed + aerosols) through the two-kernel path against the torch path
    atm_as = allsky_atmosphere(TWIN_CHUNK, NLAY)
    bl, bs = boundary_conditions(L.lookup_lw, L.lookup_sw, TWIN_CHUNK)
    lw_kw = dict(lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero, cld_mask_seed=MCICA_SEED,
                 col_offset=COL_OFFSET)
    sw_kw = dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero, cld_mask_seed=MCICA_SEED + 1,
                 col_offset=COL_OFFSET)
    cases = (
        ("solve_lw 3 angles", lambda i: solve_lw(L.lookup_lw, atm_as, bl, n_gauss_angles=3, impl=i, **lw_kw),
         TOL["lw_noscat_banded_reduced"]),
        ("solve_sw", lambda i: solve_sw(L.lookup_sw, atm_as, bs, impl=i, **sw_kw), TOL["sw_2stream_reduced"]),
        ("solve_sw direct beam", lambda i: solve_sw(L.lookup_sw, atm_as, bs, two_stream=False, impl=i, **sw_kw),
         TOL["sw_2stream_reduced"]),
    )
    for name, solve, tol in cases:
        (out, d_out), (ref, d_ref) = solve("two_kernel"), solve("torch")
        err, rel = rel_err(tuple(out), tuple(ref))
        phase(tag, f"all-sky {name} two-kernel vs torch on {TWIN_CHUNK} columns: max|d|={err:.3e} "
                   f"rel={rel:.3e} (tol {tol:.0e}), cloud cover bitwise")
        require(rel <= tol, f"all-sky {name}: two-kernel vs torch rel error {rel:.3e} > {tol:.0e}")
        require(torch.equal(d_out.cld_cover, d_ref.cld_cover), f"all-sky {name}: cloud cover differs")
        require(float(d_out.cld_cover.max()) > 0.0, "no cloud in the all-sky comparison")
    return launches


def interp_cases(lw, sw, atm):
    """(label, interp_pt_eta arguments) of each table the unfused optics
    read, as optics_unfused builds them, the LW kmajor call last (its time
    is the one the kernels line keeps); and the MegaInputs of LW and SW."""
    import torch

    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    cases, inputs = [], {}
    for wave, lkp in (("SW", sw), ("LW", lw)):
        inp = (mega_lw_inputs if wave == "LW" else mega_sw_inputs)(lkp, atm)
        tabs = lkp.kernel_tables
        inputs[wave] = (inp, tabs)
        eta = (inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tabs.gpt2band)
        if wave == "LW":
            cases.append(("LW Planck fraction", (tabs.second, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress,
                                                 *eta)))
        else:
            cases.append(("SW Rayleigh", (tabs.second, inp.jtemp, inp.ftemp, (~inp.tropo_lower).to(torch.int32),
                                          torch.zeros_like(inp.fpress), *eta)))
        cases.append((f"{wave} kmajor", (tabs.kmajor, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress, *eta,
                                         inp.col_mix1, inp.col_mix2)))
    cases.sort(key=lambda c: c[0] == "LW kmajor")
    return cases, inputs


def minor_work(inp, tabs) -> Work:
    """interp_minor's work: the inputs it reads (indices and fractions of
    temperature and eta, the troposphere side, the scalings, kminor and the
    interval index) and the operations of the intervals covering each
    point on its cell's side."""
    read = [getattr(inp, k) for k in ("jtemp", "ftemp", "tropo_lower", "jeta1", "feta1", "jeta2", "feta2",
                                      "minor_scaling")]
    read += [getattr(tabs, k) for k in ("kminor", "gpt2band", "minor_start", "minor_list", "minor_kbase",
                                        "minor_band")]
    return Work(nbytes(read), mega_ops("interp_minor", inp, tabs))


def check_unfused_kernels(label, lw, sw, atm, reps, results, chunk=None) -> None:
    """The kernels of the unfused optics against their twins (on column
    chunks when ``chunk`` is given): interp_pt_eta for each table and
    interp_minor for LW and SW; then interp_pt_eta's design."""
    import torch

    from rrtmgp_tpu_torch.ops import interp

    ncol = atm.ncol
    cases, inputs = interp_cases(lw, sw, atm)
    for what, args in cases:
        ngpt = args[0].shape[-1]
        check_case(f"{label} [{what}]", "interp_pt_eta", lambda: (interp.interp_pt_eta(*args),),
                   lambda: by_columns(lambda *a: (interp.interp_pt_eta_ref(*a),), args, ncol, chunk), reps, results,
                   work=Work(nbytes(args), OPS_INTERP * atm.nlay * ncol * ngpt))
    for wave in ("SW", "LW"):
        inp, tabs = inputs[wave]
        check_case(f"{label} [{wave}]", "interp_minor", lambda: (interp.interp_minor(inp, tabs),),
                   lambda: by_columns(lambda *a: (interp.interp_minor_ref(*a),), (inp, tabs), ncol, chunk), reps,
                   results, work=minor_work(inp, tabs))
    for wave in ("SW", "LW"):
        tabs = inputs[wave][1]
        print_gather_design(f"{label} [{wave}]", "interp_pt_eta",
                            interp.interp_pt_eta_design(tabs.lkp.n_gpt, tabs.lkp.n_bnd, torch.device(DEVICE)),
                            "interp_pt_eta_kernel")
        print_gather_design(f"{label} [{wave}]", "interp_minor", interp.interp_minor_design(tabs),
                            "interp_minor_kernel")


def phase_unfused_slice(lw, sw, atm, bcs_lw, bcs_sw, L) -> dict:
    """The unfused two-kernel slice at full width on the clear cell's
    inputs: the two-kernel slice's step with fused_optics=False. Returns the
    launch counts of the timed steps."""
    import torch

    from rrtmgp_tpu_torch import solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import interp
    from rrtmgp_tpu_torch.states import slice_columns

    tag, ncol = "unfused", atm.ncol

    def step(**kw):
        f_lw, _ = solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, **kw)
        f_sw, _ = solve_sw(sw, atm, bcs_sw, **kw)
        f_dir, _ = solve_sw(sw, atm, bcs_sw, two_stream=False, **kw)
        return f_lw, f_sw, f_dir

    (f_lw, f_sw, f_dir), ms, lo, hi, peak, launches = timed_steps(lambda: step(fused_optics=False), STEPS)
    per_step = {k: n / STEPS for k, n in launches.items()}
    want = {"interp_pt_eta": 6, "interp_minor": 3, "planck_band_rows": 1, "lw_noscat_banded_reduced": 1,
            "sw_2stream_reduced": 1}
    phase(tag, f"launches in {STEPS} steps: {launches}")
    require(per_step == want, f"launches per step {per_step}, expected {want}")
    phase(tag, f"LW 3 angles + SW two-stream + SW direct beam, fused_optics=False, at {ncol} x {NLAY}: median "
               f"{ms:.3f} ms over {STEPS} steps (min {lo:.3f}, max {hi:.3f}), {ncol / (ms / 1e3):.1f} columns/s, "
               f"peak memory {peak:.2f} GB, launches per step {per_step}")
    (fused, ms_f, lo, hi, peak_f, _) = timed_steps(lambda: step(impl="two_kernel"), STEPS)
    phase(tag, f"the same step with the fused optics (impl='two_kernel'): median {ms_f:.3f} ms (min {lo:.3f}, "
               f"max {hi:.3f}), peak memory {peak_f:.2f} GB")

    # physics oracles, as the two-kernel slice holds them
    for f in (*f_lw, *f_sw, *f_dir):
        require(f.shape == (NLAY + 1, ncol) and torch.isfinite(f).all(), "flux shape or non-finite flux")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), "LW flux_dn at TOA is not 0 (no incident flux)")
    for f in (f_sw, f_dir):
        require(torch.all(f.flux_dn_dir[:-1] <= f.flux_dn_dir[1:]), "SW direct beam increases toward the surface")
    require(torch.all(f_dir.flux_up == 0.0) and torch.all(f_dir.flux_dn == 0.0),
            "the direct-beam solve has a diffuse flux")
    require(torch.all(f_sw.flux_up[-1] <= 1361.0 * 0.6), "SW TOA up flux exceeds the incoming flux")
    phase(tag, "oracles: finite, LW TOA dn = 0, direct beam monotone, flux_up = flux_dn = 0 in the direct-beam "
               "solve, TOA up <= incoming")
    check_night(sw, atm, bcs_sw, dict(fused_optics=False), tag, impl=None)

    # the unfused optics against optics_fused at full width, LW and SW
    _, inputs = interp_cases(lw, sw, atm)
    for wave, (inp, tabs) in inputs.items():
        out, ref = interp.optics_unfused(inp, tabs), interp.optics_fused(inp, tabs)
        err, rel = rel_err(out, ref)
        phase(tag, f"{wave} optics_unfused vs optics_fused on {ncol} columns: max|d|={err:.3e} rel={rel:.3e} "
                   f"(tol {TOL['interp_pt_eta']:.0e}), bitwise equal: {all(torch.equal(a, b) for a, b in zip(out, ref))}")
        require(rel <= TOL["interp_pt_eta"], f"{wave} unfused optics vs optics_fused: rel error {rel:.3e}")
        del out, ref
    del inputs
    torch.cuda.empty_cache()

    # the fluxes against the fused two-kernel route at full width and the torch path on the first columns
    names = ("solve_lw 3 angles", "solve_sw", "solve_sw direct beam")
    for name, out, ref in zip(names, (f_lw, f_sw, f_dir), fused):
        compare_fluxes(tag, f"{name} unfused vs fused two-kernel route on {ncol} columns", out, ref, UNFUSED_TOL)
    del fused
    a, bl, bs = (slice_columns(x, 0, CMP_NCOL, ncol) for x in (atm, bcs_lw, bcs_sw))
    refs = (solve_lw(lw, a, bl, n_gauss_angles=3, impl="torch")[0], solve_sw(sw, a, bs, impl="torch")[0],
            solve_sw(sw, a, bs, two_stream=False, impl="torch")[0])
    tols = (TOL["lw_noscat_banded_reduced"], TOL["sw_2stream_reduced"], TOL["sw_2stream_reduced"])
    for name, out, ref, tol in zip(names, (f_lw, f_sw, f_dir), refs, tols):
        compare_fluxes(tag, f"{name} unfused vs torch on {CMP_NCOL} columns", out, ref, tol, CMP_NCOL)
    del refs, f_lw, f_sw, f_dir
    torch.cuda.empty_cache()

    # all-sky (McICA by seed + aerosols) through the unfused route against the torch path
    atm_as = allsky_atmosphere(TWIN_CHUNK, NLAY)
    bl, bs = boundary_conditions(L.lookup_lw, L.lookup_sw, TWIN_CHUNK)
    lw_kw = dict(lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero, cld_mask_seed=MCICA_SEED,
                 col_offset=COL_OFFSET)
    sw_kw = dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero, cld_mask_seed=MCICA_SEED + 1,
                 col_offset=COL_OFFSET)
    cases = (
        ("solve_lw 3 angles", lambda **k: solve_lw(L.lookup_lw, atm_as, bl, n_gauss_angles=3, **lw_kw, **k),
         TOL["lw_noscat_banded_reduced"]),
        ("solve_sw", lambda **k: solve_sw(L.lookup_sw, atm_as, bs, **sw_kw, **k), TOL["sw_2stream_reduced"]),
    )
    for name, solve, tol in cases:
        (out, d_out), (ref, d_ref) = solve(fused_optics=False), solve(impl="torch")
        compare_fluxes(tag, f"all-sky {name} unfused vs torch on {TWIN_CHUNK} columns", out, ref, tol)
        require(torch.equal(d_out.cld_cover, d_ref.cld_cover), f"all-sky {name}: cloud cover differs")
        require(float(d_out.cld_cover.max()) > 0.0, "no cloud in the all-sky comparison")
    phase(tag, "all-sky: cloud cover bitwise against the torch path")
    return launches


def per_gpt_sw_args(k15):
    """sw_2stream_reduced's arguments in sw_2stream_gpt's layout: mu0 and the
    band-valued albedos expanded to (ncol, ngpt)."""
    tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc = k15
    g2b = gpt2band.long()
    return (tau, ssa, g, mu0[:, None].expand(-1, tau.shape[2]).contiguous(), toa_gpt,
            alb_dir.T[:, g2b].contiguous(), alb_dif.T[:, g2b].contiguous(), inc)


def sweep_args(lw, sw, atm, bcs_lw, bcs_sw):
    """The arguments of the four sweeps from materialized optics and sources
    as solve_lw / solve_sw build them on clear sky: tau and the Planck
    sources of gas_optics_kernel.gas_optics_lw (the optics kernel, the band
    Planck kernel, the sources in plain torch), ssa = g = 0 for LW
    two-stream; SW as sw_2stream_reduced takes it, with mu0 and the albedos
    expanded to g-points. Returns the argument tuples of lw_noscat_reduced,
    lw_2stream_reduced, sw_2stream_reduced, sw_2stream_gpt, lw_noscat_gpt."""
    import torch

    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw

    Ds, wts = angular_discretization(1)
    ds, w = float(Ds[0]), float(wts[0])
    tau, src = gas_optics_lw(lw, atm)
    g2b = lw.kernel_tables.gpt2band
    zeros = torch.zeros_like(tau)
    k13 = (tau, src.lay_source, src.lev_source, src.sfc_source, bcs_lw.sfc_emis, g2b, ds, w, None)
    k14 = (tau, zeros, zeros, src.lev_source, src.sfc_source, bcs_lw.sfc_emis, g2b, None)
    k16b = (tau, src.lay_source, src.lev_source, src.sfc_source, bcs_lw.sfc_emis.T[:, g2b.long()].contiguous(),
            ds, w, None)
    k15 = two_kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[4]
    return k13, k14, k15, per_gpt_sw_args(k15), k16b


def check_sweep_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, reps, results, chunk=None):
    """The four sweeps from materialized optics and sources against their
    twins (on column chunks when ``chunk`` is given), lw_noscat_reduced also
    at the sweep route's 3 angles in one launch (against the per-angle twin
    sum, and bit for bit the one-angle launches summed), and path C: each
    per-g-point sweep summed over g-points against its g-summed sibling on
    the same inputs. Returns the launch counts of path C's two calls."""
    import torch

    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.ops import rte_kernels as rk

    ncol = atm.ncol
    k13, k14, k15, k16a, k16b = sweep_args(lw, sw, atm, bcs_lw, bcs_sw)
    twin = lambda fn, args: by_columns(fn, args, ncol, chunk)
    points = lambda lkp: atm.nlay * ncol * lkp.n_gpt
    cases = (
        ("lw_noscat_reduced", rk.lw_noscat_reduced, rk.lw_noscat_reduced_ref, k13, OPS_LW_SWEEP * points(lw)),
        ("lw_2stream_reduced", rk.lw_2stream_reduced, rk.lw_2stream_reduced_ref, k14, OPS_LW2_SWEEP * points(lw)),
        ("sw_2stream_gpt", rk.sw_2stream_gpt, rk.sw_2stream_gpt_ref, k16a, OPS_SW_SWEEP * points(sw)),
        ("lw_noscat_gpt", rk.lw_noscat_gpt, rk.lw_noscat_gpt_ref, k16b, OPS_LW_SWEEP * points(lw)),
    )
    for name, kern, ref, args, ops in cases:
        check_case(label, name, lambda: kern(*args), lambda: twin(ref, args), reps, results,
                   work=Work(nbytes(args), ops))
    print_lw2_sweep_design(label, lambda: rk.lw_2stream_reduced(*k14), atm.nlay, lw.n_gpt)
    # the per-g-point sweeps with an incident flux, then their designs
    for name, kern, ref, args in (("sw_2stream_gpt", rk.sw_2stream_gpt, rk.sw_2stream_gpt_ref, k16a),
                                  ("lw_noscat_gpt", rk.lw_noscat_gpt, rk.lw_noscat_gpt_ref, k16b)):
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        inc = (*args[:-1], 0.5 + torch.rand(args[0].shape[1:], generator=gen, device=DEVICE))
        check_case(f"{label} [incident flux]", name, lambda: kern(*inc), lambda: twin(ref, inc), 0, results)
        del inc
    print_gpt_sweep_designs(label, k16a, k16b)
    # K13 as the sweep route launches it: solve_lw's 3 angles in one launch
    # (the kernels line keeps this call's time), the same bytes as one angle
    # and 3 x the operations; bit for bit the one-angle launches summed
    k13_3 = angles_args(k13[:6], k13[8], 3)
    check_case(f"{label} [3 angles, one launch]", "lw_noscat_reduced",
               lambda: rk.lw_noscat_reduced_angles(*k13_3), lambda: twin(rk.lw_noscat_reduced_angles_ref, k13_3),
               reps, results, work=Work(nbytes(k13_3), 3 * OPS_LW_SWEEP * points(lw)))
    one, per = rk.lw_noscat_reduced_angles(*k13_3), None
    for d, w in zip(k13_3[6], k13_3[7]):
        f = rk.lw_noscat_reduced(*k13_3[:6], d, w, None if k13_3[8] is None else k13_3[8] * w)
        per = f if per is None else (per[0] + f[0], per[1] + f[1])
    same = all(torch.equal(a, b) for a, b in zip(one, per))
    phase("kernels", f"{label} lw_noscat_reduced 3 angles in one launch vs 3 one-angle launches summed: "
                     f"bitwise equal: {same}")
    require(same, "lw_noscat_reduced: 3 angles in one launch differ from the one-angle launches summed")
    del one, per
    for nang in (1, 3):
        print_angles_design(label, "lw_noscat_reduced", nang, atm.nlay, lw.n_gpt)
    # path C, the per-g-point entry points: driven once, summed, against the g-summed sweeps
    mega.reset_launch_counts()
    per_gpt = (("lw_noscat_gpt vs lw_noscat_reduced", rk.lw_noscat_gpt(*k16b), rk.lw_noscat_reduced(*k13)),
               ("sw_2stream_gpt vs sw_2stream_reduced", rk.sw_2stream_gpt(*k16a), rk.sw_2stream_reduced(*k15)))
    launches = mega.launch_counts()
    for what, full, summed in per_gpt:
        require(all(f.shape == (atm.nlay + 1, ncol, f.shape[2]) for f in full), f"{what}: per-g-point flux shape")
        err, rel = rel_err(tuple(f.sum(-1) for f in full), summed)
        phase("sweep", f"{label} path C, {what}: summed over g-points max|d|={err:.3e} rel={rel:.3e} "
                       f"(tol {SUM_TOL:.0e})")
        require(rel <= SUM_TOL, f"{what}: rel error {rel:.3e} > {SUM_TOL:.0e}")
    return launches


def check_lw2_sweep_allsky(label, L, atm, results) -> None:
    """lw_2stream_reduced with scattering: the materialized optics composed
    with clouds (McICA by seed) and aerosols at g-point resolution, so that
    ssa and g are not zero."""
    import torch

    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import mega, rte_kernels
    from rrtmgp_tpu_torch.ops.gas_optics_kernel import gas_optics_lw

    lw, ncol = L.lookup_lw, atm.ncol
    bcs_lw, _ = boundary_conditions(lw, L.lookup_sw, ncol)
    tau, src = gas_optics_lw(lw, atm, need_lay_source=False)
    comp = _kernel_composition(lw, atm, L.lookup_lw_cld, L.lookup_lw_aero, None, MCICA_SEED, COL_OFFSET,
                               None, False, False)[0]
    zeros = torch.zeros_like(tau)
    tau, ssa, g, _ = mega._compose_ref(comp, lw, tau, zeros, zeros)
    require(float(ssa.max()) > 0.1 and float(g.max()) > 0.1, "the all-sky composition does not scatter")
    args = (tau.contiguous(), ssa.contiguous(), g.contiguous(), src.lev_source, src.sfc_source, bcs_lw.sfc_emis,
            lw.kernel_tables.gpt2band, None)
    check_case(f"{label} [with ssa and g, clouds+aerosols]", "lw_2stream_reduced",
               lambda: rte_kernels.lw_2stream_reduced(*args),
               lambda: rte_kernels.lw_2stream_reduced_ref(*args), 0, results)


def timed_steps(step, steps):
    """One warm-up, then ``steps`` host-timed steps closed by a synchronize:
    (last step's result, median ms, min ms, max ms, peak GB, launch counts of
    the timed steps)."""
    import torch

    from rrtmgp_tpu_torch.ops import mega

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return (out, statistics.median(times), min(times), max(times), torch.cuda.max_memory_allocated() / 1e9,
            {k: n for k, n in mega.launch_counts().items() if n})


def compare_fluxes(tag, name, out, ref, tol, ncols=None) -> None:
    """Fluxes of a route against a reference route's (on the first ``ncols``
    columns), within ``tol`` of the largest reference value."""
    import torch

    if ncols is not None:
        out = tuple(f[:, :ncols] for f in out)
    err, rel = rel_err(tuple(out), tuple(ref))
    phase(tag, f"{name}: max|d|={err:.3e} rel={rel:.3e} (tol {tol:.0e}), bitwise equal: "
               f"{all(torch.equal(a, b) for a, b in zip(out, ref))}")
    require(rel <= tol, f"{name}: rel error {rel:.3e} > {tol:.0e}")


def phase_sweep_slice(lw, sw, atm, bcs_lw, bcs_sw) -> dict:
    """Paths A and B of the sweep slice at full width on the clear cell's
    inputs, and the mixed-dtype boundary conditions; returns the launch
    counts of path B's timed steps plus path A's."""
    import torch

    from rrtmgp_tpu_torch import solve_lw, solve_sw
    from rrtmgp_tpu_torch.states import slice_columns

    tag, ncol = "sweep", atm.ncol
    a, bl, bs = (slice_columns(x, 0, CMP_NCOL, ncol) for x in (atm, bcs_lw, bcs_sw))

    # path A: LW two-stream on the two-kernel path
    (f_a, _), ms, lo, hi, peak, launches_a = timed_steps(
        lambda: solve_lw(lw, atm, bcs_lw, two_stream=True, impl="two_kernel"), STEPS)
    per_step = {k: n / STEPS for k, n in launches_a.items()}
    want = {"optics_fused": 1, "planck_band_rows": 1, "lw_2stream_reduced": 1}
    require(per_step == want, f"path A launches per step {per_step}, expected {want}")
    phase(tag, f"path A, solve_lw two-stream two-kernel clear at {ncol} x {NLAY}: median {ms:.3f} ms over {STEPS} "
               f"steps (min {lo:.3f}, max {hi:.3f}), {ncol / (ms / 1e3):.1f} columns/s, peak memory {peak:.2f} GB, "
               f"launches per step {per_step}")
    (f_k, _), ms_k, lo, hi, peak_k, _ = timed_steps(
        lambda: solve_lw(lw, atm, bcs_lw, two_stream=True, impl="kernel"), STEPS)
    phase(tag, f"path A, the megakernel route (lw2_mega) on the same inputs: median {ms_k:.3f} ms "
               f"(min {lo:.3f}, max {hi:.3f}), peak memory {peak_k:.2f} GB")
    require(torch.all(f_a.flux_dn[-1] == 0.0), "path A: LW flux_dn at TOA is not 0 (no incident flux)")
    compare_fluxes(tag, f"path A two-kernel vs megakernel route on {ncol} columns", f_a, f_k,
                   TOL["lw_2stream_reduced"])
    t_lw2, _ = solve_lw(lw, a, bl, two_stream=True, impl="torch")
    compare_fluxes(tag, f"path A two-kernel vs torch on {CMP_NCOL} columns", f_a, t_lw2, TOL["lw_2stream_reduced"],
                   CMP_NCOL)
    del f_a, f_k
    torch.cuda.empty_cache()

    # path B: the sweep-only route
    def step():
        f3, _ = solve_lw(lw, atm, bcs_lw, n_gauss_angles=3, impl="sweep")
        f2, _ = solve_lw(lw, atm, bcs_lw, two_stream=True, impl="sweep")
        fs, _ = solve_sw(sw, atm, bcs_sw, impl="sweep")
        return f3, f2, fs

    steps = 3
    (f3, f2, fs), ms, lo, hi, peak, launches = timed_steps(step, steps)
    per_step = {k: n / steps for k, n in launches.items()}
    want = {"lw_noscat_reduced": 1, "lw_2stream_reduced": 1, "sw_2stream_reduced": 1}
    require(per_step == want, f"path B launches per step {per_step}, expected {want}")
    phase(tag, f"path B, LW 3 angles + LW two-stream + SW two-stream through impl='sweep' at {ncol} x {NLAY}: "
               f"median {ms:.3f} ms over {steps} steps (min {lo:.3f}, max {hi:.3f}), "
               f"{ncol / (ms / 1e3):.1f} columns/s, peak memory {peak:.2f} GB, launches per step {per_step}")
    for f in (*f3, *f2, *fs):
        require(f.shape == (NLAY + 1, ncol) and torch.isfinite(f).all(), "flux shape or non-finite flux")
    require(torch.all(f3.flux_dn[-1] == 0.0) and torch.all(f2.flux_dn[-1] == 0.0),
            "path B: LW flux_dn at TOA is not 0 (no incident flux)")
    require(torch.all(fs.flux_dn_dir[:-1] <= fs.flux_dn_dir[1:]), "SW direct beam increases toward the surface")
    check_night(sw, a, bs, {}, tag, impl="sweep")
    t_lw3, _ = solve_lw(lw, a, bl, n_gauss_angles=3, impl="torch")
    t_sw, _ = solve_sw(sw, a, bs, impl="torch")
    for name, out, ref, tol in (("solve_lw 3 angles", f3, t_lw3, TOL["lw_noscat_reduced"]),
                                ("solve_lw two-stream", f2, t_lw2, TOL["lw_2stream_reduced"]),
                                ("solve_sw", fs, t_sw, TOL["sw_2stream_reduced"])):
        compare_fluxes(tag, f"path B {name} sweep vs torch on {CMP_NCOL} columns", out, ref, tol, CMP_NCOL)
    del f3, f2, fs, t_lw3, t_lw2, t_sw
    torch.cuda.empty_cache()

    # boundary conditions of another dtype than the state, on the default route
    f64 = lambda b: dataclasses.replace(b, **{f.name: getattr(b, f.name).double() for f in dataclasses.fields(b)
                                              if isinstance(getattr(b, f.name), torch.Tensor)})
    for name, solve, b in (("solve_lw", lambda x: solve_lw(lw, a, x)[0], bl),
                           ("solve_sw", lambda x: solve_sw(sw, a, x)[0], bs)):
        mixed, cast = solve(f64(b)), solve(b)
        require(all(m.dtype == torch.float32 and torch.equal(m, c) for m, c in zip(mixed, cast)),
                f"{name}: f64 boundary conditions with an f32 atmosphere differ from the cast input's result")
    phase(tag, "f64 boundary conditions with an f32 atmosphere through the default impl: f32 fluxes, "
               "bitwise equal to the cast input's")
    launches["lw_2stream_reduced"] += launches_a["lw_2stream_reduced"]
    return launches


def phase_sweep_allsky(L, atm, bcs_lw) -> None:
    """Path A all-sky (McICA by seed + aerosols) at the all-sky cell's size:
    unchunked if its memory, measured on 8192 columns and scaled, fits the
    free memory of the card with a tenth to spare; else through
    solve_chunked in as few equal chunks as fit."""
    import torch

    from rrtmgp_tpu_torch import solve_lw
    from rrtmgp_tpu_torch.models.rrtmgp import solve_chunked
    from rrtmgp_tpu_torch.states import slice_columns

    tag, ncol, lw = "sweep", atm.ncol, L.lookup_lw
    kw = dict(two_stream=True, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero)

    def solve(impl, a, b, off=0):
        return solve_lw(lw, a, b, cld_mask_seed=MCICA_SEED, col_offset=COL_OFFSET + off, impl=impl, **kw)

    a, bl = slice_columns(atm, 0, TWIN_CHUNK, ncol), slice_columns(bcs_lw, 0, TWIN_CHUNK, ncol)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    solve("two_kernel", a, bl)
    per_col = (torch.cuda.max_memory_allocated() - base) / TWIN_CHUNK
    free = torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    n_chunks = -(-int(per_col * ncol) // int(0.9 * free))
    fits = n_chunks == 1
    chunk = -(-ncol // n_chunks // 1024) * 1024  # equal chunks, whole thousands of columns
    phase(tag, f"path A all-sky: {per_col * ncol / 1e9:.2f} GB needed at {ncol} columns ({per_col / 1e3:.1f} KB "
               f"per column on {TWIN_CHUNK}), {free / 1e9:.2f} GB free: "
               + ("unchunked" if fits else f"through solve_chunked in {n_chunks} chunks of {chunk} columns"))

    def run(impl):
        if fits:
            return solve(impl, atm, bcs_lw)
        return solve_chunked(lambda x, y, seed, off: solve(impl, x, y, off), atm, bcs_lw, chunk,
                             cld_mask_seed=MCICA_SEED)

    (f_a, d_a), ms, lo, hi, peak, launches = timed_steps(lambda: run("two_kernel"), 3)
    phase(tag, f"path A, solve_lw two-stream two-kernel all-sky at {ncol} x {NLAY}: median {ms:.3f} ms over 3 steps "
               f"(min {lo:.3f}, max {hi:.3f}), {ncol / (ms / 1e3):.1f} columns/s, peak memory {peak:.2f} GB, "
               f"launches in 3 steps {launches}")
    for name in ("optics_fused", "planck_band_rows", "lw_2stream_reduced", "aerosol_bands", "mcica_mask_export"):
        require(launches.get(name, 0) > 0, f"{name} was not launched on path A all-sky")
    (f_k, d_k), ms_k, lo, hi, peak_k, _ = timed_steps(lambda: solve("kernel", atm, bcs_lw), 3)
    phase(tag, f"path A all-sky, the megakernel route (lw2_mega): median {ms_k:.3f} ms (min {lo:.3f}, max {hi:.3f}), "
               f"peak memory {peak_k:.2f} GB")
    compare_fluxes(tag, f"path A all-sky two-kernel vs megakernel route on {ncol} columns", f_a, f_k,
                   TOL["lw_2stream_reduced"])
    require(torch.equal(d_a.cld_cover, d_k.cld_cover), "path A all-sky: cloud cover differs from the megakernel's")
    a, bl = slice_columns(atm, 0, CMP_NCOL, ncol), slice_columns(bcs_lw, 0, CMP_NCOL, ncol)
    f_t, d_t = solve("torch", a, bl)
    compare_fluxes(tag, f"path A all-sky two-kernel vs torch on {CMP_NCOL} columns", f_a, f_t,
                   TOL["lw_2stream_reduced"], CMP_NCOL)
    require(torch.equal(d_a.cld_cover[:CMP_NCOL], d_t.cld_cover), "path A all-sky: cloud cover differs from torch's")
    require(float(d_a.cld_cover.max()) > 0.0 and torch.all(f_a.flux_dn[-1] == 0.0), "path A all-sky oracles")
    phase(tag, "path A all-sky: cloud cover bitwise on both comparisons, LW TOA dn = 0")


# ---------------------------------------------------------------------------
# Gradients: differentiable_solve_lw / _sw (kernel forward, torch backward)
# ---------------------------------------------------------------------------

GRAD_CASES = (  # (name, wave, two_stream)
    ("lw_noscat", "lw", False), ("lw_2stream", "lw", True), ("sw", "sw", False),
)
#: kernels of each gradient forward, by route (impl=None: the megakernels)
GRAD_KERNELS = {
    (None, "lw_noscat"): ("planck_band", "lw_clear_mega"), (None, "lw_2stream"): ("planck_band", "lw2_mega"),
    (None, "sw"): ("sw_clear_mega",),
    ("two_kernel", "lw_noscat"): ("optics_fused", "planck_band_rows", "lw_noscat_banded_reduced"),
    ("two_kernel", "lw_2stream"): ("optics_fused", "planck_band_rows", "lw_2stream_reduced"),
    ("two_kernel", "sw"): ("optics_fused", "sw_2stream_reduced"),
}
GRAD_CHUNK_TOL = 1e-6           # chunked vs unchunked gradient, of the largest entry
GRAD_AEROSOL_NCOL = 8192


def with_grad(atm, bcs, wave):
    """The state and BCs with fresh copies of the fields a gradient is taken
    with respect to, requiring grad, and those copies by name: t_lay, t_lev,
    t_sfc and sfc_emis for LW; t_lay and every SW boundary condition."""
    a_names = ("t_lay", "t_lev", "t_sfc") if wave == "lw" else ("t_lay",)
    b_names = ("sfc_emis",) if wave == "lw" else ("cos_zenith", "toa_flux", "sfc_alb_direct", "sfc_alb_diffuse")
    leaves = {n: getattr(atm, n).detach().clone().requires_grad_(True) for n in a_names}
    leaves.update({n: getattr(bcs, n).detach().clone().requires_grad_(True) for n in b_names})
    atm = dataclasses.replace(atm, **{n: leaves[n] for n in a_names})
    bcs = dataclasses.replace(bcs, **{n: leaves[n] for n in b_names})
    return atm, bcs, leaves


def grad_loss(flux, wave):
    """The summed TOA upward LW / surface downward SW flux."""
    return flux.flux_up[-1].sum() if wave == "lw" else flux.flux_dn[0].sum()


@contextlib.contextmanager
def grad_chunks(force=None):
    """Record the column chunk of every differentiable-solve backward that
    runs inside (the value rrtmgp.grad_chunk returns), forcing it to
    ``force`` when given; yields the list of chunks."""
    from rrtmgp_tpu_torch.models import rrtmgp

    seen, real = [], rrtmgp.grad_chunk

    def chunk(*args, **kwargs):
        seen.append(force or real(*args, **kwargs))
        return seen[-1]

    rrtmgp.grad_chunk = chunk
    try:
        yield seen
    finally:
        rrtmgp.grad_chunk = real


def chunked_torch_grad(solve, lkp, atm, bcs, wave, chunk, kw):
    """torch.autograd.grad of the loss through impl="torch", column chunk by
    column chunk (the loss is a sum over columns): the backward's reference."""
    import torch

    from rrtmgp_tpu_torch.states import slice_columns

    atm, bcs, leaves = with_grad(atm, bcs, wave)
    ncol, total = atm.ncol, None
    for lo in range(0, ncol, chunk):
        hi = min(lo + chunk, ncol)
        flux, _ = solve(lkp, slice_columns(atm, lo, hi, ncol), slice_columns(bcs, lo, hi, ncol), impl="torch", **kw)
        part = torch.autograd.grad(grad_loss(flux, wave), list(leaves.values()))
        total = part if total is None else tuple(t + p for t, p in zip(total, part))
    return total


def phase_gradients(lw, sw, atm, bcs_lw, bcs_sw, tag="grad", lkp_aero=None) -> dict:
    """differentiable_solve_lw (no-scattering, two-stream) and _sw at the
    state's width, with impl=None (the megakernels) and "two_kernel": the
    forward bitwise equal to solve_lw / solve_sw on the same route, the
    gradient of the summed TOA up / surface down flux bitwise equal to
    torch.autograd.grad through the torch path in the same chunks; forward
    and backward ms, chunk, peak memory, and the torch path's backward bytes
    per (column, layer, g-point). Returns the forward launch counts."""
    import torch

    from rrtmgp_tpu_torch import differentiable_solve_lw, differentiable_solve_sw, solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.states import slice_columns

    ncol, counts = atm.ncol, {}
    for impl in (None, "two_kernel"):
        for name, wave, two_stream in GRAD_CASES:
            lkp, bcs = (lw, bcs_lw) if wave == "lw" else (sw, bcs_sw)
            solve = solve_lw if wave == "lw" else solve_sw
            make = differentiable_solve_lw if wave == "lw" else differentiable_solve_sw
            kw = dict(two_stream=True) if two_stream else {}
            if lkp_aero is not None:
                kw["lkp_aero"] = lkp_aero[wave]
            f = make(lkp, impl=impl, **kw)
            # warm-up on the first columns: kernels and the torch path's code warm
            a, b, leaves = with_grad(slice_columns(atm, 0, CMP_NCOL, ncol), slice_columns(bcs, 0, CMP_NCOL, ncol),
                                     wave)
            torch.autograd.grad(grad_loss(f(a, b), wave), list(leaves.values()))
            a, b, leaves = with_grad(atm, bcs, wave)
            torch.cuda.synchronize()
            mega.reset_launch_counts()
            t0 = time.perf_counter()
            flux = f(a, b)
            torch.cuda.synchronize()
            fwd_ms = 1e3 * (time.perf_counter() - t0)
            launched = {k: n for k, n in mega.launch_counts().items() if n}
            for k in GRAD_KERNELS[(impl, name)]:
                require(launched.get(k, 0) > 0, f"{tag} {name} impl={impl}: {k} not launched in the forward")
            if lkp_aero is not None and impl is None:
                require(launched.get("aerosol_bands", 0) > 0, f"{tag} {name}: aerosol_bands not launched")
            for k, n in launched.items():
                counts[k] = counts.get(k, 0) + n
            plain, _ = solve(lkp, atm, bcs, impl=impl, **kw)
            require(all(torch.equal(x, y) for x, y in zip(flux, plain)),
                    f"{tag} {name} impl={impl}: the forward differs from the plain solve")
            loss = grad_loss(flux, wave)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with grad_chunks() as seen:
                t0 = time.perf_counter()
                grads = torch.autograd.grad(loss, list(leaves.values()))
                torch.cuda.synchronize()
                bwd_ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            require(len(seen) == 1, f"{tag} {name} impl={impl}: {len(seen)} backward(s) sized a chunk")
            chunk = seen[0]
            per_point = (peak - base) / (min(chunk, ncol) * NLAY * lkp.n_gpt * atm.t_lay.element_size())
            ref = chunked_torch_grad(solve, lkp, atm, bcs, wave, chunk, kw)
            same = all(torch.equal(g, r) for g, r in zip(grads, ref))
            require(all(torch.isfinite(g).all() for g in grads), f"{tag} {name}: non-finite gradient")
            phase(tag, f"{name} impl={impl} at {ncol} x {NLAY}: forward {fwd_ms:.1f} ms (launches {launched}), "
                       f"backward {bwd_ms:.1f} ms in chunks of {chunk} columns, backward peak {peak / 1e9:.2f} GB "
                       f"({per_point:.1f} elements per column, layer and g-point above what was allocated), "
                       f"forward bitwise equal to solve(impl={impl!r}); gradient vs the torch path in the same "
                       f"chunks bitwise equal: {same}")
            require(same, f"{tag} {name} impl={impl}: the gradient differs from the chunked torch path")
            del flux, plain, loss, grads, ref
            torch.cuda.empty_cache()

    # chunking: a chunked backward equals the unchunked one on CMP_NCOL columns
    for name, wave, two_stream in GRAD_CASES:
        lkp, bcs = (lw, bcs_lw) if wave == "lw" else (sw, bcs_sw)
        make = differentiable_solve_lw if wave == "lw" else differentiable_solve_sw
        kw = dict(two_stream=True) if two_stream else {}
        if lkp_aero is not None:
            kw["lkp_aero"] = lkp_aero[wave]
        a0, b0 = slice_columns(atm, 0, CMP_NCOL, ncol), slice_columns(bcs, 0, CMP_NCOL, ncol)
        out = []
        for chunk in (CMP_NCOL, CMP_NCOL // 4):
            a, b, leaves = with_grad(a0, b0, wave)
            with grad_chunks(force=chunk):
                out.append(torch.autograd.grad(grad_loss(make(lkp, **kw)(a, b), wave), list(leaves.values())))
        err, rel = rel_err(out[1], out[0])
        phase(tag, f"{name} on {CMP_NCOL} columns: chunks of {CMP_NCOL // 4} vs one chunk: max|d|={err:.3e} "
                   f"rel={rel:.3e} (tol {GRAD_CHUNK_TOL:.0e}), bitwise equal: "
                   f"{all(torch.equal(x, y) for x, y in zip(*out))}")
        require(rel <= GRAD_CHUNK_TOL, f"{tag} {name}: chunked gradient rel error {rel:.3e}")
    if lkp_aero is None:
        phase_grad_angles(lw, atm, bcs_lw, tag)
    return counts


GRAD_ANGLES = (3, 4)
GRAD_ANGLES_NCOL, GRAD_ANGLES_CHUNK = 8192, 4096


def phase_grad_angles(lw, atm, bcs_lw, tag) -> None:
    """differentiable_solve_lw (no-scattering) with 3 and 4 quadrature
    angles on GRAD_ANGLES_NCOL columns, its backward forced into chunks of
    GRAD_ANGLES_CHUNK columns: the elements per (column, layer, g-point) the
    torch-path backward holds above what was allocated (the figure
    rrtmgp.GRAD_ELEMENTS_PER_POINT bounds at one angle), the gradient bitwise
    equal to torch.autograd.grad through the torch path in the same chunks,
    and chunks of a quarter within GRAD_CHUNK_TOL of one chunk."""
    import torch

    from rrtmgp_tpu_torch import differentiable_solve_lw, solve_lw
    from rrtmgp_tpu_torch.models import rrtmgp
    from rrtmgp_tpu_torch.states import slice_columns

    ncol = atm.ncol
    a0, b0 = slice_columns(atm, 0, GRAD_ANGLES_NCOL, ncol), slice_columns(bcs_lw, 0, GRAD_ANGLES_NCOL, ncol)
    for n in GRAD_ANGLES:
        kw = dict(n_gauss_angles=n)
        f = differentiable_solve_lw(lw, **kw)
        a, b, leaves = with_grad(a0, b0, "lw")
        loss = grad_loss(f(a, b), "lw")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with grad_chunks(force=GRAD_ANGLES_CHUNK) as seen:
            t0 = time.perf_counter()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            torch.cuda.synchronize()
            bwd_ms = 1e3 * (time.perf_counter() - t0)
        per_point = (torch.cuda.max_memory_allocated() - base) / (
            GRAD_ANGLES_CHUNK * NLAY * lw.n_gpt * atm.t_lay.element_size())
        natural = rrtmgp.grad_chunk(lw, a0)
        ref = chunked_torch_grad(solve_lw, lw, a0, b0, "lw", GRAD_ANGLES_CHUNK, kw)
        same = all(torch.equal(g, r) for g, r in zip(grads, ref))
        phase(tag, f"lw_noscat {n} angles at {GRAD_ANGLES_NCOL} x {NLAY}: backward {bwd_ms:.1f} ms in {len(seen)} "
                   f"chunk(s) of {GRAD_ANGLES_CHUNK} columns, {per_point:.1f} elements per column, layer and g-point "
                   f"above what was allocated (GRAD_ELEMENTS_PER_POINT {rrtmgp.GRAD_ELEMENTS_PER_POINT}; grad_chunk "
                   f"would take {natural} columns here); gradient vs the torch path in the same chunks bitwise "
                   f"equal: {same}")
        require(same, f"{tag} lw_noscat {n} angles: the gradient differs from the chunked torch path")
        out = []
        for chunk in (CMP_NCOL, CMP_NCOL // 4):
            a, b, leaves = with_grad(slice_columns(a0, 0, CMP_NCOL, GRAD_ANGLES_NCOL),
                                     slice_columns(b0, 0, CMP_NCOL, GRAD_ANGLES_NCOL), "lw")
            with grad_chunks(force=chunk):
                out.append(torch.autograd.grad(grad_loss(f(a, b), "lw"), list(leaves.values())))
        err, rel = rel_err(out[1], out[0])
        phase(tag, f"lw_noscat {n} angles on {CMP_NCOL} columns: chunks of {CMP_NCOL // 4} vs one chunk: "
                   f"max|d|={err:.3e} rel={rel:.3e} (tol {GRAD_CHUNK_TOL:.0e}), bitwise equal: "
                   f"{all(torch.equal(x, y) for x, y in zip(*out))}")
        require(rel <= GRAD_CHUNK_TOL, f"{tag} lw_noscat {n} angles: chunked gradient rel error {rel:.3e}")
        del loss, grads, ref, out
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The gray model
# ---------------------------------------------------------------------------

GRAY_P0, GRAY_PE = 100000.0, 9000.0
GRAY_EQ_NCOL = 9
GRAY_EQ_GATE_K = 0.1            # the reference's equilibrium gate (f64)


def phase_gray() -> None:
    """RRTMGPSolver(GrayRadiation()) at 32768 x 60 in f32 and f64, LW
    no-scattering and two-stream with SW two-stream and direct beam: step
    time and the gray oracles (exact Beer-Lambert direct beam within 1e-3,
    night columns 0, LW TOA down 0 and surface up sigma T^4); then the LW
    radiative equilibrium in f64 at 9 columns x 60 layers to the reference's
    0.1 K gate, with its steps, seconds and time per step."""
    import math

    import numpy as np
    import torch

    from rrtmgp_tpu_torch import (
        GrayOpticalThicknessOGorman2008,
        GrayOpticalThicknessSchneider2004,
        GrayRadiation,
        LwBCs,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
        SwBCs,
        gray_lw_equilibrium,
        setup_gray_as_pr_grid,
    )
    from rrtmgp_tpu_torch.models.gray import gray_optics_sw

    P = RRTMGPParameters()
    lat = np.linspace(-90.0, 90.0, NCOL)
    mu0 = np.cos(np.deg2rad(52.95)) * np.ones(NCOL)
    mu0[1::7] = -0.2  # night columns
    for dtype in (torch.float32, torch.float64):
        atm = setup_gray_as_pr_grid(NLAY, lat, GRAY_P0, GRAY_PE, GrayOpticalThicknessOGorman2008(), P, dtype=dtype,
                                    device=DEVICE)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=DEVICE)
        bcs_lw = LwBCs(sfc_emis=f(np.ones((1, NCOL))))
        bcs_sw = SwBCs(cos_zenith=f(mu0), toa_flux=f(np.full(NCOL, 1407.679)),
                       sfc_alb_direct=f(np.full((1, NCOL), 0.1)), sfc_alb_diffuse=f(np.full((1, NCOL), 0.1)))
        for two_stream_lw, two_stream_sw in ((False, True), (True, False)):
            solver = RRTMGPSolver(RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=dtype), GrayRadiation(), P,
                                  bcs_lw, bcs_sw, atm, two_stream_lw=two_stream_lw, two_stream_sw=two_stream_sw)
            require(solver.auto_chunk is None, "a gray solver has no auto-chunk")
            (f_lw, f_sw), ms, lo, hi, peak, launches = timed_steps(solver.update_fluxes, STEPS)
            for x in (*f_lw, *f_sw):
                require(torch.isfinite(x).all(), "gray: non-finite flux")
            require(torch.all(f_lw.flux_dn[-1] == 0.0), "gray: LW TOA down is not 0")
            sigma_t4 = P.Stefan * atm.t_sfc.double() ** 4
            lw_rel = ((f_lw.flux_up[0].double() - sigma_t4).abs() / sigma_t4).max().item()
            require(lw_rel <= (1e-12 if dtype == torch.float64 else 1e-5), f"gray: surface up vs sigma T^4 {lw_rel:.3e}")
            night = bcs_sw.cos_zenith <= 0
            require(all(torch.all(x[:, night] == 0.0) for x in f_sw), "gray: night columns are not 0")
            day = int(torch.nonzero(~night)[0, 0])
            exact = 1407.679 * mu0[day] * math.exp(-gray_optics_sw(atm)[:, day].double().sum().item() / mu0[day])
            bl_rel = abs(f_sw.flux_dn_dir[0, day].item() - exact) / exact
            require(bl_rel < 1e-3, f"gray: direct beam vs Beer-Lambert {bl_rel:.3e}")
            phase("gray", f"RRTMGPSolver(GrayRadiation()) {str(dtype)[6:]} LW {'two-stream' if two_stream_lw else 'no-scattering'} "
                          f"+ SW {'two-stream' if two_stream_sw else 'direct beam'} at {NCOL} x {NLAY}: update_fluxes() "
                          f"median {ms:.3f} ms over {STEPS} steps (min {lo:.3f}, max {hi:.3f}), peak memory "
                          f"{peak:.2f} GB, kernel launches {launches or 'none (plain torch)'}; oracles: LW TOA down 0, "
                          f"surface up vs sigma T^4 rel {lw_rel:.2e}, night columns 0, direct beam vs Beer-Lambert "
                          f"rel {bl_rel:.2e}")
        del atm, solver, f_lw, f_sw
        torch.cuda.empty_cache()

    atm = setup_gray_as_pr_grid(NLAY, np.linspace(-90.0, 90.0, GRAY_EQ_NCOL), GRAY_P0, GRAY_PE,
                                GrayOpticalThicknessSchneider2004(), P, dtype=torch.float64, device=DEVICE)
    emis = torch.ones(GRAY_EQ_NCOL, dtype=torch.float64, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, T_ex, err, n = gray_lw_equilibrium(atm, emis, P)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = int(n)
    t_error = (T_ex - out.t_lev).abs().max().item()
    phase("gray", f"gray_lw_equilibrium f64 at {GRAY_EQ_NCOL} x {NLAY}: {n} steps in {seconds:.1f} s "
                  f"({1e3 * seconds / max(n, 1):.3f} ms a step, blocks of 64 steps as CUDA graphs), flux-gradient "
                  f"error {err.item():.3e}, max |T_ex - t_lev| {t_error:.4f} K (gate {GRAY_EQ_GATE_K} K)"
                  + (" - more than 90 s" if seconds > 90 else ""))
    require(t_error < GRAY_EQ_GATE_K, f"gray equilibrium: {t_error:.4f} K off the analytic profile")


# ---------------------------------------------------------------------------
# The column split: a mesh of two entries on one card, a world of two processes
# ---------------------------------------------------------------------------

MESH_CLEAR_WANT = {"planck_band": 2, "lw_clear_mega": 2, "sw_clear_mega": 2}
MESH_ALLSKY_WANT = {"planck_band": 2, "lw2_mega": 2, "sw_clear_mega": 2, "aerosol_bands": 4, "cloud_bands": 4}
MESH_WORLD_TIMEOUT_S = 300      # each process of a world: start, lookups, one warm-up and 3 steps


def split_equal(whole, split) -> bool:
    """A tensor of the unsplit solver against a ColumnSharded one of the
    mesh solver, slice by slice on the card: bitwise equal."""
    import torch

    per = split.ncol // len(split.mesh)
    return all(torch.equal(whole[..., o:o + per], s) for o, s in zip(split.offsets, split.shards))


def count_syncs(fn) -> int:
    """The calls of ``fn()`` that synchronise the host with the card
    (``torch.cuda.set_sync_debug_mode``: a stream or device synchronisation,
    a blocking copy such as a host list copied to the card, ``.item()``)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing" in str(w.message) for w in caught)


def phase_mesh(L, atm, bcs_lw, bcs_sw, method, two_stream_lw, tag, want):
    """RRTMGPSolver(method, mesh=make_column_mesh([cuda:0, cuda:0])) against
    the unsplit solver on the same inputs: the launches of one mesh step
    (each kernel once per entry), assert_compiles_once over a second mesh
    step, no host synchronisation in a step of either solver (the entries
    launch one after another from one thread: a synchronisation would
    serialise entries on separate cards), update_fluxes() bitwise (fluxes
    and, all-sky, cloud cover), and both steps' medians timed in turns. Returns (launch counts of the mesh
    step, the unsplit solver's fluxes)."""
    import torch

    from rrtmgp_tpu_torch import RRTMGPGridParams, RRTMGPParameters, RRTMGPSolver
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.parallel.sharding import make_column_mesh
    from rrtmgp_tpu_torch.utils import debug

    ncol = atm.ncol
    grid = RRTMGPGridParams(nlay=NLAY, ncol=ncol)
    mesh = make_column_mesh([DEVICE, DEVICE])
    mk = lambda **kw: RRTMGPSolver(grid, method, RRTMGPParameters(), bcs_lw, bcs_sw, atm, lookups=L,
                                   two_stream_lw=two_stream_lw, **kw)
    whole, split = mk(), mk(mesh=mesh)
    for s in (whole, split):
        s.advance_step(5)
    f_whole = whole.update_fluxes()
    torch.cuda.synchronize()
    mega.reset_launch_counts()
    f_split = split.update_fluxes()
    torch.cuda.synchronize()
    launches = {k: n for k, n in mega.launch_counts().items() if n}
    phase(tag, f"mesh {[str(e.device) for e in mesh]}, {ncol // 2} columns an entry; launches of one mesh step: "
               f"{launches}")
    require(launches == want, f"launches of one mesh step {launches}, expected {want}")
    with debug.assert_compiles_once() as log:
        split.update_fluxes()
    require(not log, f"a second mesh step compiled {log}")
    torch.cuda.synchronize()
    control = count_syncs(lambda: torch.tensor([0, 1], device=DEVICE))
    syncs = {name: count_syncs(s.update_fluxes) for name, s in (("unsplit", whole), ("mesh", split))}
    torch.cuda.synchronize()
    phase(tag, f"synchronising calls in a step: {syncs} (a list copied to the card, the detector's check: "
               f"{control})")
    require(control > 0, "the synchronisation detector missed a blocking copy to the card")
    require(not any(syncs.values()), f"a step synchronised the host with the card: {syncs}")
    for wave, (a, b) in (("LW", (f_whole[0], f_split[0])), ("SW", (f_whole[1], f_split[1]))):
        for name in a._fields:
            require(split_equal(getattr(a, name), getattr(b, name)), f"{wave} {name}: mesh != unsplit")
    cover = ""
    if whole.lw_cloud_cover() is not None:
        for name in ("lw_cloud_cover", "sw_cloud_cover"):
            require(split_equal(getattr(whole, name)(), getattr(split, name)()), f"{name}: mesh != unsplit")
        mean = whole.lw_cloud_cover().mean().item()
        require(0.0 < mean < 1.0, f"mean cloud cover {mean}: the clouds were not drawn")
        cover = f", cloud cover bitwise (mean LW {mean:.4f})"
    phase(tag, f"update_fluxes() on the mesh equals the unsplit solver bitwise (every flux{cover}); "
               "assert_compiles_once: a second mesh step compiled nothing")
    times = {"unsplit": [], "mesh": []}
    for i in range(STEPS):
        for name, s in ((("unsplit", whole), ("mesh", split)) if i % 2 == 0 else (("mesh", split), ("unsplit", whole))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.update_fluxes()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in times.items()}
    phase(tag, f"update_fluxes() at {ncol} x {NLAY}, in turns over {STEPS} steps each: unsplit median "
               f"{med['unsplit']:.3f} ms (min {min(times['unsplit']):.3f}, max {max(times['unsplit']):.3f}), "
               f"mesh of 2 on one card {med['mesh']:.3f} ms (min {min(times['mesh']):.3f}, "
               f"max {max(times['mesh']):.3f}), mesh / unsplit {med['mesh'] / med['unsplit']:.3f}")
    fluxes = tuple(f.clone() for f in (*whole.flux_lw, *whole.flux_sw))
    return launches, fluxes


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh_world(whole, world: int = 2) -> None:
    """A world of ``world`` processes of this script, joined by gloo on a
    free localhost port (``mesh_worker``), rank r on card r modulo the
    cards there are (all on the one card here): each builds its share of
    the clear 32768 x 60 state and runs globalize -> RRTMGPSolver(mesh=
    global_column_mesh()) -> local_values. Every share must equal ``whole``
    (the unsplit clear solver's LW then SW fluxes) bitwise; a process that
    fails or outlives its time limit fails the run."""
    import shutil
    import tempfile

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="rrtmgp_mesh_world_")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker", str(rank), str(world),
                               str(port), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
    outs = []
    try:
        for p in procs:
            left = max(MESH_WORLD_TIMEOUT_S - (time.perf_counter() - t0), 1.0)
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired as e:
                raise AssertionError(f"a process of the world of {world} outlived {MESH_WORLD_TIMEOUT_S} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-12:]:
            phase("mesh-world", f"rank {rank}: {line}")
        require(p.returncode == 0, f"rank {rank} of the world of {world} exited with {p.returncode}")
    names = [f"lw_{n}" for n in ("flux_up", "flux_dn", "flux_net")]
    names += [f"sw_{n}" for n in ("flux_up", "flux_dn", "flux_dn_dir", "flux_net")]
    ranges = []
    for rank in range(world):
        got = np.load(os.path.join(tmp, f"rank{rank}.npz"))
        lo, hi = int(got["lo"]), int(got["hi"])
        ranges.append((lo, hi))
        for name, ref in zip(names, whole):
            require(np.array_equal(got[name], ref[:, lo:hi].cpu().numpy()), f"rank {rank} {name} != the whole")
    shutil.rmtree(tmp)
    share = NCOL // world
    require(ranges == [(r * share, (r + 1) * share) for r in range(world)], f"column ranges {ranges}")
    cards = ", ".join(sorted(set(worlds_devices(world))))
    phase("mesh-world", f"world of {world} (gloo) on {cards}: columns {ranges}, every share bitwise the unsplit "
                        f"solver's fluxes; {seconds:.1f} s from start to the last exit")


def worlds_devices(world: int) -> list[str]:
    """The card of each rank of a world (``phase_mesh_world``)."""
    import torch

    return [f"cuda:{rank % torch.cuda.device_count()}" for rank in range(world)]


def mesh_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """One process of a world (``phase_mesh_world``)."""
    import numpy as np
    import torch

    from rrtmgp_tpu_torch import (
        ClearSkyRadiation,
        LookupBundle,
        RRTMGPGridParams,
        RRTMGPParameters,
        RRTMGPSolver,
    )
    from rrtmgp_tpu_torch.parallel import distributed as dist
    from rrtmgp_tpu_torch.states import slice_columns

    t0 = time.perf_counter()
    card = torch.device(worlds_devices(world)[rank])
    torch.cuda.set_device(card)
    dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank, local_device_ids=[card.index])
    mesh = dist.global_column_mesh()
    require([e.process for e in mesh] == list(range(world)), f"mesh {mesh}")
    lo, hi = dist.process_column_range(NCOL, mesh)
    lw, sw = lookups(256, 16, 224, 14)
    # the host model's columns: this process keeps [lo, hi) of the state
    atm = atmosphere(NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, NCOL)
    local = [slice_columns(t, lo, hi, NCOL) for t in (atm, bcs_lw, bcs_sw)]
    del atm, bcs_lw, bcs_sw
    g_atm, g_bl, g_bs = (dist.globalize(t, mesh, NCOL) for t in local)
    solver = RRTMGPSolver(RRTMGPGridParams(nlay=NLAY, ncol=NCOL), ClearSkyRadiation(), RRTMGPParameters(),
                          g_bl, g_bs, g_atm, lookups=LookupBundle(lookup_lw=lw, lookup_sw=sw), mesh=mesh,
                          two_stream_lw=False)
    solver.update_fluxes()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        f_lw, f_sw = solver.update_fluxes()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t1))
    got = dist.local_values((f_lw, f_sw))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), lo=lo, hi=hi,
             **{f"lw_{k}": v for k, v in got[0]._asdict().items()},
             **{f"sw_{k}": v for k, v in got[1]._asdict().items()})
    print(f"columns [{lo}, {hi}) on {mesh[rank].device}: setup {setup:.1f} s (start, gloo, lookups, state, "
          f"first step), update_fluxes() median {statistics.median(times):.3f} ms over 3 steps "
          f"({world} processes, {torch.cuda.device_count()} card(s))", flush=True)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Routes: the solver's option matrix as impl=None routes it
# ---------------------------------------------------------------------------

ROUTES_NCOL = 1024
ROUTE_METHODS = {  # name: (radiation method class, aerosols)
    "clear": ("ClearSkyRadiation", False), "clear+aerosols": ("ClearSkyRadiation", True),
    "all-sky": ("AllSkyRadiation", False), "all-sky+aerosols": ("AllSkyRadiation", True),
    "all-sky+clear diagnostics": ("AllSkyRadiationWithClearSkyDiagnostics", False),
    "all-sky+clear diagnostics+aerosols": ("AllSkyRadiationWithClearSkyDiagnostics", True),
}
#: the options of RRTMGPSolver the covering set walks, each with its values
ROUTE_FACTORS = (
    ("method", tuple(ROUTE_METHODS)),
    ("f64_kernel", (None, False, True)),
    ("dtype", ("float32", "float64")),
    ("two_stream_lw", (True, False)),
    ("n_gauss_angles", (1, 3)),
    ("two_stream_sw", (True, False)),
    ("fused_optics", (True, False)),
    ("metric_scaling", (False, True)),
    ("mesh", (False, True)),
    ("isothermal_boundary_layer", (False, True)),
)
#: configurations the covering set starts from, the other options chosen
#: as for the rest: the f64 kernel (K7) without the fused optics at 1 angle
#: and, on a mesh, for the clear-sky diagnostics at 3 angles (the cloudy
#: solve on the torch path), f64_kernel=False without the fused optics, f32
#: LW two-stream all-sky without them and f32 LW at 3 angles with them (the
#: two-kernel path)
ROUTE_SEEDS = (
    dict(method="clear", dtype="float64", f64_kernel=None, two_stream_lw=False, n_gauss_angles=1,
         fused_optics=False),
    dict(method="all-sky+clear diagnostics", dtype="float64", f64_kernel=True, two_stream_lw=False,
         n_gauss_angles=3, fused_optics=False, mesh=True),
    dict(method="clear", dtype="float64", f64_kernel=False, two_stream_lw=False, fused_optics=False),
    dict(method="all-sky+aerosols", dtype="float32", two_stream_lw=True, fused_optics=False),
    dict(method="all-sky+aerosols", dtype="float32", two_stream_lw=False, n_gauss_angles=3, fused_optics=True),
)
#: (method, two_stream_lw, n_gauss_angles, two_stream_sw) of the f64 solver
#: with fused_optics=False against the fused one, unsplit and on a mesh
F64_UNFUSED_CASES = (
    ("clear", False, 1, True),
    ("all-sky+aerosols", True, 1, True),
    ("clear", False, 3, False),
    ("all-sky+aerosols", False, 3, False),
)
ROUTE_AOD_TOL = 1e-6


def pairwise_configs(factors=ROUTE_FACTORS, seeds=ROUTE_SEEDS) -> list[dict]:
    """A covering set of the factors' values: every value of each factor
    meets every value of each other factor in some configuration. Greedy
    and deterministic: the seeds come first, then each configuration starts
    from the first pair not yet covered; each option a configuration does
    not fix takes the value that covers the most pairs not yet covered with
    the values already chosen (on a tie the values take turns from one
    configuration to the next)."""
    import itertools

    n = len(factors)
    names = [name for name, _ in factors]
    sizes = [len(values) for _, values in factors]
    todo = {(i, a, j, b) for i, j in itertools.combinations(range(n), 2)
            for a in range(sizes[i]) for b in range(sizes[j])}
    key = lambda i, a, j, b: (i, a, j, b) if i < j else (j, b, i, a)
    starts = [{names.index(k): factors[names.index(k)][1].index(v) for k, v in seed.items()} for seed in seeds]
    rows = []
    while todo:
        if len(rows) < len(starts):
            row = dict(starts[len(rows)])
        else:
            i, a, j, b = min(todo)
            row = {i: a, j: b}
        for k in range(n):
            if k not in row:
                row[k] = max(range(sizes[k]), key=lambda v: (
                    sum(key(k, v, m, w) in todo for m, w in row.items()), -((v - len(rows) - k) % sizes[k])))
        todo -= {key(i, row[i], j, row[j]) for i, j in itertools.combinations(range(n), 2)}
        rows.append({factors[k][0]: factors[k][1][row[k]] for k in range(n)})
    return rows


def route_solves(cfg: dict) -> list[bool]:
    """The solves of one update_lw_fluxes() (or update_sw_fluxes()) of the
    configuration, in order, by whether each is cloudy: the clear-sky
    diagnostics' solve comes first."""
    method = cfg["method"]
    if "diagnostics" in method:
        return [False, True]
    return [method.startswith("all-sky")]


def route_of(cfg: dict, wave: str, cloudy: bool) -> str:
    """The route that impl=None takes for the solve, as the JAX package
    dispatches it (tests/test_torch_routes.py holds the same table on the
    CPU): f32 the megakernels, or the two-kernel path for several LW angles,
    for the SW direct beam and for every solve without the fused optics
    (pallas_windowed="off"); f64, whatever fused_optics says, the f64
    kernels for clear-sky LW no-scattering and SW two-stream without
    aerosols unless f64_kernel=False, the torch path otherwise."""
    aerosols = ROUTE_METHODS[cfg["method"]][1]
    two_stream = cfg["two_stream_lw"] if wave == "lw" else cfg["two_stream_sw"]
    if cfg["dtype"] == "float64":
        has_kernel = (two_stream if wave == "sw" else not two_stream) and not cloudy and not aerosols
        return "kernel" if has_kernel and cfg["f64_kernel"] is not False else "torch"
    mega_covers = two_stream or (wave == "lw" and cfg["n_gauss_angles"] == 1)
    return "kernel" if cfg["fused_optics"] and mega_covers else "two_kernel"


def solve_launches(cfg: dict, wave: str, cloudy: bool) -> dict:
    """Kernel launches of one solve of the configuration on one mesh entry."""
    import collections

    route, n = route_of(cfg, wave, cloudy), collections.Counter()
    two_stream = cfg["two_stream_lw"] if wave == "lw" else cfg["two_stream_sw"]
    if route == "torch":
        return n
    if route == "kernel" and cloudy:
        n["cloud_bands"] += 1
    if route == "kernel" and wave == "lw":
        n["planck_band"] += 1
        n["lw2_mega" if two_stream else "lw_clear_mega"] += 1 if two_stream else cfg["n_gauss_angles"]
    elif route == "kernel":
        n["sw_clear_mega"] += 1
    else:
        if cfg["fused_optics"]:
            n["optics_fused"] += 1
        else:
            n["interp_pt_eta"] += 2
            n["interp_minor"] += 1
        if wave == "lw":
            n["planck_band_rows"] += 1
            n["lw_2stream_reduced" if two_stream else "lw_noscat_banded_reduced"] += 1
        elif two_stream:
            n["sw_2stream_reduced"] += 1
        if cloudy:
            n["mcica_mask_export"] += 1
    if ROUTE_METHODS[cfg["method"]][1]:
        n["aerosol_bands"] += 1
    return n


def route_launches(cfg: dict) -> dict:
    """Kernel launches of one update_fluxes() of the configuration."""
    import collections

    total = collections.Counter()
    for wave in ("lw", "sw"):
        for cloudy in route_solves(cfg):
            for name, k in solve_launches(cfg, wave, cloudy).items():
                total[name] += k * (2 if cfg["mesh"] else 1)
    return dict(total)


def route_tol(cfg: dict, wave: str, cloudy: bool) -> tuple[float, bool]:
    """(tolerance, absolute) of a solve's fluxes against impl="torch": the
    earlier phases' TOL of the route's kernel relative to the largest
    flux; the f64 LW kernel within F64_LW_TOL_WM2 W/m2; the torch path bit
    for bit."""
    route = route_of(cfg, wave, cloudy)
    two_stream = cfg["two_stream_lw"] if wave == "lw" else cfg["two_stream_sw"]
    if route == "torch":
        return 0.0, False
    if cfg["dtype"] == "float64":
        return (F64_LW_TOL_WM2, True) if wave == "lw" else (TOL["sw_clear_mega_f64"], False)
    if route == "kernel":
        name = {"lw": "lw2_mega" if two_stream else "lw_clear_mega", "sw": "sw_clear_mega"}[wave]
    else:
        name = {"lw": "lw_2stream_reduced" if two_stream else "lw_noscat_banded_reduced",
                "sw": "sw_2stream_reduced"}[wave]
    return TOL[name], False


def whole(x):
    """A tensor of the unsplit solver, or a ColumnSharded one put together."""
    import torch

    if x is None or isinstance(x, torch.Tensor):
        return x
    require(list(x.offsets) == sorted(x.offsets), f"mesh entries out of order: {x.offsets}")
    return torch.cat([s.to(DEVICE) for s in x.shards], dim=x.axis)


def route_inputs(dtype: str, lookups, ncol: int, nlay: int):
    """The all-sky inputs of the route phase in ``dtype``: ``lookups``, the
    cloudy, aerosol-laden atmosphere with fractional cloud, the boundary
    conditions and a metric scaling that varies by level and column."""
    import torch

    atm = allsky_atmosphere(ncol, nlay, dtype)
    bcs_lw, bcs_sw = boundary_conditions(lookups.lookup_lw, lookups.lookup_sw, ncol)
    dt = getattr(torch, dtype)
    scale = (torch.linspace(0.95, 1.05, nlay + 1, dtype=dt, device=DEVICE)[:, None]
             * torch.linspace(0.99, 1.01, ncol, dtype=dt, device=DEVICE)[None, :])
    return lookups, atm, bcs_lw, bcs_sw, scale


def route_solver(cfg: dict, inputs, **override):
    """RRTMGPSolver of the configuration on ``inputs`` (``route_inputs``);
    ``override`` replaces its keyword arguments."""
    import rrtmgp_tpu_torch as rt
    from rrtmgp_tpu_torch.parallel.sharding import make_column_mesh

    lookups, atm, bcs_lw, bcs_sw, scale = inputs
    name, aerosols = ROUTE_METHODS[cfg["method"]]
    grid = rt.RRTMGPGridParams(nlay=atm.nlay, ncol=atm.ncol, dtype=atm.p_lay.dtype,
                               isothermal_boundary_layer=cfg["isothermal_boundary_layer"])
    kw = dict(two_stream_lw=cfg["two_stream_lw"], n_gauss_angles=cfg["n_gauss_angles"],
              two_stream_sw=cfg["two_stream_sw"], fused_optics=cfg["fused_optics"], f64_kernel=cfg["f64_kernel"],
              metric_scaling=scale if cfg["metric_scaling"] else None,
              mesh=make_column_mesh([DEVICE, DEVICE]) if cfg["mesh"] else None)
    kw.update(override)
    return rt.RRTMGPSolver(grid, getattr(rt, name)(aerosol_radiation=aerosols), rt.RRTMGPParameters(),
                           bcs_lw, bcs_sw, atm, lookups=lookups, **kw)


def route_outputs(solver) -> dict:
    """Every flux and diagnostic of the solver's last update_fluxes(), by
    wave and kind, each a tuple of tensors put together from the mesh
    entries, or None where the solver has none."""
    tensors = lambda fields: None if fields is None or fields[0] is None else tuple(whole(f) for f in fields)
    out = {}
    for wave in ("lw", "sw"):
        out[wave, "flux"] = tensors(getattr(solver, f"flux_{wave}"))
        out[wave, "clear flux"] = tensors(getattr(solver, f"clear_flux_{wave}"))
        out[wave, "cover"] = tensors((getattr(solver, f"{wave}_cloud_cover")(),))
    out["sw", "aod"] = tensors((solver.aod_sw_extinction(), solver.aod_sw_scattering()))
    return out


def same_outputs(out: dict, ref: dict) -> bool:
    """Two solvers' ``route_outputs``, bit for bit."""
    import torch

    return all((out[k] is None and ref[k] is None) or (
        out[k] is not None and ref[k] is not None and all(map(torch.equal, out[k], ref[k]))) for k in out)


def route_errors(cfg: dict, out: dict, ref: dict) -> tuple[list[str], list[str]]:
    """The configuration's outputs against impl="torch"'s: (what is off:
    each flux beyond its route's tolerance, cloud cover not bitwise, AOD
    beyond ROUTE_AOD_TOL; each flux's error and tolerance)."""
    import torch

    wrong, readings = [], []
    all_sky = route_solves(cfg)[-1]
    for wave in ("lw", "sw"):
        for kind, cloudy in (("clear flux", False), ("flux", all_sky)):
            a, b = out[wave, kind], ref[wave, kind]
            if (a is None) != (b is None):
                wrong.append(f"{wave} {kind}: present in one solver only")
            if a is None or b is None:
                continue
            tol, absolute = route_tol(cfg, wave, cloudy)
            err, rel = rel_err(a, b)
            if tol == 0.0:
                readings.append(f"{wave} {kind} bitwise {all(map(torch.equal, a, b))}")
            else:
                readings.append(f"{wave} {kind} {err:.2e} W/m2 (tol {tol:.0e} W/m2)" if absolute
                                else f"{wave} {kind} rel {rel:.2e} (tol {tol:.0e})")
            if (err if absolute else rel) > tol or (tol == 0.0 and not all(map(torch.equal, a, b))):
                wrong.append(f"{wave} {kind}: max|d|={err:.3e} rel={rel:.3e} (tol {tol:.0e}"
                             f"{' W/m2' if absolute else ''})")
        a, b = out[wave, "cover"], ref[wave, "cover"]
        if (a is None) != (b is None) or (a is not None and not torch.equal(a[0], b[0])):
            wrong.append(f"{wave} cloud cover differs from the torch path's")
    a, b = out["sw", "aod"], ref["sw", "aod"]
    if (a is None) != (b is None) or (a is not None and rel_err(a, b)[1] > ROUTE_AOD_TOL):
        wrong.append("SW AOD differs from the torch path's")
    return wrong, readings


def run_route_config(cfg: dict, inputs) -> dict:
    """One update_fluxes() of the configuration with impl=None and one with
    impl="torch" (unsplit, fused optics: the torch path has no
    materialized-optics kernel); their launches, the step's milliseconds and
    its errors against impl="torch" and what is off (``route_errors``)."""
    import warnings

    import torch

    from rrtmgp_tpu_torch.ops import mega

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the f64 torch path's warning, by design
        solver = route_solver(cfg, inputs)
        torch.cuda.synchronize()
        mega.reset_launch_counts()
        t0 = time.perf_counter()
        solver.update_fluxes()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = {k: n for k, n in mega.launch_counts().items() if n}
        out = route_outputs(solver)
        ref = route_solver(cfg, inputs, impl="torch", fused_optics=True, mesh=None)
        ref.update_fluxes()
        wrong, readings = route_errors(cfg, out, route_outputs(ref))
    nlay = whole(solver.temperature()).shape[0]
    if nlay != inputs[1].nlay - cfg["isothermal_boundary_layer"]:
        wrong.append(f"temperature() has {nlay} layers with isothermal_boundary_layer="
                     f"{cfg['isothermal_boundary_layer']}")
    return dict(launches=launches, ms=ms, wrong=wrong, readings=readings)


def f64_unfused_case(inputs, method, two_stream_lw, n_angles, two_stream_sw) -> dict:
    """The f64 solver with fused_optics=False against the fused one and on
    a two-entry mesh: LW launches of one update_lw_fluxes(), launches of an
    update_fluxes() (unsplit and mesh), whether every output is bitwise the
    fused solver's and the mesh's the unsplit's, and both steps' medians
    over 3 steps in turns."""
    import warnings

    import torch

    from rrtmgp_tpu_torch.ops import mega

    cfg = dict(method=method, f64_kernel=None, dtype="float64", two_stream_lw=two_stream_lw,
               n_gauss_angles=n_angles, two_stream_sw=two_stream_sw, fused_optics=False, metric_scaling=False,
               mesh=False, isothermal_boundary_layer=False)
    counts = lambda: {k: n for k, n in mega.launch_counts().items() if n}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the f64 torch path's warning, by design
        unfused, fused = route_solver(cfg, inputs), route_solver(cfg, inputs, fused_optics=True)
        split = route_solver({**cfg, "mesh": True}, inputs)
        mega.reset_launch_counts()
        unfused.update_lw_fluxes()
        lw_launches = counts()
        unfused.update_sw_fluxes()
        fused.update_fluxes()
        mega.reset_launch_counts()
        split.update_fluxes()
        mesh_launches = counts()
        a, b, c = route_outputs(unfused), route_outputs(fused), route_outputs(split)
        times = {"unfused": [], "fused": []}
        for i in range(3):
            for name, s in ((("unfused", unfused), ("fused", fused)) if i % 2 == 0
                            else (("fused", fused), ("unfused", unfused))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.update_fluxes()
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
    return dict(cfg=cfg, lw_launches=lw_launches, mesh_launches=mesh_launches,
                fused_equal=same_outputs(a, b), mesh_equal=same_outputs(a, c),
                ms={k: statistics.median(v) for k, v in times.items()})


def phase_routes(lookups32, lookups64, ncol: int = ROUTES_NCOL, nlay: int = NLAY) -> None:
    """(a) The f64 solver with fused_optics=False at ``ncol`` x ``nlay``:
    the same routes as the fused f64 solver (F64_UNFUSED_CASES), bitwise
    its fluxes, also on a mesh of two entries on the card, with exactly one
    lw_clear_mega launch (the f64 build, K7) per angle and one planck_band
    per LW solve where f64 has a kernel, and no launch otherwise; (b) the
    covering set of the option matrix (pairwise_configs) through
    RRTMGPSolver with impl=None: no refusal, the launches of the route
    table (route_launches), every output within its route's tolerance of
    impl="torch"."""
    t0 = time.perf_counter()
    inputs = {"float32": route_inputs("float32", lookups32, ncol, nlay),
              "float64": route_inputs("float64", lookups64, ncol, nlay)}
    for method, two_stream_lw, n_angles, two_stream_sw in F64_UNFUSED_CASES:
        r = f64_unfused_case(inputs["float64"], method, two_stream_lw, n_angles, two_stream_sw)
        cfg = r["cfg"]
        want_lw = dict(solve_launches(cfg, "lw", route_solves(cfg)[-1]))
        want_mesh = route_launches({**cfg, "mesh": True})
        what = (f"f64 fused_optics=False {method}, LW {'two-stream' if two_stream_lw else f'{n_angles} angle(s)'}, "
                f"SW {'two-stream' if two_stream_sw else 'direct beam'}")
        phase("routes", f"(a) {what} at {ncol} x {nlay}: LW route {route_of(cfg, 'lw', method != 'clear')}, "
                        f"launches of update_lw_fluxes() {r['lw_launches']}, of a mesh step {r['mesh_launches']}; "
                        f"bitwise the fused solver: {r['fused_equal']}, mesh bitwise unsplit: {r['mesh_equal']}; "
                        f"step median unfused {r['ms']['unfused']:.3f} ms, fused {r['ms']['fused']:.3f} ms "
                        f"(unfused / fused {r['ms']['unfused'] / r['ms']['fused']:.3f})")
        require(r["lw_launches"] == want_lw, f"(a) {what}: LW launches {r['lw_launches']}, expected {want_lw}")
        require(r["mesh_launches"] == want_mesh, f"(a) {what}: mesh launches {r['mesh_launches']}, "
                                                 f"expected {want_mesh}")
        require(r["fused_equal"], f"(a) {what}: not bitwise the fused f64 solver")
        require(r["mesh_equal"], f"(a) {what}: the mesh is not bitwise the unsplit solver")
    configs = pairwise_configs()
    phase("routes", f"(b) a covering set of {len(configs)} configurations of {len(ROUTE_FACTORS)} options "
                    f"(every pair of two options' values in one of them) at {ncol} x {nlay}")
    off = []
    for i, cfg in enumerate(configs):
        r = run_route_config(cfg, inputs[cfg["dtype"]])
        want = route_launches(cfg)
        routes = {w: [route_of(cfg, w, c) for c in route_solves(cfg)] for w in ("lw", "sw")}
        wrong = r["wrong"] + ([f"launches {r['launches']}, expected {want}"] if r["launches"] != want else [])
        phase("routes", f"(b) {i + 1:2d} {cfg}: routes {routes}, launches {r['launches']}, "
                        f"{r['ms']:.1f} ms; vs impl='torch': {', '.join(r['readings'])}; "
                        f"{'ok' if not wrong else 'OFF: ' + '; '.join(wrong)}")
        off += [f"config {i + 1}: {w}" for w in wrong]
    require(not off, "routes: " + "; ".join(off))
    phase("routes", f"routes phase wall time {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Loading rrtmgp-data files: a fabricated v1.9 checkout
# ---------------------------------------------------------------------------

DATA_NSITE, DATA_NEXPT = 100, 2   # the RFMIP input's sites and experiments (experiment 0 is loaded)
DATA_ALLSKY_COLS = 4              # columns of the all-sky example file
DATA_CLDFRAC = 0.7                # the all-sky reader's cloud fraction: McICA draws matter
DATA_TABLE_TOL = 1e-12            # a loaded table against the one written, of its largest entry
#: variables written with their axes reversed (the loader orients by dimension name)
DATA_REVERSED = ("kmajor", "kminor_upper", "totplnk", "rayl_upper", "key_species", "vmr_ref", "extice",
                 "aero_salt_tbl", "aero_dust_tbl")
DATA_KERNELS = {"clear": ("planck_band", "lw_clear_mega", "sw_clear_mega"),
                "all-sky": ("planck_band", "lw2_mega", "sw_clear_mega", "aerosol_bands", "cloud_bands")}


def fabricate():
    """The fabricated-checkout writer (scripts/fabricate_rrtmgp_data.py)."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import fabricate_rrtmgp_data

    return fabricate_rrtmgp_data


def write_fake_checkout(root: str) -> dict:
    """An rrtmgp-data v1.9 checkout under ``root``: the six lookup files from
    the port's full-width synthetic lookups (f64) with the loader's hard
    cases added, an RFMIP input (100 sites x 60 layers, 2 experiments, a
    night site) from the synthetic atmosphere and an all-sky example (60
    layers, 4 columns) with aerosols. Returns what was written: the
    lookups' numpy specs, the RFMIP and all-sky truths, the paths."""
    import math

    import numpy as np

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.data.synthetic import GAS_NAMES, synthetic_atmosphere

    fab = fabricate()
    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), device="cpu")
    specs = {}
    for band_set in ("lw", "sw"):
        lkp = getattr(L, f"lookup_{band_set}")
        specs[f"gas_{band_set}"] = fab.with_hard_cases(*fab.lookup_numpy(lkp, fab.GAS_ARRAYS, fab.GAS_META))
        specs[f"cloud_{band_set}"] = fab.lookup_numpy(getattr(L, f"lookup_{band_set}_cld"), fab.CLOUD_ARRAYS,
                                                      fab.CLOUD_META)
        arrays, meta = fab.lookup_numpy(getattr(L, f"lookup_{band_set}_aero"), fab.AEROSOL_ARRAYS, fab.AEROSOL_META)
        arrays["bnd_lims_wn"] = fab.aerosol_band_limits(arrays["dust"].shape[-1])  # 550 nm in band 1
        specs[f"aerosol_{band_set}"] = (arrays, meta)
    paths = fab.write_checkout(root, specs, reverse=DATA_REVERSED)

    p_top = specs["gas_lw"][1]["p_ref_min"]  # the reader clamps the TOA level to it
    atm = synthetic_atmosphere(ncol=DATA_NSITE, nlay=NLAY, p_top=p_top, device="cpu")
    rfmip = {k: getattr(atm, k).numpy() for k in ("p_lev", "p_lay", "t_lev", "t_lay", "t_sfc")}
    rfmip.update(vmr_h2o=atm.vmr.vmr_h2o.numpy(), vmr_o3=atm.vmr.vmr_o3.numpy())
    zenith = np.full(DATA_NSITE, math.degrees(math.acos(0.6)))
    zenith[3] = 120.0  # a night site
    gm = {fab.GM_VARS[g]: float(atm.vmr.vmr[i + 1]) for i, g in enumerate(GAS_NAMES) if g in fab.GM_VARS}
    rfmip.update(sfc_emis=np.full(DATA_NSITE, 0.98), sfc_alb=np.full(DATA_NSITE, 0.2), zenith=zenith,
                 tsi=np.full(DATA_NSITE, 1361.0), vmr_gm=atm.vmr.vmr.numpy())
    paths["rfmip"] = os.path.join(root, fab.RFMIP_FILE)
    fab.write_rfmip_file(paths["rfmip"], rfmip, gm, rfmip["sfc_emis"], rfmip["sfc_alb"], zenith, rfmip["tsi"],
                         nexpt=DATA_NEXPT)

    col = synthetic_atmosphere(ncol=DATA_ALLSKY_COLS, nlay=NLAY, p_top=p_top, seed=11, device="cpu")
    allsky = {k: getattr(col, k).numpy() for k in ("p_lev", "p_lay", "t_lev", "t_lay")}
    allsky.update(h2o=col.vmr.vmr_h2o.numpy(), o3=col.vmr.vmr_o3.numpy())
    aero = fab.allsky_aerosols(allsky["p_lay"])
    paths["allsky"] = os.path.join(root, fab.ALLSKY_FILE)
    fab.write_allsky_file(paths["allsky"], allsky, aero)
    return dict(specs=specs, rfmip=rfmip, allsky=allsky, aero=aero, paths=paths, fab=fab)


def check_loaded(name, lkp, spec) -> tuple[float, int]:
    """A lookup loaded from its file against the one written: each table
    within DATA_TABLE_TOL of its largest entry, integer metadata exactly,
    float metadata within DATA_TABLE_TOL; (largest table difference, tables
    bitwise equal)."""
    import numpy as np

    arrays, meta = spec[0], spec[1]
    worst, same = 0.0, 0
    for k, a in arrays.items():
        got = getattr(lkp, k)
        require((a is None) == (got is None), f"data: {name}.{k} present in one of file and memory only")
        if a is None:
            continue
        got = got.double().cpu().numpy()
        require(got.shape == a.shape, f"data: {name}.{k} shape {got.shape} != {a.shape}")
        rel = float(np.abs(got - a).max() / max(np.abs(a).max(), 1e-300))
        require(rel <= DATA_TABLE_TOL, f"data: {name}.{k} differs by {rel:.3e} of its largest entry")
        worst, same = max(worst, rel), same + int(np.array_equal(got, a))
    for k, v in meta.items():
        got = getattr(lkp, k)
        if isinstance(v, float):
            require(abs(got - v) <= DATA_TABLE_TOL * max(abs(v), 1.0), f"data: {name}.{k} {got!r} != {v!r}")
        else:
            require(got == v, f"data: {name}.{k} differs from the lookup written")
    return worst, same


def tile_columns(tree, ncol: int):
    """A state or boundary-condition container of n columns tiled to ``ncol``."""
    import torch

    from rrtmgp_tpu_torch.states import tree_map_columns

    def tile(x):
        idx = torch.arange(ncol, device=x.device) % x.shape[-1]
        return x[..., idx].contiguous()

    return tree_map_columns(tile, lambda x: x, tree)


def memory_state(fields: dict, params, aerosols: bool = False):
    """An AtmosphericState (f32, on the card) from numpy float64 fields,
    its column density and relative humidity computed from them in f32, as
    the readers compute them: the SW fluxes move by ~2e-4 of their largest
    value when the f32 column density moves by an ulp (the two-stream
    coefficients near k * mu0 = 1), more than the kernels' tolerance."""
    import torch

    from rrtmgp_tpu_torch.convert import atmosphere_from_numpy
    from rrtmgp_tpu_torch.states import compute_col_gas, compute_relative_humidity

    t = {k: torch.from_numpy(fields[k]).to(DEVICE, torch.float32) for k in ("p_lev", "p_lay", "t_lay", "vmr_h2o")}
    col_dry = compute_col_gas(t["p_lev"], params, vmr_h2o=t["vmr_h2o"])
    rel_hum = compute_relative_humidity(t["p_lay"], t["t_lay"], t["vmr_h2o"], params) if aerosols else None
    return atmosphere_from_numpy(
        **{k: fields[k] for k in ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "vmr_h2o", "vmr_o3")},
        vmr_gm=fields["vmr_gm"], col_dry=col_dry, rel_hum=rel_hum, cloud_state=fields.get("cloud_state"),
        aerosol_state=fields.get("aerosol_state"), dtype=torch.float32, device=DEVICE)


def data_step(tag, method, bcs_lw, bcs_sw, atm, root, mem_lookups, mem_atm, mem_bcs, two_stream_lw) -> dict:
    """RRTMGPSolver(method, data_dir=root) on the state read from the files:
    the path's kernels launched, the fluxes against impl="torch" on the
    first CMP_NCOL columns and against the same step on the lookups and
    state in memory; its step time by utils.profiling.benchmark. Returns
    the solver, its fluxes and the timing."""
    import torch

    from rrtmgp_tpu_torch import RRTMGPGridParams, RRTMGPParameters, RRTMGPSolver, solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import mega
    from rrtmgp_tpu_torch.states import slice_columns
    from rrtmgp_tpu_torch.utils.profiling import benchmark

    ncol = atm.ncol
    grid = RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=torch.float32)
    t0 = time.perf_counter()
    solver = RRTMGPSolver(grid, method, RRTMGPParameters(), bcs_lw, bcs_sw, atm, data_dir=root,
                          two_stream_lw=two_stream_lw)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mega.reset_launch_counts()
    f_lw, f_sw = solver.update_fluxes()
    torch.cuda.synchronize()
    launched = {k: n for k, n in mega.launch_counts().items() if n}
    for k in DATA_KERNELS[tag]:
        require(launched.get(k, 0) > 0, f"data {tag}: {k} not launched by the step from the files")
    for f in (*f_lw, *f_sw):
        require(torch.isfinite(f).all(), f"data {tag}: non-finite flux")
    require(torch.all(f_lw.flux_dn[-1] == 0.0), f"data {tag}: LW TOA down is not 0")
    phase("data", f"{tag} RRTMGPSolver(data_dir=...) at {ncol} x {NLAY}: lookup_tables from the files "
                  f"{load_s:.3f} s; one update_fluxes() launches {launched}")

    L = solver.lookups
    cloudy = L.lookup_lw_cld is not None
    kw_lw = dict(two_stream=two_stream_lw, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero)
    kw_sw = dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero)
    seeds = (solver._mcica_key(0), solver._mcica_key(1)) if cloudy else (None, None)
    cut = lambda x: slice_columns(x, 0, CMP_NCOL, ncol)
    t_lw, _ = solve_lw(L.lookup_lw, cut(atm), cut(bcs_lw), cld_mask_seed=seeds[0], impl="torch", **kw_lw)
    t_sw, _ = solve_sw(L.lookup_sw, cut(atm), cut(bcs_sw), cld_mask_seed=seeds[1], impl="torch", **kw_sw)
    lw_tol = TOL["lw2_mega" if two_stream_lw else "lw_clear_mega"]
    sw_tol = TOL["sw_clear_mega_allsky" if cloudy else "sw_clear_mega"]
    compare_fluxes("data", f"{tag} LW from the files vs impl='torch' on {CMP_NCOL} columns", f_lw, t_lw, lw_tol,
                   CMP_NCOL)
    compare_fluxes("data", f"{tag} SW from the files vs impl='torch' on {CMP_NCOL} columns", f_sw, t_sw, sw_tol,
                   CMP_NCOL)
    del t_lw, t_sw

    mem = RRTMGPSolver(grid, method, RRTMGPParameters(), *mem_bcs, mem_atm, lookups=mem_lookups,
                       two_stream_lw=two_stream_lw)
    m_lw, m_sw = mem.update_fluxes()
    for name, out, ref, tol in (("LW", f_lw, m_lw, lw_tol), ("SW", f_sw, m_sw, sw_tol)):
        compare_fluxes("data", f"{tag} {name} from the files vs the same step on the lookups and state in memory",
                       out, ref, tol)
    del mem, m_lw, m_sw
    torch.cuda.empty_cache()
    bench = benchmark(solver.update_fluxes, n_iters=STEPS, warmup=1, label=tag)
    phase("data", f"{tag} update_fluxes() from the files at {ncol} x {NLAY}: median "
                  f"{1e3 * bench['median_s']:.3f} ms, min {1e3 * bench['min_s']:.3f} ms over {bench['n_iters']} "
                  f"steps (utils.profiling.benchmark)")
    return dict(solver=solver, flux=(f_lw, f_sw), bench=bench)


def phase_data() -> None:
    """A fabricated rrtmgp-data v1.9 checkout loaded through the public
    entry points: validation, every table against the one written, the
    clear step from the files at 32768 x 60 (K3, K1, K2) and the all-sky one
    with aerosols at 75748 x 60 (K3, K4, K2 all-sky, K5), each against the
    torch path and against the same step in memory; then the utilities on
    the card: benchmark, trace, strict_mode, assert_compiles_once,
    device_memory_stats."""
    import tempfile

    import numpy as np
    import torch

    from rrtmgp_tpu_torch import (
        AllSkyRadiation,
        ClearSkyRadiation,
        LookupBundle,
        LwBCs,
        RRTMGPParameters,
        SwBCs,
    )
    from rrtmgp_tpu_torch.convert import aerosol_lookup_from_numpy, cloud_lookup_from_numpy, gas_lookup_from_numpy
    from rrtmgp_tpu_torch.data import loader
    from rrtmgp_tpu_torch.data.allsky import load_allsky_atmosphere
    from rrtmgp_tpu_torch.data.manifest import validate_rrtmgp_data
    from rrtmgp_tpu_torch.data.rfmip import load_rfmip_atmosphere
    from rrtmgp_tpu_torch.ops.mega import planck_band
    from rrtmgp_tpu_torch.utils import debug, profiling

    P = RRTMGPParameters()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fake = write_fake_checkout(root)
        specs, paths, fab = fake["specs"], fake["paths"], fake["fab"]
        mb = sum(os.path.getsize(p) for p in paths.values()) / 1e6
        phase("data", f"fabricated rrtmgp-data v1.9 checkout ({mb:.1f} MB of NetCDF3, variables {DATA_REVERSED} "
                      f"with their axes reversed) written in {time.perf_counter() - t0:.1f} s")
        report = validate_rrtmgp_data(root)
        require(all(p == [] for p in report.values()) and len(report) == 6, f"data: validation {report}")
        phase("data", f"validate_rrtmgp_data (v1.9 sizes enforced): no problem in {sorted(report)}")

        load = {"gas": loader.load_gas_lookup, "cloud": loader.load_cloud_lookup,
                "aerosol": loader.load_aerosol_lookup}
        for key in fab.FILES:
            t0 = time.perf_counter()
            lkp = load[key.split("_")[0]](paths[key], dtype=torch.float64, device=DEVICE)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            worst, same = check_loaded(key, lkp, specs[key])
            n = sum(a is not None for a in specs[key][0].values())
            phase("data", f"{fab.FILES[key]}: loaded in {seconds:.3f} s (f64, on the card); tables within "
                          f"{worst:.2e} of the ones written ({same} of {n} bitwise), metadata equal")
        gas = {k: loader.load_gas_lookup(paths[f"gas_{k}"], dtype=torch.float32, device=DEVICE) for k in ("lw", "sw")}
        itv = gas["lw"].minor_lower
        require(len(itv) == 7 and itv[3].gas == 0 and (2, 2) in [p[1] for p in gas["lw"].key_species],
                "data: the hard cases did not load as written")
        mem = lambda key, make: make(*specs[key][:2], dtype=torch.float32, device=DEVICE)
        mem_lookups = LookupBundle(
            lookup_lw=mem("gas_lw", gas_lookup_from_numpy), lookup_sw=mem("gas_sw", gas_lookup_from_numpy),
            lookup_lw_cld=mem("cloud_lw", cloud_lookup_from_numpy), lookup_sw_cld=mem("cloud_sw", cloud_lookup_from_numpy),
            lookup_lw_aero=mem("aerosol_lw", aerosol_lookup_from_numpy),
            lookup_sw_aero=mem("aerosol_sw", aerosol_lookup_from_numpy))

        # clear sky: the RFMIP input tiled to the clear cell's width
        t0 = time.perf_counter()
        atm, emis, alb, mu0, toa = load_rfmip_atmosphere(paths["rfmip"], gas["lw"], ncol=NCOL, dtype=torch.float32,
                                                         device=DEVICE)
        torch.cuda.synchronize()
        phase("data", f"load_rfmip_atmosphere: {DATA_NSITE} sites tiled to {NCOL} x {NLAY} in "
                      f"{time.perf_counter() - t0:.3f} s")
        bands = lambda x, nbnd: x[None, :].expand(nbnd, x.shape[0]).contiguous()
        bcs_lw = LwBCs(sfc_emis=bands(emis, 16))
        bcs_sw = SwBCs(cos_zenith=mu0, toa_flux=toa, sfc_alb_direct=bands(alb, 14), sfc_alb_diffuse=bands(alb, 14))
        rf = fake["rfmip"]
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=DEVICE)
        mem_bcs = (tile_columns(LwBCs(sfc_emis=bands(f32(rf["sfc_emis"]), 16)), NCOL),
                   tile_columns(SwBCs(cos_zenith=f32(np.cos(np.deg2rad(rf["zenith"]))), toa_flux=f32(rf["tsi"]),
                                      sfc_alb_direct=bands(f32(rf["sfc_alb"]), 14),
                                      sfc_alb_diffuse=bands(f32(rf["sfc_alb"]), 14)), NCOL))
        mem_atm = tile_columns(memory_state(rf, P), NCOL)
        clear = data_step("clear", ClearSkyRadiation(), bcs_lw, bcs_sw, atm, root, mem_lookups, mem_atm, mem_bcs,
                          two_stream_lw=False)
        del mem_atm, mem_bcs
        solver = clear["solver"]

        # the utilities on the card
        with profiling.trace(os.path.join(root, "trace")) as log_dir:
            solver.update_fluxes()
        with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        for k in ("lw_clear_mega", "sw_clear_mega", "planck_band"):
            require(any(k in n for n in names), f"data: the trace names no {k} kernel")
        phase("data", f"utils.profiling.trace of one clear step: {len(names)} event names, the kernels "
                      f"lw_clear_mega, sw_clear_mega and planck_band among them")
        with debug.strict_mode():
            lw, sw = solver.update_fluxes()
        phase("data", "strict_mode: a clean clear step from the files raises nothing")
        t_bad = atm.t_lay.clone()
        t_bad[30, NCOL // 3] = float("nan")
        solver.as_ = dataclasses.replace(atm, t_lay=t_bad)
        try:
            with debug.strict_mode():
                solver.update_fluxes()
            raise AssertionError("data: strict_mode let a NaN in t_lay through")
        except FloatingPointError as e:
            phase("data", f"strict_mode: a NaN in t_lay on the kernel route raises FloatingPointError ({e})")
        lw_tables = gas["lw"].totplnk.clone()
        lw_tables[:, 3] = float("nan")
        t = atm.t_lev.reshape(-1)
        try:
            with debug.strict_mode():
                planck_band(t, lw_tables, gas["lw"].t_planck_min, gas["lw"].t_planck_delta)
            raise AssertionError("data: strict_mode missed a NaN a kernel wrote")
        except FloatingPointError as e:
            require("kernel" in str(e), f"data: {e}")
            phase("data", f"strict_mode: a NaN the planck_band kernel writes is caught by its wrapper ({e})")
        solver.as_ = dataclasses.replace(atm, t_lay=atm.t_lay + 0.5, t_lev=atm.t_lev + 0.5)
        with debug.assert_compiles_once() as log:
            solver.update_fluxes()
        phase("data", f"assert_compiles_once: a second step on new data of the same shapes compiled nothing "
                      f"({log})")
        del solver, clear, atm, bcs_lw, bcs_sw, lw, sw, t_bad
        torch.cuda.empty_cache()

        # all-sky with aerosols: the all-sky example tiled to the all-sky cell's width
        cld = loader.load_cloud_lookup(paths["cloud_lw"], dtype=torch.float32, device=DEVICE)
        t0 = time.perf_counter()
        atm, ncol_ds = load_allsky_atmosphere(paths["allsky"], gas["lw"], cld, ncol=ALLSKY_NCOL, cldfrac=DATA_CLDFRAC,
                                              dtype=torch.float32, device=DEVICE)
        torch.cuda.synchronize()
        phase("data", f"load_allsky_atmosphere: {ncol_ds} file columns tiled to {ALLSKY_NCOL} x {NLAY} in "
                      f"{time.perf_counter() - t0:.3f} s")
        f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=DEVICE)
        bcs_lw = LwBCs(sfc_emis=f((16, ALLSKY_NCOL), 0.98))
        bcs_sw = SwBCs(cos_zenith=f((ALLSKY_NCOL,), 0.86), toa_flux=f((ALLSKY_NCOL,), float(gas["sw"].solar_src_tot)),
                       sfc_alb_direct=f((14, ALLSKY_NCOL), 0.06), sfc_alb_diffuse=f((14, ALLSKY_NCOL), 0.06))
        r_liq = (float(cld.radliq_lwr) + float(cld.radliq_upr)) / 2
        r_ice = (float(cld.radice_lwr) + float(cld.radice_upr)) / 2
        fields = fab.allsky_expected(fake["allsky"], fake["aero"], r_liq, r_ice, ALLSKY_NCOL, DATA_CLDFRAC)
        vmr_gm = np.zeros(len(gas["lw"].gas_names) + 1)
        for g, v in {"co2": 348e-6, "ch4": 1650e-9, "n2o": 306e-9, "n2": 0.7808, "o2": 0.2095}.items():
            vmr_gm[list(gas["lw"].gas_names).index(g) + 1] = v  # the Fortran example's global means
        mem_atm = memory_state({**fields, "vmr_gm": vmr_gm}, P, aerosols=True)
        allsky = data_step("all-sky", AllSkyRadiation(aerosol_radiation=True), bcs_lw, bcs_sw, atm, root,
                           mem_lookups, mem_atm, (bcs_lw, bcs_sw), two_stream_lw=True)
        del mem_atm, allsky["solver"]
        torch.cuda.empty_cache()
    stats = profiling.device_memory_stats()
    peak = stats["cuda:0"]["allocated_bytes.all.peak"] / 1e9
    phase("data", f"utils.profiling.device_memory_stats: cuda:0 peak allocated {peak:.2f} GB in this process")


def main() -> None:
    import torch

    t_start = time.perf_counter()
    done = lambda what: phase("time", f"{what} done at {time.perf_counter() - t_start:.0f} s")
    phase_device()
    phase_build()
    phase_kernels_small()
    done("small kernels")
    phase_kernels_small(WIDE_NGPT, WIDE_NCOL, WIDE_NLAY)
    phase_kernels_small(LIMIT_NGPT, WIDE_NCOL, WIDE_NLAY)
    done("wide and limit kernels")

    from rrtmgp_tpu_torch import AllSkyRadiation, ClearSkyRadiation, LookupBundle, lookup_tables

    results = {}
    lw, sw = lookups(256, 16, 224, 14)
    atm = atmosphere(NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, NCOL)
    label = f"main ncol={NCOL} nlay={NLAY} ngpt=256/224"
    check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 3, results)
    lw64, sw64 = lookups(256, 16, 224, 14, "float64")
    atm64 = atmosphere(NCOL, NLAY, "float64")
    bcs_lw64, bcs_sw64 = boundary_conditions(lw64, sw64, NCOL)
    check_f64_kernels(label, lw64, sw64, atm64, (bcs_lw64, bcs_sw64), kernel_args(lw, sw, atm, bcs_lw, bcs_sw)[1:],
                      3, results, chunk=F64_TWIN_CHUNK)
    launches, _, f32_lw = phase_clear_slice(lw, sw, atm, bcs_lw, bcs_sw)
    done("main-shape kernels and the clear slice")
    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=DEVICE)
    phase_kernels_deep(L)
    torch.cuda.empty_cache()
    check_two_kernel_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 3, results, chunk=TWIN_CHUNK)
    check_sw_sweep_allsky(f"main ncol={TWIN_CHUNK} nlay={NLAY} ngpt=224", L, allsky_atmosphere(TWIN_CHUNK, NLAY),
                          results)
    torch.cuda.empty_cache()
    two_kernel = phase_two_kernel_slice(lw, sw, atm, bcs_lw, bcs_sw, f32_lw, L)
    launches.update({k: two_kernel[k] for k in ("optics_fused_lw", "optics_fused_sw", "planck_band_rows",
                                                "lw_noscat_banded_reduced", "sw_2stream_reduced")})
    torch.cuda.empty_cache()
    check_unfused_kernels(label, lw, sw, atm, 3, results, chunk=TWIN_CHUNK)
    torch.cuda.empty_cache()
    unfused = phase_unfused_slice(lw, sw, atm, bcs_lw, bcs_sw, L)
    launches.update(interp_pt_eta=unfused["interp_pt_eta"], interp_minor=unfused["interp_minor"])
    done("deep kernels, the two-kernel and unfused slices")
    torch.cuda.empty_cache()
    path_c = check_sweep_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 3, results, chunk=TWIN_CHUNK)
    check_lw2_sweep_allsky(f"main ncol={TWIN_CHUNK} nlay={NLAY} ngpt=256", L, allsky_atmosphere(TWIN_CHUNK, NLAY),
                           results)
    torch.cuda.empty_cache()
    sweep = phase_sweep_slice(lw, sw, atm, bcs_lw, bcs_sw)
    launches.update(lw_noscat_reduced=sweep["lw_noscat_reduced"], lw_2stream_reduced=sweep["lw_2stream_reduced"],
                    sw_2stream_gpt=path_c["sw_2stream_gpt"], lw_noscat_gpt=path_c["lw_noscat_gpt"])
    torch.cuda.empty_cache()
    done("the sweep slice")
    grad = phase_gradients(lw, sw, atm, bcs_lw, bcs_sw)
    done("the gradient phase")
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()
    f64 = phase_f64_slice(lw64, sw64, atm64, bcs_lw64, bcs_sw64, f32_lw)
    launches.update(planck_band_f64=f64["planck_band"], lw_clear_mega_f64=f64["lw_clear_mega"],
                    sw_clear_mega_f64=f64["sw_clear_mega"])
    done("the f64 slice")
    del atm64, bcs_lw64, bcs_sw64, lw64, sw64, f32_lw
    torch.cuda.empty_cache()

    atm = allsky_atmosphere(ALLSKY_NCOL, NLAY)
    check_allsky_kernels(f"main ncol={ALLSKY_NCOL} nlay={NLAY} ngpt=256/224", L, atm, 3, results,
                         chunk=TWIN_CHUNK)
    torch.cuda.empty_cache()
    bcs_lw, bcs_sw = boundary_conditions(L.lookup_lw, L.lookup_sw, ALLSKY_NCOL)
    allsky = phase_allsky_slice(L, atm, bcs_lw, bcs_sw)
    launches.update(lw2_mega=allsky["lw2_mega"], sw_clear_mega_allsky=allsky["sw_clear_mega"],
                    aerosol_bands=allsky["aerosol_bands"], mcica_mask_export=allsky["mcica_mask_export"],
                    cloud_bands_lw=allsky["cloud_bands_lw"], cloud_bands_sw=allsky["cloud_bands_sw"])
    torch.cuda.empty_cache()
    noscat = phase_allsky_slice(L, atm, bcs_lw, bcs_sw, two_stream_lw=False)
    launches.update(lw_clear_mega_allsky=noscat["lw_clear_mega"])
    torch.cuda.empty_cache()
    phase_sweep_allsky(L, atm, bcs_lw)
    done("the all-sky kernels and slices")
    torch.cuda.empty_cache()
    phase_mesh(L, atm, bcs_lw, bcs_sw, AllSkyRadiation(aerosol_radiation=True), True, "mesh-allsky",
               MESH_ALLSKY_WANT)
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()
    atm = atmosphere(NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, NCOL)
    _, whole = phase_mesh(LookupBundle(lookup_lw=lw, lookup_sw=sw), atm, bcs_lw, bcs_sw, ClearSkyRadiation(),
                          False, "mesh-clear", MESH_CLEAR_WANT)
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()
    phase_mesh_world(whole)
    del whole
    done("the mesh phase")
    phase_routes(L, lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float64, device=DEVICE))
    torch.cuda.empty_cache()
    done("the routes phase")
    phase_data()
    torch.cuda.empty_cache()
    done("the data phase")
    atm = allsky_atmosphere(GRAD_AEROSOL_NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(L.lookup_lw, L.lookup_sw, GRAD_AEROSOL_NCOL)
    grad_aerosol = phase_gradients(L.lookup_lw, L.lookup_sw, atm, bcs_lw, bcs_sw, tag="grad-aerosol",
                                   lkp_aero={"lw": L.lookup_lw_aero, "sw": L.lookup_sw_aero})
    phase("grad", f"gradient forwards' launches (clear, aerosols): {grad}, {grad_aerosol}")
    done("the aerosol gradient phase")
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()
    phase_gray()
    done("the gray phase")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"], "bound_by": results[name]["bound_by"],
         # grid_sample computes the band Planck interpolation (check_library);
         # no PyTorch call computes the others: a whole solve, a sweep, a table
         # gather of the gas optics, the aerosol band sums or the McICA draws
         "library_ms": results[name].get("library_ms")}
        for name in SOURCES
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        main()
