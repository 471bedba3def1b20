"""Drive the PyTorch/CUDA port (rrtmgp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of rrtmgp_tpu_torch/csrc;
3. kernels: each kernel against its plain torch twin on the card, first at
   small shapes (ncol 1000, 36 g-points in 4 bands), then at the main
   paths' shapes: the clear-sky kernels at 32768 columns x 60 layers, the
   all-sky ones (lw2_mega clear / cloud mask / McICA seed + aerosols,
   sw_clear_mega with cloud mask + aerosols / seed + aerosols,
   aerosol_bands, mcica_mask_export) at 75748 x 60, LW 256 / SW 224
   g-points, their twins on 8192-column chunks; with each kernel's median
   time and its twin's;
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
   and one AllSkyRadiationWithClearSkyDiagnostics step.

The last lines are a JSON object per kernel, the card's name and power limit,
and {"ok": true, "device": {...}}. Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

NCOL, NLAY = 32768, 60          # bench.py's DYAMOND-order clear-sky batch
ALLSKY_NCOL = 75748             # benchmarks/dyamond.py:27, the reference's all-sky DYAMOND size
TWIN_CHUNK = 8192               # the all-sky twins run on column chunks (bounds their memory)
SMALL_NCOL, SMALL_NLAY = 1000, 30
CMP_NCOL = 4096                 # kernel vs torch path on the first columns
STEPS = 5
DEVICE = "cuda"
MCICA_SEED, COL_OFFSET = 11, 384
TOL = {"planck_band": 1e-6, "lw_clear_mega": 5e-5, "sw_clear_mega": 1e-4,
       "lw2_mega": 1e-4, "sw_clear_mega_allsky": 1e-4, "aerosol_bands": 1e-6,
       "mcica_mask_export": 0.0}
SOURCES = {
    "planck_band": ("rrtmgp_tpu_torch/csrc/planck_band.cu", "rrtmgp_tpu/ops/pallas_mega.py:224"),
    "lw_clear_mega": ("rrtmgp_tpu_torch/csrc/lw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:522"),
    "sw_clear_mega": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
    "lw2_mega": ("rrtmgp_tpu_torch/csrc/lw2_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:1511"),
    "sw_clear_mega_allsky": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
    "aerosol_bands": ("rrtmgp_tpu_torch/csrc/aerosol_bands.cu", "rrtmgp_tpu/ops/pallas_aerosol.py:64"),
    "mcica_mask_export": ("rrtmgp_tpu_torch/csrc/mcica_export.cu", "rrtmgp_tpu/ops/pallas_mega.py:1983"),
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


def lookups(n_lw, b_lw, n_sw, b_sw):
    import numpy as np

    from rrtmgp_tpu_torch.data.synthetic import synthetic_gas_lookup

    lw = synthetic_gas_lookup(longwave=True, n_gpt=n_lw, n_bnd=b_lw, dtype=np.float32, device=DEVICE)
    sw = synthetic_gas_lookup(longwave=False, n_gpt=n_sw, n_bnd=b_sw, seed=1, dtype=np.float32,
                              device=DEVICE)
    return lw, sw


def small_allsky_lookups():
    """A LookupBundle at the small shapes (36 g-points in 4 bands)."""
    import numpy as np

    from rrtmgp_tpu_torch import LookupBundle
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    lw, sw = lookups(36, 4, 36, 4)
    kw = dict(n_bnd=4, dtype=np.float32, device=DEVICE)
    return LookupBundle(
        lookup_lw=lw, lookup_sw=sw,
        lookup_lw_cld=synthetic_cloud_lookup(**kw), lookup_sw_cld=synthetic_cloud_lookup(seed=5, **kw),
        lookup_lw_aero=synthetic_aerosol_lookup(**kw), lookup_sw_aero=synthetic_aerosol_lookup(seed=6, **kw),
    )


def atmosphere(ncol, nlay):
    import numpy as np

    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere

    return synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=DEVICE)


def allsky_atmosphere(ncol, nlay):
    """The synthetic atmosphere with clouds and aerosols; its cloud
    fraction (0 or 1) times a numpy-seeded uniform in [0.2, 1], so that the
    McICA mask depends on the draws."""
    import numpy as np
    import torch

    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere

    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=DEVICE,
                               with_clouds=True, with_aerosols=True)
    scale = np.random.default_rng(17).uniform(0.2, 1.0, (nlay, ncol)).astype(np.float32)
    cs = atm.cloud_state
    cf = (cs.cld_frac * torch.from_numpy(scale).to(DEVICE)).contiguous()
    return dataclasses.replace(atm, cloud_state=dataclasses.replace(cs, cld_frac=cf))


def boundary_conditions(lw, sw, ncol, mu0=None):
    import torch

    from rrtmgp_tpu_torch import LwBCs, SwBCs

    f = lambda shape, v: torch.full(shape, v, dtype=torch.float32, device=DEVICE)
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
    """The clear-sky wrappers' arguments exactly as solve_lw / solve_sw build them."""
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    Ds, wts = angular_discretization(1)
    plk = plk_fn(lw)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lay), plk(atm.t_lev),
               plk(atm.t_sfc), bcs_lw.sfc_emis, None, float(Ds[0]), float(wts[0]))
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, bcs_sw.cos_zenith, toa_gpt,
               bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse, None)
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    return plk_args, lw_args, sw_args


def columns(x, lo, hi=None):
    """Columns [lo, hi) (or the first ``lo`` with one argument) of a state or
    boundary-condition container."""
    import torch

    from rrtmgp_tpu_torch.states import TensorContainer, VmrGM

    if hi is None:
        lo, hi = 0, lo

    def cut(v):
        if isinstance(v, VmrGM):
            return dataclasses.replace(v, vmr_h2o=cut(v.vmr_h2o), vmr_o3=cut(v.vmr_o3))
        if isinstance(v, TensorContainer):
            return columns(v, lo, hi)
        if isinstance(v, torch.Tensor):
            return v[..., lo:hi].contiguous()
        return v

    return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})


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


def check_case(label, name, kern, ref, reps, results, cover=False) -> None:
    """One kernel call against its twin on the same inputs (tuples of
    tensors). With ``cover`` the last output is the McICA cloud cover, which
    must agree bit for bit; mcica_mask_export must agree bit for bit
    throughout. Keeps the largest error of a name and, with reps, the
    times."""
    import torch

    out = kern()
    torch.cuda.synchronize()
    want = ref()
    if cover:
        require(torch.equal(out[-1], want[-1]), f"{label} {name}: McICA cloud cover differs from the twin's")
        out, want = out[:-1], want[:-1]
    if TOL[name] == 0.0:
        require(all(torch.equal(a, b) for a, b in zip(out, want)), f"{label} {name}: differs from the twin")
    err, rel = rel_err(out, want)
    del out, want
    res = results.setdefault(name, {"max_abs_err": 0.0, "rel": 0.0})
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["rel"] = max(res["rel"], rel)
    timing = ""
    if reps:
        res["ms"] = timed(kern, reps)
        res["plain_ms"] = timed(ref, reps)
        timing = f", kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms"
    torch.cuda.empty_cache()
    phase("kernels", f"{label} {name}: max|d|={err:.3e} rel={rel:.3e} (tol {TOL[name]:.0e}){timing}")
    require(rel <= TOL[name], f"{label} {name}: rel error {rel:.3e} > {TOL[name]:.0e}")


def check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, reps, results) -> None:
    """The clear-sky kernels against their twins."""
    from rrtmgp_tpu_torch.ops import mega

    plk_args, lw_args, sw_args = kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    cases = {
        "planck_band": (lambda: tuple(mega.planck_band(*a) for a in plk_args),
                        lambda: tuple(mega.planck_band_ref(*a) for a in plk_args)),
        "lw_clear_mega": (lambda: mega.lw_clear_mega(*lw_args), lambda: mega.lw_clear_mega_ref(*lw_args)),
        "sw_clear_mega": (lambda: mega.sw_clear_mega(*sw_args), lambda: mega.sw_clear_mega_ref(*sw_args)),
    }
    for name, (kern, ref) in cases.items():
        check_case(label, name, kern, ref, reps, results)


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
    from rrtmgp_tpu_torch.states import AerosolState

    c = lambda v: cut(v, lo, hi, ncol)
    if isinstance(x, Composition):
        return x._replace(**{k: c(v) for k, v in x._asdict().items() if k != "col_offset"},
                          col_offset=x.col_offset + lo)
    if isinstance(x, ColOffset):
        return ColOffset(x.value + lo)
    if isinstance(x, tuple):
        return tuple(c(v) for v in x)
    if isinstance(x, (MegaInputs, AerosolState)):
        return dataclasses.replace(x, **{f.name: c(getattr(x, f.name)) for f in dataclasses.fields(x)})
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
    chunks. Timed (with reps) in the main path's mode, McICA seed +
    aerosols."""
    import torch

    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab
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
    lw_cases = (("clear", mega.CLEAR), ("cloud mask", comp(lw, L.lookup_lw_cld, None, "mask", False)),
                ("seed+aerosols", comp(lw, L.lookup_lw_cld, L.lookup_lw_aero, "seed", False)))
    twin = lambda fn, *args: by_columns(fn, args, ncol, chunk)
    for i, (what, c) in enumerate(lw_cases):
        check_case(f"{label} [{what}]", "lw2_mega", lambda: mega.lw2_mega(*lw_args, c),
                   lambda: twin(mega.lw2_mega_ref, *lw_args, c), reps if i == 2 else 0, results, c.seeded)
    sw_cases = (("cloud mask+aerosols", comp(sw, L.lookup_sw_cld, L.lookup_sw_aero, "mask", True)),
                ("seed+aerosols", comp(sw, L.lookup_sw_cld, L.lookup_sw_aero, "seed", True)))
    for i, (what, c) in enumerate(sw_cases):
        check_case(f"{label} [{what}]", "sw_clear_mega_allsky", lambda: mega.sw_clear_mega(*sw_args, c),
                   lambda: twin(mega.sw_clear_mega_ref, *sw_args, c), reps if i == 1 else 0, results,
                   c.seeded)
    for i, lkp in enumerate((L.lookup_sw_aero, L.lookup_lw_aero)):
        a = (lkp, atm.aerosol_state, atm.rel_hum)
        check_case(f"{label} [{lkp.dust.shape[-1]} bands]", "aerosol_bands",
                   lambda: ab.aerosol_bands(*a), lambda: twin(ab.aerosol_bands_ref, *a), reps if i == 1 else 0,
                   results)
    export_ref = lambda f, o: mega.mcica_mask_export_ref(f, seed, o.value, lw.n_gpt)
    check_case(f"{label} [ngpt {lw.n_gpt}]", "mcica_mask_export",
               lambda: mega.mcica_mask_export(cf, seed, off, lw.n_gpt),
               lambda: twin(export_ref, cf, ColOffset(off)), reps, results)


def phase_kernels_small() -> None:
    import torch

    lw, sw = lookups(36, 4, 36, 4)
    atm = atmosphere(SMALL_NCOL, SMALL_NLAY)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    mu0 = 0.05 + 0.95 * torch.rand(SMALL_NCOL, generator=gen, device=DEVICE)  # day columns
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, SMALL_NCOL, mu0)
    label = f"small ncol={SMALL_NCOL} nlay={SMALL_NLAY} ngpt=36"
    check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, 0, {})
    check_allsky_kernels(label, small_allsky_lookups(), allsky_atmosphere(SMALL_NCOL, SMALL_NLAY), 0, {})


def phase_clear_slice(lw, sw, atm, bcs_lw, bcs_sw) -> tuple[dict, float]:
    import torch

    from rrtmgp_tpu_torch import solve_lw, solve_sw
    from rrtmgp_tpu_torch.ops import mega

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
    a, bl, bs = columns(atm, CMP_NCOL), columns(bcs_lw, CMP_NCOL), columns(bcs_sw, CMP_NCOL)
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
    return launches, step_ms


def check_night(sw, atm, bcs_sw, kw, tag) -> None:
    """Night columns come out exactly 0 on the kernel path."""
    import torch

    from rrtmgp_tpu_torch import solve_sw

    mu0 = bcs_sw.cos_zenith.clone()
    mu0[::5] = -0.3
    mu0[1::5] = 0.0
    f_night, _ = solve_sw(sw, atm, dataclasses.replace(bcs_sw, cos_zenith=mu0), impl="kernel", **kw)
    night = mu0 <= 0
    for f in f_night:
        require(torch.all(f[:, night] == 0.0), "night column not exactly 0")
    phase(tag, f"night columns exactly 0 ({int(night.sum())} of {atm.ncol})")


def phase_allsky_slice(L, atm, bcs_lw, bcs_sw) -> dict:
    """RRTMGPSolver all-sky with aerosols at full size; returns the launch
    counts of its update_fluxes() steps and of the exported-mask path."""
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
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica

    ncol = atm.ncol
    grid = RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=torch.float32)
    solver = RRTMGPSolver(grid, AllSkyRadiation(aerosol_radiation=True), RRTMGPParameters(),
                          bcs_lw, bcs_sw, atm, lookups=L)
    solver.update_fluxes()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mega.reset_launch_counts()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        solver.advance_step()
        f_lw, f_sw = solver.update_fluxes()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = mega.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * statistics.median(times)
    phase("allsky", f"launches in {STEPS} update_fluxes() steps: {launches}")
    for name in ("planck_band", "lw2_mega", "sw_clear_mega", "aerosol_bands"):
        require(launches[name] > 0, f"{name} was not launched on the all-sky path")
    phase("allsky", f"update_fluxes() at {ncol} x {NLAY}: median {step_ms:.3f} ms over {STEPS} steps "
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
    phase("allsky", "oracles: finite, LW TOA dn = 0, SW direct beam monotone, TOA up <= incoming, "
                    f"cloud cover in [0, 1], 0 in the {int(clear.sum())} cloud-free columns and > 0 "
                    f"elsewhere, AOD ext >= sca >= 0 (mean ext {ext.mean().item():.3e})")
    check_night(L.lookup_sw, atm, bcs_sw, dict(lkp_cld=L.lookup_sw_cld, lkp_aero=L.lookup_sw_aero,
                                                cld_mask_seed=MCICA_SEED), "allsky")

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
    phase("allsky", "same step twice: bitwise-equal fluxes; the next step: new masks")

    lw, sw = L.lookup_lw, L.lookup_sw
    lw_kw = dict(two_stream=True, lkp_cld=L.lookup_lw_cld, lkp_aero=L.lookup_lw_aero)
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
    phase("allsky", f"column split at {half}: halves with col_offset equal the whole bitwise")

    # seed mode against the exported-mask mode; the exported-mask path is
    # the one that launches mcica_mask_export
    a, bl, bs = columns(atm, CMP_NCOL), columns(bcs_lw, CMP_NCOL), columns(bcs_sw, CMP_NCOL)
    cf = a.cloud_state.cld_frac
    mega.reset_launch_counts()
    exported = []
    for lkp, s in ((lw, seed), (sw, seed + 1)):
        exported.append(mega.mcica_mask_export(cf, s, 0, lkp.n_gpt)[1].bool())
    k_lw_mask, d_lw_mask = solve_lw(lw, a, bl, cld_mask=exported[0], **lw_kw)
    k_sw_mask, d_sw_mask = solve_sw(sw, a, bs, cld_mask=exported[1], **sw_kw)
    export_launches = mega.launch_counts()
    phase("allsky", f"exported-mask path launches: {export_launches}")
    require(export_launches["mcica_mask_export"] > 0, "mcica_mask_export was not launched")
    k_lw, d_lw = solve_lw(lw, a, bl, cld_mask_seed=seed, **lw_kw)
    k_sw, d_sw = solve_sw(sw, a, bs, cld_mask_seed=seed + 1, **sw_kw)
    for name, x, y in (("LW", (*k_lw, d_lw.cld_cover), (*k_lw_mask, d_lw_mask.cld_cover)),
                       ("SW", (*k_sw, d_sw.cld_cover), (*k_sw_mask, d_sw_mask.cld_cover))):
        require(all(torch.equal(p, q) for p, q in zip(x, y)), f"{name}: seed mode != exported-mask mode")
    phase("allsky", f"seed mode equals the exported-mask mode bitwise (LW and SW, {CMP_NCOL} columns)")

    # kernel path against the torch path
    for lkp, s, mask in ((lw, seed, exported[0]), (sw, seed + 1, exported[1])):
        require(torch.equal(build_cloud_mask_mcica(cf, lkp.n_gpt, s, 0), mask),
                "McICA mask of the kernel differs from the torch twin's")
    t_lw, td_lw = solve_lw(lw, a, bl, cld_mask_seed=seed, impl="torch", **lw_kw)
    t_sw, td_sw = solve_sw(sw, a, bs, cld_mask_seed=seed + 1, impl="torch", **sw_kw)
    for name, kern, ref, tol in (("solve_lw", k_lw, t_lw, TOL["lw2_mega"]),
                                 ("solve_sw", k_sw, t_sw, TOL["sw_clear_mega_allsky"])):
        err, rel = rel_err(tuple(kern), tuple(ref))
        phase("allsky", f"{name} kernel vs torch on {CMP_NCOL} columns: max|d|={err:.3e} rel={rel:.3e} "
                        f"(tol {tol:.0e})")
        require(rel <= tol, f"{name}: kernel vs torch rel error {rel:.3e} > {tol:.0e}")
    require(torch.equal(d_lw.cld_cover, td_lw.cld_cover) and torch.equal(d_sw.cld_cover, td_sw.cld_cover),
            "cloud cover: kernel path differs from the torch path")
    _, rel = rel_err((d_sw.aod_sw_ext, d_sw.aod_sw_sca), (td_sw.aod_sw_ext, td_sw.aod_sw_sca))
    require(rel <= 1e-6, f"AOD: kernel path vs torch path rel error {rel:.3e} > 1e-6")
    phase("allsky", f"masks bitwise, cloud cover bitwise, AOD rel {rel:.3e} against the torch path")
    del solver, first, exported

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
    phase("allsky", "AllSkyRadiationWithClearSkyDiagnostics: clear getters differ from all-sky in every "
                    f"cloudy column (cloud-free columns: max |LW up diff| {diff:.3e})")
    return {**launches, "mcica_mask_export": export_launches["mcica_mask_export"]}


def main() -> None:
    import torch

    phase_device()
    phase_build()
    phase_kernels_small()

    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables

    results = {}
    lw, sw = lookups(256, 16, 224, 14)
    atm = atmosphere(NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, NCOL)
    check_kernels(f"main ncol={NCOL} nlay={NLAY} ngpt=256/224", lw, sw, atm, bcs_lw, bcs_sw, 3, results)
    launches, _ = phase_clear_slice(lw, sw, atm, bcs_lw, bcs_sw)
    del atm, bcs_lw, bcs_sw
    torch.cuda.empty_cache()

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device=DEVICE)
    atm = allsky_atmosphere(ALLSKY_NCOL, NLAY)
    check_allsky_kernels(f"main ncol={ALLSKY_NCOL} nlay={NLAY} ngpt=256/224", L, atm, 3, results,
                         chunk=TWIN_CHUNK)
    torch.cuda.empty_cache()
    bcs_lw, bcs_sw = boundary_conditions(L.lookup_lw, L.lookup_sw, ALLSKY_NCOL)
    allsky = phase_allsky_slice(L, atm, bcs_lw, bcs_sw)
    launches.update(lw2_mega=allsky["lw2_mega"], sw_clear_mega_allsky=allsky["sw_clear_mega"],
                    aerosol_bands=allsky["aerosol_bands"], mcica_mask_export=allsky["mcica_mask_export"])

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
