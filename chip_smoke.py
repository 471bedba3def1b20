"""Drive the PyTorch/CUDA port (rrtmgp_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and the exit code is
non-zero:

1. device: torch/CUDA versions, card name and power limit (nvidia-smi);
2. build: nvcc builds the CUDA kernels of rrtmgp_tpu_torch/csrc;
3. kernels: each kernel against its plain torch twin on the card, first at
   small shapes (ncol 1000, 36 g-points in 4 bands), then at the main
   path's (32768 columns x 60 layers, LW 256 / SW 224 g-points), with
   timings of both;
4. slice: solve_lw (LW no-scattering) + solve_sw (SW two-stream) through
   the kernels at full width on the synthetic tables and atmosphere of the
   JAX package's bench.py, with physics oracles, night columns, the kernel
   path against the torch path on the first 4096 columns, launch counts,
   and the step time.

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

NCOL, NLAY = 32768, 60          # bench.py's DYAMOND-order batch
SMALL_NCOL, SMALL_NLAY = 1000, 30
CMP_NCOL = 4096                 # kernel vs torch path on the first columns
STEPS = 5
DEVICE = "cuda"
TOL = {"planck_band": 1e-6, "lw_clear_mega": 5e-5, "sw_clear_mega": 1e-4}
SOURCES = {
    "planck_band": ("rrtmgp_tpu_torch/csrc/planck_band.cu", "rrtmgp_tpu/ops/pallas_mega.py:224"),
    "lw_clear_mega": ("rrtmgp_tpu_torch/csrc/lw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:522"),
    "sw_clear_mega": ("rrtmgp_tpu_torch/csrc/sw_clear_mega.cu", "rrtmgp_tpu/ops/pallas_mega.py:959"),
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
    return err, err / scale


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


def atmosphere(ncol, nlay):
    import numpy as np

    from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere

    return synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device=DEVICE)


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


def kernel_args(lw, sw, atm, bcs_lw, bcs_sw):
    """The wrappers' arguments exactly as solve_lw / solve_sw build them."""
    from rrtmgp_tpu_torch.angular import angular_discretization
    from rrtmgp_tpu_torch.ops.mega import planck_band
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    Ds, wts = angular_discretization(1)
    plk = lambda t: planck_band(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
    lw_args = (mega_lw_inputs(lw, atm), lw.kernel_tables, plk(atm.t_lay), plk(atm.t_lev),
               plk(atm.t_sfc), bcs_lw.sfc_emis, None, float(Ds[0]), float(wts[0]))
    toa_gpt = bcs_sw.toa_flux[:, None] * sw.solar_src_scaled[None, :]
    sw_args = (mega_sw_inputs(sw, atm), sw.kernel_tables, bcs_sw.cos_zenith, toa_gpt,
               bcs_sw.sfc_alb_direct, bcs_sw.sfc_alb_diffuse, None)
    plk_args = [(t.reshape(-1), lw.totplnk, lw.t_planck_min, lw.t_planck_delta)
                for t in (atm.t_lay, atm.t_lev, atm.t_sfc)]
    return plk_args, lw_args, sw_args


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
    phase("build", f"{path.name} in {seconds:.1f} s (nvcc {_build.find_nvcc()})")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            phase("build", line.strip())
    return seconds


def check_kernels(label, lw, sw, atm, bcs_lw, bcs_sw, reps) -> dict:
    """Each kernel against its twin on the same inputs; returns per-kernel
    max |error| and median times."""
    import torch

    from rrtmgp_tpu_torch.ops import mega

    plk_args, lw_args, sw_args = kernel_args(lw, sw, atm, bcs_lw, bcs_sw)
    cases = {
        "planck_band": (lambda: tuple(mega.planck_band(*a) for a in plk_args),
                        lambda: tuple(mega.planck_band_ref(*a) for a in plk_args)),
        "lw_clear_mega": (lambda: mega.lw_clear_mega(*lw_args), lambda: mega.lw_clear_mega_ref(*lw_args)),
        "sw_clear_mega": (lambda: mega.sw_clear_mega(*sw_args), lambda: mega.sw_clear_mega_ref(*sw_args)),
    }
    results = {}
    for name, (kern, ref) in cases.items():
        out = kern()
        torch.cuda.synchronize()
        want = ref()
        err, rel = rel_err(out, want)
        del out, want
        ok = rel <= TOL[name]
        res = {"max_abs_err": err, "rel": rel}
        if reps:
            res["ms"] = timed(kern, reps)
            res["plain_ms"] = timed(ref, reps)
        torch.cuda.empty_cache()
        phase("kernels", f"{label} {name}: max|d|={err:.3e} rel={rel:.3e} (tol {TOL[name]:.0e})"
              + (f", kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms" if reps else ""))
        if not ok:
            raise AssertionError(f"{label} {name}: rel error {rel:.3e} > {TOL[name]:.0e}")
        results[name] = res
    return results


def phase_kernels_small() -> None:
    import torch

    lw, sw = lookups(36, 4, 36, 4)
    atm = atmosphere(SMALL_NCOL, SMALL_NLAY)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    mu0 = 0.05 + 0.95 * torch.rand(SMALL_NCOL, generator=gen, device=DEVICE)  # day columns
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, SMALL_NCOL, mu0)
    check_kernels(f"small ncol={SMALL_NCOL} nlay={SMALL_NLAY} ngpt=36", lw, sw, atm, bcs_lw, bcs_sw, 0)


def columns(x, n):
    """The first n columns of a state or boundary-condition container."""
    import torch

    from rrtmgp_tpu_torch.states import TensorContainer, VmrGM

    def cut(v):
        if isinstance(v, VmrGM):
            return dataclasses.replace(v, vmr_h2o=cut(v.vmr_h2o), vmr_o3=cut(v.vmr_o3))
        if isinstance(v, TensorContainer):
            return columns(v, n)
        if isinstance(v, torch.Tensor):
            return v[..., :n].contiguous()
        return v

    return dataclasses.replace(x, **{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})


def phase_slice(lw, sw, atm, bcs_lw, bcs_sw) -> tuple[dict, float]:
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # physics oracles
    for f in (*f_lw, *f_sw):
        if not torch.isfinite(f).all():
            raise AssertionError("non-finite flux")
    if f_lw.flux_up.shape != (NLAY + 1, NCOL) or f_sw.flux_dn_dir.shape != (NLAY + 1, NCOL):
        raise AssertionError("flux shape")
    if not torch.all(f_lw.flux_dn[-1] == 0.0):
        raise AssertionError("LW flux_dn at TOA is not 0 (no incident flux)")
    if not torch.all(f_sw.flux_dn_dir[:-1] <= f_sw.flux_dn_dir[1:]):
        raise AssertionError("SW direct beam increases toward the surface")
    if not torch.all(f_sw.flux_up[-1] <= 1361.0 * 0.6):
        raise AssertionError("SW TOA up flux exceeds the incoming flux")
    phase("slice", "oracles: finite, LW TOA dn = 0, SW direct beam monotone, TOA up <= incoming")

    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    phase("slice", f"prologue (plain torch mega inputs): LW {timed(lambda: mega_lw_inputs(lw, atm), 3):.3f} ms, "
                   f"SW {timed(lambda: mega_sw_inputs(sw, atm), 3):.3f} ms")

    # night columns come out exactly 0
    mu0 = bcs_sw.cos_zenith.clone()
    mu0[::5] = -0.3
    mu0[1::5] = 0.0
    f_night, _ = solve_sw(sw, atm, dataclasses.replace(bcs_sw, cos_zenith=mu0), impl="kernel")
    night = mu0 <= 0
    for f in f_night:
        if not torch.all(f[:, night] == 0.0):
            raise AssertionError("night column not exactly 0")
    phase("slice", f"night columns exactly 0 ({int(night.sum())} of {NCOL})")

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
        if rel > tol:
            raise AssertionError(f"{name}: kernel vs torch rel error {rel:.3e} > {tol:.0e}")

    step_ms = 1e3 * statistics.median(times)
    phase("slice", f"LW+SW step: median {step_ms:.3f} ms over {STEPS} steps "
                   f"(min {1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), "
                   f"{NCOL / (step_ms / 1e3):.1f} columns/s, peak memory {peak_gb:.2f} GB")
    return launches, step_ms


def main() -> None:
    import torch

    phase_device()
    phase_build()
    phase_kernels_small()

    lw, sw = lookups(256, 16, 224, 14)
    atm = atmosphere(NCOL, NLAY)
    bcs_lw, bcs_sw = boundary_conditions(lw, sw, NCOL)
    full = check_kernels(f"main ncol={NCOL} nlay={NLAY} ngpt=256/224", lw, sw, atm, bcs_lw, bcs_sw, 3)
    launches, _ = phase_slice(lw, sw, atm, bcs_lw, bcs_sw)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "max_abs_err": full[name]["max_abs_err"],
         "ms": full[name]["ms"], "plain_ms": full[name]["plain_ms"]}
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
