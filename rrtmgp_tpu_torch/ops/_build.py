"""Build and load the CUDA kernels of ``rrtmgp_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (sm_90a), one process per
source, all started together, and links the objects into one shared library
with a plain C interface, loaded with ctypes. ``-fmad=false`` keeps
multiply-adds unfused, so the kernels round op by op like their plain torch
twins: near the Meador-Weaver singularity (k * mu0 = 1) the SW coefficients
amplify a one-ulp difference far beyond the kernels' tolerance. The library is named by a
hash of the sources and flags and lives in ``rrtmgp_tpu_torch/build/``, so a
changed source rebuilds and an unchanged one is reused. The first CUDA call of
a kernel wrapper builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

from ..utils.debug import check_kernel_outputs, note_compile

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _U, _L, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_double)
#: C entry points: name -> argtypes. Each returns a cudaError_t as int. The
#: band Planck entries take the table, three temperature sets (pointers in,
#: pointers out, sizes; null and 0 where unused), the sets plan
#: (``ops/_launch.py`` ``sets_plan``: the first block of sets 1 and 2, the
#: grid, the points a block covers), nbnd, n_t, t_min, t_delta and the
#: stream. The
#: kernels of one thread per g-point take their launch plan
#: (``ops/_launch.py``): (group, n_groups, in_block) after their dims (the
#: per-g-point sweeps, which have no level sums, (group, n_groups)), and a
#: device buffer of level partials (null when the sums stay in the block);
#: lw_clear_mega's and sw_clear_mega's dims end with n_minor; the all-sky megakernels end with
#: (cloud, aero, mask_mode, seed_hi, seed_lo, col_offset), then the plan,
#: lw_clear_mega (ds, i2f), and the stream. The _f64 entries take f64
#: tensors and double scalars. The kernels of the two-kernel path:
#: optics_fused ends with (7 dims, n_minor, shortwave, column tile, group,
#: n_groups, stream), lw_noscat_banded with (nlay, ncol, ngpt, nbnd, plan,
#: nang, then host arrays of nang floats ds and i2f, stream), sw_2stream_reduced with (nlay, ncol, ngpt, nbnd, plan,
#: stream). The sweeps from materialized sources: lw_noscat_reduced ends
#: with (nlay, ncol, ngpt, plan, nang, host arrays ds and i2f, stream), lw_noscat_gpt with
#: (nlay, ncol, ngpt, group, n_groups, ds, i2f, stream), lw_2stream_reduced
#: with (nlay, ncol, ngpt, nbnd, checkpoint levels, plan, stream), sw_2stream_gpt with (nlay,
#: ncol, ngpt, group, n_groups, stream). The kernels of the unfused optics:
#: interp_pt_eta ends with (nlay, ncol, ngpt, nbnd, npress, ntemp, neta,
#: column tile, group, n_groups, stream), interp_minor with optics_fused's 7
#: dims, n_minor, column tile, group, n_groups and the stream. cloud_bands
#: takes the two tables, the four radius bounds, the four fields and the
#: three outputs, the fields' row strides, (nlay, ncol, nbnd, nsize_liq,
#: nsize_ice, nrgh, rgh, delta_scale) and the stream.
SIGNATURES = {
    "rrtmgp_planck_band": [_P] * 7 + [_I] * 9 + [_F, _F, _P],
    "rrtmgp_planck_band_f64": [_P] * 7 + [_I] * 9 + [_D, _D, _P],
    "rrtmgp_lw_clear_mega": [_P] * 42 + [_I] * 11 + [_U, _U, _L, _I, _I, _I, _F, _F, _P],
    "rrtmgp_lw_clear_mega_f64": [_P] * 31 + [_I] * 11 + [_D, _D, _P],
    "rrtmgp_sw_clear_mega": [_P] * 46 + [_I] * 11 + [_U, _U, _L, _I, _I, _I, _P],
    "rrtmgp_sw_clear_mega_f64": [_P] * 35 + [_I] * 11 + [_P],
    "rrtmgp_lw2_mega": [_P] * 44 + [_I] * 10 + [_U, _U, _L, _I, _I, _I, _P],
    "rrtmgp_aerosol_bands": [_P] * 15 + [_I] * 6 + [_P],
    "rrtmgp_cloud_bands": [_P] * 13 + [_L] * 4 + [_I] * 8 + [_P],
    "rrtmgp_mcica_export": [_P] * 3 + [_I] * 5 + [_U, _U, _L, _P],
    "rrtmgp_optics_fused": [_P] * 24 + [_I] * 12 + [_P],
    "rrtmgp_planck_band_rows": [_P] * 7 + [_I] * 9 + [_F, _F, _P],
    "rrtmgp_lw_noscat_banded": [_P] * 11 + [_I] * 8 + [_P, _P, _P],
    "rrtmgp_sw_2stream_reduced": [_P] * 15 + [_I] * 7 + [_P],
    "rrtmgp_lw_noscat_reduced": [_P] * 10 + [_I] * 7 + [_P, _P, _P],
    "rrtmgp_lw_noscat_gpt": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    "rrtmgp_lw_2stream_reduced": [_P] * 13 + [_I] * 8 + [_P],
    "rrtmgp_sw_2stream_gpt": [_P] * 11 + [_I] * 6 + [_P],
    "rrtmgp_interp_pt_eta": [_P] * 13 + [_I] * 10 + [_P],
    "rrtmgp_interp_minor": [_P] * 20 + [_I] * 11 + [_P],
}

#: entry points that report a launch's shared memory in bytes (long long)
#: from int arguments: name -> their count
SIZE_QUERIES = {
    "rrtmgp_aerosol_bands_smem": 3,
    "rrtmgp_cloud_bands_smem": 3,
    "rrtmgp_lw_clear_mega_staged": 6,
    "rrtmgp_sw_clear_mega_staged": 6,
    "rrtmgp_optics_fused_smem": 3,
    "rrtmgp_interp_pt_eta_smem": 2,
    "rrtmgp_interp_minor_smem": 3,
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PATH or /usr/local/cuda; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the rrtmgp_tpu_torch CUDA kernels need the CUDA toolkit to build"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librrtmgp_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists.
    The compiler's report (registers, spills) is kept beside it as .log."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    note_compile("nvcc", out.name)
    cu = [p for p in _sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)], cwd=CSRC,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cu, objs)
        ]
        logs = [(p, proc.communicate()[0], proc.returncode) for p, proc in zip(cu, procs)]
        so = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", so, *objs],
                              capture_output=True, text=True, cwd=CSRC)
        logs.append(("link", link.stdout + link.stderr, link.returncode))
        out.with_suffix(".log").write_text("".join(text for _, text, _ in logs))
        for name, text, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}) on {name} building {out.name}:\n{text[-8000:]}")
        os.replace(so, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rrtmgp_error_string.argtypes = [ctypes.c_int]
    lib.rrtmgp_error_string.restype = ctypes.c_char_p
    lib.rrtmgp_smem_optin.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rrtmgp_smem_optin.restype = ctypes.c_int
    lib.rrtmgp_max_threads.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.rrtmgp_max_threads.restype = ctypes.c_int
    lib.rrtmgp_aerosol_bands_blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.rrtmgp_aerosol_bands_blocks.restype = ctypes.c_int
    for name, n_args in SIZE_QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * n_args
        fn.restype = ctypes.c_longlong
    return lib


def check(err: int, name: str, *outputs) -> None:
    """Raise if a launch returned a CUDA error; inside
    ``utils.debug.strict_mode`` also if one of the kernel's ``outputs``
    holds a NaN."""
    if err != 0:
        text = library().rrtmgp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")
    check_kernel_outputs(name, outputs)
