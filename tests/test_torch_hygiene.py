"""Package hygiene of the port: it never imports jax, every module imports
cleanly, and the public names resolve."""

import ast
import importlib
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import rrtmgp_tpu_torch

ROOT = str(Path(rrtmgp_tpu_torch.__file__).resolve().parent.parent)


def test_import_leaves_no_jax_module():
    """In a fresh interpreter, importing the port and all its modules pulls in
    no jax (the tests import both packages; the port itself must not)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {ROOT!r})
        import rrtmgp_tpu_torch
        for m in pkgutil.walk_packages(rrtmgp_tpu_torch.__path__, prefix="rrtmgp_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "rrtmgp_tpu") or m.startswith(("jax.", "jaxlib", "rrtmgp_tpu.")))
        print(",".join(bad))
        sys.exit(1 if bad else 0)
    """)
    # -I: no PYTHONPATH or user site, so nothing but the port can bring jax in
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])


def _imports(path: Path) -> list[str]:
    """Every module a file imports, at top level or inside a function
    (relative imports by their level-0 name: none)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _jax_imports(names) -> list[str]:
    return [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "rrtmgp_tpu")]


@pytest.mark.parametrize("script", ["chip_smoke.py", "scripts/port_measure.py", "scripts/fabricate_rrtmgp_data.py",
                                    "scripts/golden_contact_torch.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts that drive the port on the card (they need CUDA, so they
    are read here, not imported), and the fabricated-checkout writer
    chip_smoke.py imports, and the golden first-contact script, import
    neither jax nor the JAX package, at top level or inside a function."""
    names = _imports(Path(ROOT) / script)
    assert "rrtmgp_tpu_torch" in {n.split(".")[0] for n in names}
    assert not _jax_imports(names)


@pytest.mark.parametrize("sub", ["data", "utils", "parallel"])
def test_data_and_utils_import_no_jax(sub):
    """The loaders, the utilities and the column split, ported from JAX
    modules some of which import no jax themselves (data/netcdf.py,
    data/manifest.py), import neither jax nor any module of the JAX
    package, anywhere in the file; h5py only inside a function."""
    files = sorted((Path(rrtmgp_tpu_torch.__file__).parent / sub).glob("*.py"))
    assert len(files) >= {"data": 4, "utils": 4, "parallel": 3}[sub]
    for path in files:
        assert not _jax_imports(_imports(path)), path.name
        top = [n for node in ast.parse(path.read_text()).body if isinstance(node, (ast.Import, ast.ImportFrom))
               for n in ([a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""])]
        assert "h5py" not in top, path.name


def test_import_loads_no_h5py():
    """import rrtmgp_tpu_torch, all its modules, loads no h5py (NetCDF4
    files import it when read; NetCDF3 files never need it)."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {ROOT!r})
        import rrtmgp_tpu_torch
        for m in pkgutil.walk_packages(rrtmgp_tpu_torch.__path__, prefix="rrtmgp_tpu_torch."):
            importlib.import_module(m.name)
        sys.exit(1 if any(m == "h5py" or m.startswith("h5py.") for m in sys.modules) else 0)
    """)
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_all_modules_import():
    for m in pkgutil.walk_packages(rrtmgp_tpu_torch.__path__, prefix="rrtmgp_tpu_torch."):
        importlib.import_module(m.name)


def test_public_api_resolves():
    for name in rrtmgp_tpu_torch.__all__:
        assert getattr(rrtmgp_tpu_torch, name) is not None, name
    for fn in ("solve_lw", "solve_sw", "get_vmr", "compute_col_gas", "angular_discretization",
               "compute_relative_humidity", "lookup_tables", "RRTMGPSolver", "domain_view"):
        assert callable(getattr(rrtmgp_tpu_torch, fn)), fn


def test_kernel_sources_present_and_build_is_lazy():
    """Every kernel of the clear-sky, all-sky, f64, two-kernel and sweep paths has
    its CUDA source and C entry point (the f64 builds among them), every header a
    source includes is there, and importing the ops builds nothing (the
    library is built on the first CUDA call)."""
    import re

    from rrtmgp_tpu_torch.ops import _build

    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"planck_band.cu", "lw_clear_mega.cu", "sw_clear_mega.cu", "lw2_mega.cu",
            "aerosol_bands.cu", "mcica_export.cu", "errors.cu", "mcica.cuh", "allsky.cuh",
            "common.cuh", "optics_fused.cu", "lw_noscat_banded.cu", "sw_2stream_reduced.cu",
            "sw_twostream.cuh", "lw_twostream.cuh", "lw_noscat_sources.cu", "lw_2stream_reduced.cu"} <= names
    for p in _build.CSRC.iterdir():
        for header in re.findall(r'#include "([^"]+)"', p.read_text()):
            assert header in names, (p.name, header)
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    assert {"rrtmgp_planck_band_f64", "rrtmgp_lw_clear_mega_f64", "rrtmgp_optics_fused",
            "rrtmgp_planck_band_rows", "rrtmgp_lw_noscat_banded",
            "rrtmgp_sw_2stream_reduced", "rrtmgp_lw_noscat_reduced", "rrtmgp_lw_noscat_gpt",
            "rrtmgp_lw_2stream_reduced", "rrtmgp_sw_2stream_gpt"} <= set(_build.SIGNATURES)
    for entry in _build.SIGNATURES:
        assert f'extern "C" int {entry}(' in sources, entry
    assert _build.library.cache_info().currsize == 0
    assert _build.library_path().name.startswith("librrtmgp_kernels_")
