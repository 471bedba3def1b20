"""Rehearsal of the port's golden tests (tests/test_torch_real_data.py)
without the data, on the fabricated rrtmgp-data checkout of
tests/test_golden_rehearsal.py (its ``fake_data_dir``: synthetic lookup
files at the v1.9 names, an RFMIP-shaped input with 100 sites and a night
column, the all-sky example files), whose "Fortran reference" fluxes the
JAX package's f64 XLA solve wrote through the same loading procedure.

Each of the golden matrix's 18 cases runs the port's case function (its
loaders, readers, reference-file parsers and solves, on the CPU) against
those files at the golden tolerances. This certifies the port's golden
pipeline and its agreement with the JAX package, not the Fortran numbers.

scripts/golden_contact_torch.py, the port's first-contact script, is
rehearsed on the same checkout: its identity gate (exit 3), its structure
gate (exit 4), its reading of the port's case lines and, marked slow as
tests/test_golden_rehearsal.py's run of the JAX script is, a whole run.
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_golden_rehearsal import fake_data_dir  # noqa: E402,F401  (the fixture)
import test_torch_real_data as golden  # noqa: E402

CASES = (
    [(f"clear_lw_{'2stream' if ts else 'noscat'}_{ft}", golden.clear_sky_lw, (dt, ts))
     for ts in (False, True) for dt, ft in zip(golden.FTS, golden.FT_IDS)]
    + [(f"clear_sw_{ft}", golden.clear_sky_sw, (dt,)) for dt, ft in zip(golden.FTS, golden.FT_IDS)]
    + [(f"allsky_lw_{'aero' if ae else 'noaero'}_{'2stream' if ts else 'noscat'}_{ft}", golden.allsky,
        (ae, "lw", dt, ts))
       for ae in (False, True) for ts in (False, True) for dt, ft in zip(golden.FTS, golden.FT_IDS)]
    + [(f"allsky_sw_{'aero' if ae else 'noaero'}_{ft}", golden.allsky, (ae, "sw", dt))
       for ae in (False, True) for dt, ft in zip(golden.FTS, golden.FT_IDS)]
)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_port_golden_case(fake_data_dir, monkeypatch, case):  # noqa: F811
    name, fn, args = case
    monkeypatch.setenv("RRTMGP_DATA", fake_data_dir)
    monkeypatch.setenv("RRTMGP_ETA_NODE_MODE", "reference")
    assert golden.ap.have_data()
    err_up, err_dn, tol = fn(*args)
    print(f"{name}: L-inf up {err_up:.2e}, dn {err_dn:.2e} W/m^2 (tol {tol})")
    assert np.isfinite(err_up) and np.isfinite(err_dn)
    assert err_up <= tol and err_dn <= tol
    if "f64" in name and "2stream" not in name:
        # the references are the JAX f64 no-scattering and SW solves
        assert max(err_up, err_dn) <= 1e-6, name


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "golden_contact_torch.py")


def _script_module():
    spec = importlib.util.spec_from_file_location("golden_contact_torch", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_script(*args, timeout):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("RRTMGP_DATA", None)
    return subprocess.run([sys.executable, SCRIPT, *args], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_contact_script_aborts_on_an_unpinned_checkout(fake_data_dir):  # noqa: F811
    r = _run_script(fake_data_dir, timeout=300)
    assert r.returncode == 3, r.stdout[-2000:] + r.stderr[-2000:]
    assert "MISMATCH" in r.stdout and "ABORT" in r.stdout


def test_contact_script_aborts_on_a_missing_lookup_file(fake_data_dir, tmp_path):  # noqa: F811
    from rrtmgp_tpu_torch.data.manifest import V19_FILES

    copy = tmp_path / "data"
    shutil.copytree(fake_data_dir, copy)
    os.remove(copy / V19_FILES["cloud_sw"])
    r = _run_script(str(copy), "--allow-unpinned", "--lenient", timeout=300)
    assert r.returncode == 4, r.stdout[-2000:] + r.stderr[-2000:]
    assert f"FAIL {V19_FILES['cloud_sw']}" in r.stdout and "structure: FAILED" in r.stdout


def test_contact_script_reads_the_port_case_lines(capsys):
    """The parser reads the lines tests/test_torch_real_data.py prints,
    which end "(tol X, device Y)" where the JAX suite's end "(tol X)"."""
    golden._check("clear-sky LW noscat", np.float64, 1.5e-7, 2.5e-7, 1e-4)
    print(".", end="")  # pytest -q's progress mark of the test before, on the next case's line
    golden._check("allsky(aero=True) SW", np.float32, 1e-2, 2e-2, 0.06)
    out = capsys.readouterr().out
    rows = [m.groupdict() for m in _script_module().LINF_RE.finditer(out)]
    assert [r["case"] for r in rows] == ["clear-sky LW noscat float64", "allsky(aero=True) SW float32"]
    assert (rows[0]["up"], rows[0]["dn"], rows[0]["tol"]) == ("1.50e-07", "2.50e-07", "0.0001")
    assert rows[1]["tol"] == "0.06" and rows[0]["device"] == str(golden.default_device())


@pytest.mark.slow
def test_contact_script_runs_the_matrix(fake_data_dir):  # noqa: F811
    r = _run_script(fake_data_dir, "--allow-unpinned", "--lenient", "--modes", "reference", timeout=2400)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-2000:]}"
    assert "structure: OK" in r.stdout and "## Parity report" in r.stdout
    assert "| clear-sky LW noscat float64 | 0.0001 |" in r.stdout
    assert len(re.findall(r"^\| (clear-sky|allsky)", r.stdout, re.M)) == 18  # a row for every case
    assert "unpinned" in r.stdout
