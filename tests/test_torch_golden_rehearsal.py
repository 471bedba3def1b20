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
"""

import os
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
