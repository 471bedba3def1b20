"""Structure manifest + validator for rrtmgp-data NetCDF files (counterpart
of ``rrtmgp_tpu/data/manifest.py``, the same checks and messages).

RRTMGP.jl pins rrtmgp-data v1.9 by sha256 in its Artifacts.toml; without a
download this package ships the expected per-file STRUCTURE instead —
required variables, their dimension names, and cross-variable size
relations — and validate any user-supplied ``$RRTMGP_DATA`` checkout before
the loaders consume it. A malformed or mis-versioned file then fails loudly
at load time instead of silently scrambling a table.

Two levels:
- ``validate_structure(ds, kind)``: version-agnostic — variables present,
  dimension names as expected (when the file carries them), internal size
  relations consistent (pressure_interp == pressure+1, contributors cover
  the kminor rows, band limits tile the g-point axis, ...).
- ``validate_rrtmgp_data(data_dir)``: additionally pins the known v1.9
  dimension sizes for the six lookup files (LW g256 / SW g224 gas files,
  cloud and MERRA aerosol band files).
"""

from __future__ import annotations

import os

import numpy as np

from .netcdf import Dataset

# Variables the loaders read, with their expected dimension-name sets.
# Dimension ORDER is irrelevant (the loader orients by name); sets suffice.
_GAS_COMMON = {
    "gas_names": {"absorber", "string_len"},
    "press_ref": {"pressure"},
    "temp_ref": {"temperature"},
    "key_species": {"bnd", "atmos_layer", "pair"},
    "bnd_limits_gpt": {"bnd", "pair"},
    "kmajor": {"gpt", "pressure_interp", "temperature", "mixing_fraction"},
    "vmr_ref": {"atmos_layer", "absorber_ext", "temperature"},
    "kminor_lower": {"contributors_lower", "temperature", "mixing_fraction"},
    "kminor_upper": {"contributors_upper", "temperature", "mixing_fraction"},
    "minor_limits_gpt_lower": {"minor_absorber_intervals_lower", "pair"},
    "minor_limits_gpt_upper": {"minor_absorber_intervals_upper", "pair"},
}
_GAS_LW = {
    **_GAS_COMMON,
    "plank_fraction": {"gpt", "pressure_interp", "temperature", "mixing_fraction"},
    "temperature_Planck": {"temperature_Planck"},
    "totplnk": {"temperature_Planck", "bnd"},
}
_GAS_SW = {
    **_GAS_COMMON,
    "rayl_lower": {"gpt", "temperature", "mixing_fraction"},
    "rayl_upper": {"gpt", "temperature", "mixing_fraction"},
    "solar_source_quiet": {"gpt"},
    "solar_source_facular": {"gpt"},
    "solar_source_sunspot": {"gpt"},
}
_CLOUD = {
    "extliq": {"nsize_liq", "nband"},
    "ssaliq": {"nsize_liq", "nband"},
    "asyliq": {"nsize_liq", "nband"},
    "extice": {"nsize_ice", "nband", "nrghice"},
    "ssaice": {"nsize_ice", "nband", "nrghice"},
    "asyice": {"nsize_ice", "nband", "nrghice"},
    "bnd_limits_wavenumber": {"pair", "nband"},
}
_AEROSOL = {
    "merra_aero_bin_lims": {"pair", "nbin"},
    "aero_rh": {"nrh"},
    "aero_dust_tbl": {"nval", "nbin", "nband"},
    "aero_salt_tbl": {"nval", "nrh", "nbin", "nband"},
    "aero_sulf_tbl": {"nval", "nrh", "nband"},
    "aero_bcar_rh_tbl": {"nval", "nrh", "nband"},
    "aero_bcar_tbl": {"nval", "nband"},
    "aero_ocar_rh_tbl": {"nval", "nrh", "nband"},
    "aero_ocar_tbl": {"nval", "nband"},
    "bnd_limits_wavenumber": {"pair", "nband"},
}
_MANIFESTS = {
    "gas_lw": _GAS_LW,
    "gas_sw": _GAS_SW,
    "cloud": _CLOUD,
    "aerosol": _AEROSOL,
}

#: Known rrtmgp-data v1.9 dimension sizes (gas k-distribution grids: kmajor
#: (9, 60, 14, 256) in the files' Fortran order).
V19_GAS_DIMS = {
    "gas_lw": {"gpt": 256, "bnd": 16, "mixing_fraction": 9, "temperature": 14,
               "pressure": 59, "atmos_layer": 2, "pair": 2,
               "temperature_Planck": 196},
    "gas_sw": {"gpt": 224, "bnd": 14, "mixing_fraction": 9, "temperature": 14,
               "pressure": 59, "atmos_layer": 2, "pair": 2},
}

#: rrtmgp-data v1.9 file names, as RRTMGP.jl resolves them
#: (src/ArtifactPaths.jl:31-38).
V19_FILES = {
    "gas_lw": "rrtmgp-gas-lw-g256.nc",
    "gas_sw": "rrtmgp-gas-sw-g224.nc",
    "cloud_lw": "rrtmgp-clouds-lw-bnd.nc",
    "cloud_sw": "rrtmgp-clouds-sw-bnd.nc",
    "aerosol_lw": "rrtmgp-aerosols-merra-lw.nc",
    "aerosol_sw": "rrtmgp-aerosols-merra-sw.nc",
}


class ManifestError(ValueError):
    """A data file does not match the expected rrtmgp-data structure."""


def validate_structure(ds: Dataset, kind: str) -> list[str]:
    """Version-agnostic structural validation; returns a list of problems
    (empty = valid). ``kind``: gas_lw | gas_sw | cloud | aerosol."""
    manifest = _MANIFESTS[kind]
    problems: list[str] = []
    for var, want_dims in manifest.items():
        if var == "plank_fraction" and var not in ds and "planck_fraction" in ds:
            var = "planck_fraction"  # both spellings occur in the wild
        if var not in ds:
            problems.append(f"missing variable {var!r}")
            continue
        dims = ds.var_dims.get(var, ())
        if dims and set(dims) != set(want_dims):
            problems.append(
                f"{var}: dimension names {sorted(dims)} != expected {sorted(want_dims)}"
            )
    if problems:
        return problems

    if kind.startswith("gas"):
        d = ds.dims
        if d.get("pressure_interp", d["pressure"] + 1) != d["pressure"] + 1:
            problems.append(
                f"pressure_interp ({d.get('pressure_interp')}) != pressure+1 ({d['pressure'] + 1})"
            )
        # band limits must tile [1, ngpt]
        lims = np.asarray(ds["bnd_limits_gpt"], np.int64).reshape(-1)
        if lims.min() != 1 or lims.max() != d["gpt"]:
            problems.append(
                f"bnd_limits_gpt spans [{lims.min()}, {lims.max()}], expected [1, {d['gpt']}]"
            )
        for side in ("lower", "upper"):
            ml = np.asarray(ds[f"minor_limits_gpt_{side}"], np.int64)
            ks = np.asarray(ds[f"kminor_start_{side}"], np.int64)
            n_itv = d[f"minor_absorber_intervals_{side}"]
            if n_itv == 0 or ml.size != 2 * n_itv:
                continue
            # orient (n_itv, 2) by dimension name, like the loader does
            dims_ml = ds.var_dims.get(f"minor_limits_gpt_{side}", ())
            if (dims_ml and dims_ml[0] == "pair" and n_itv != 2) or (
                not dims_ml and ml.shape == (2, n_itv) and n_itv != 2
            ):
                ml = ml.T
            if n_itv == 2 and dims_ml == ("pair", f"minor_absorber_intervals_{side}"):
                ml = ml.T
            ml = ml.reshape(n_itv, 2)
            widths = np.abs(ml[:, 1] - ml[:, 0]) + 1
            n_contrib = d[f"contributors_{side}"]
            if int(ks.max() - 1 + widths[np.argmax(ks)]) > n_contrib:
                problems.append(
                    f"kminor_start_{side} + interval width exceeds "
                    f"contributors_{side} ({n_contrib})"
                )
    return problems


def validate_rrtmgp_data(data_dir: str, strict_v19: bool = True) -> dict[str, list[str]]:
    """Validate a user-supplied rrtmgp-data checkout before first use.

    Returns {filename: [problems]} for the files present; raises
    :class:`ManifestError` if any present file is structurally invalid (or,
    with ``strict_v19``, deviates from the known v1.9 gas-grid dimensions).
    Missing files are reported but do not raise — a caller may only need the
    clear-sky subset.
    """
    report: dict[str, list[str]] = {}
    fatal = False
    for key, fname in V19_FILES.items():
        path = os.path.join(data_dir, fname)
        if not os.path.exists(path):
            # reported, but NOT fatal: a caller may only need the clear-sky
            # subset of the checkout
            report[fname] = ["file not present"]
            continue
        kind = "gas_lw" if key == "gas_lw" else (
            "gas_sw" if key == "gas_sw" else ("cloud" if "cloud" in key else "aerosol")
        )
        ds = Dataset(path)
        problems = validate_structure(ds, kind)
        if strict_v19 and kind in V19_GAS_DIMS:
            for dim, size in V19_GAS_DIMS[kind].items():
                got = ds.dims.get(dim)
                if got is not None and got != size:
                    problems.append(f"dim {dim} = {got}, v1.9 expects {size}")
        report[fname] = problems
        fatal = fatal or bool(problems)
    if fatal:
        msgs = "; ".join(f"{f}: {', '.join(p)}" for f, p in report.items() if p)
        raise ManifestError(f"rrtmgp-data validation failed: {msgs}")
    return report
