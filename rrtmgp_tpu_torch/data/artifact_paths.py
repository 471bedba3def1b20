"""rrtmgp-data artifact filename mapping (counterpart of
``rrtmgp_tpu/data/artifact_paths.py``).

Maps (optics type, band set) to the NetCDF filenames of rrtmgp-data v1.9 and
the reference test-input files, as RRTMGP.jl's ``src/ArtifactPaths.jl`` does.
The data root comes from $RRTMGP_DATA; there is no automatic download: point
RRTMGP_DATA at a checkout of
https://github.com/earth-system-radiation/rrtmgp-data at tag v1.9.
"""

from __future__ import annotations

import os

_LOOKUP_FILES = {
    # RRTMGP.jl ArtifactPaths.jl:31-38
    ("gas", "lw"): "rrtmgp-gas-lw-g256.nc",
    ("gas", "sw"): "rrtmgp-gas-sw-g224.nc",
    ("cloud", "lw"): "rrtmgp-clouds-lw-bnd.nc",
    ("cloud", "sw"): "rrtmgp-clouds-sw-bnd.nc",
    ("aerosol", "lw"): "rrtmgp-aerosols-merra-lw.nc",
    ("aerosol", "sw"): "rrtmgp-aerosols-merra-sw.nc",
}

_INPUT_FILES = {
    # RRTMGP.jl ArtifactPaths.jl:58-80
    ("clearsky", "lw"): os.path.join(
        "examples", "rfmip-clear-sky", "inputs",
        "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc",
    ),
    ("clearsky", "sw"): os.path.join(
        "examples", "rfmip-clear-sky", "inputs",
        "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc",
    ),
    ("allsky", "lw"): os.path.join(
        "examples", "all-sky", "reference", "rrtmgp-allsky-lw.nc"
    ),
    ("allsky", "sw"): os.path.join(
        "examples", "all-sky", "reference", "rrtmgp-allsky-sw.nc"
    ),
}


def data_root() -> str | None:
    return os.environ.get("RRTMGP_DATA")


def _root() -> str:
    root = data_root()
    if root is None:
        raise FileNotFoundError(
            "RRTMGP_DATA is not set; point it at an rrtmgp-data v1.9 checkout"
        )
    return root


def get_lookup_filename(optics_type: str, band_set: str) -> str:
    """Absolute path of a lookup file; optics_type in {gas, cloud, aerosol},
    band_set in {lw, sw}."""
    return os.path.join(_root(), _LOOKUP_FILES[(optics_type, band_set)])


def get_input_filename(kind: str, band_set: str) -> str:
    """Absolute path of a test-input file; kind in {clearsky, allsky}."""
    return os.path.join(_root(), _INPUT_FILES[(kind, band_set)])


_REFERENCE_FLUX_FILES = {
    # RRTMGP.jl test/reference_files.jl:15-46 (Fortran RTE-RRTMGP outputs)
    ("gas", "lw", "flux_up"): ("rfmip-clear-sky", "rlu_Efx_RTE-RRTMGP-181204_rad-irf_r1i1p1f1_gn.nc"),
    ("gas", "lw", "flux_dn"): ("rfmip-clear-sky", "rld_Efx_RTE-RRTMGP-181204_rad-irf_r1i1p1f1_gn.nc"),
    ("gas", "sw", "flux_up"): ("rfmip-clear-sky", "rsu_Efx_RTE-RRTMGP-181204_rad-irf_r1i1p1f1_gn.nc"),
    ("gas", "sw", "flux_dn"): ("rfmip-clear-sky", "rsd_Efx_RTE-RRTMGP-181204_rad-irf_r1i1p1f1_gn.nc"),
    ("gas_clouds", "lw", None): ("all-sky", "rrtmgp-allsky-lw-no-aerosols.nc"),
    ("gas_clouds", "sw", None): ("all-sky", "rrtmgp-allsky-sw-no-aerosols.nc"),
    ("gas_clouds_aerosols", "lw", None): ("all-sky", "rrtmgp-allsky-lw.nc"),
    ("gas_clouds_aerosols", "sw", None): ("all-sky", "rrtmgp-allsky-sw.nc"),
}


def get_reference_filename(problemtype: str, band_set: str, flux: str | None = None) -> str:
    """Absolute path of a Fortran RTE-RRTMGP reference-flux file.
    problemtype in {gas, gas_clouds, gas_clouds_aerosols}; flux in {flux_up,
    flux_dn} for the gas (RFMIP) files, None for the all-sky files (fluxes
    live in one file there)."""
    example, fname = _REFERENCE_FLUX_FILES[(problemtype, band_set, flux)]
    return os.path.join(_root(), "examples", example, "reference", fname)


def have_data() -> bool:
    root = data_root()
    if not root:
        return False
    return os.path.exists(os.path.join(root, _LOOKUP_FILES[("gas", "lw")]))
