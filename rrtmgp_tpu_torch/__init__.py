"""rrtmgp_tpu_torch — RTE+RRTMGP radiative transfer in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rrtmgp_tpu`` (JAX), which stays beside it as the reference.
Layouts match the JAX package: optics (nlay, ncol, ngpt), fluxes
(nlev, ncol) with level 0 at the surface. ``solve_lw`` (no-scattering or
two-stream) and ``solve_sw`` (two-stream or direct beam), clear sky or with
McICA clouds and MERRA aerosols, f32 or f64, ``solve_chunked`` and the
``RRTMGPSolver`` API over them, run the CUDA kernels of ``ops.mega`` /
``ops.aerosol_bands`` on CUDA tensors and plain torch on the CPU.
"""

from .angular import angular_discretization
from .api import (
    AEROSOL_INDEX,
    AllSkyRadiation,
    AllSkyRadiationWithClearSkyDiagnostics,
    ClearSkyRadiation,
    GrayRadiation,
    LookupBundle,
    RRTMGPGridParams,
    RRTMGPSolver,
    aerosol_names,
    domain_view,
    gas_names_sw,
    lookup_tables,
)
from .data.lookups import (
    AerosolLookup,
    CloudLookup,
    GasLookup,
    MinorInterval,
    band_limits_to_gpt2band,
)
from .models.rrtmgp import FluxLW, FluxSW, SolveDiagnostics, solve_chunked, solve_lw, solve_sw
from .parameters import RRTMGPParameters
from .states import (
    AerosolState,
    AtmosphericState,
    CloudState,
    LwBCs,
    SwBCs,
    Vmr,
    VmrGM,
    compute_col_gas,
    compute_relative_humidity,
    get_vmr,
)

__all__ = [
    "AEROSOL_INDEX", "AerosolLookup", "AerosolState", "AllSkyRadiation",
    "AllSkyRadiationWithClearSkyDiagnostics", "AtmosphericState", "ClearSkyRadiation",
    "CloudLookup", "CloudState", "FluxLW", "FluxSW", "GasLookup", "GrayRadiation",
    "LookupBundle", "LwBCs", "MinorInterval", "RRTMGPGridParams", "RRTMGPParameters",
    "RRTMGPSolver", "SolveDiagnostics", "SwBCs", "Vmr", "VmrGM", "aerosol_names",
    "angular_discretization", "band_limits_to_gpt2band", "compute_col_gas",
    "compute_relative_humidity", "domain_view", "gas_names_sw", "get_vmr",
    "lookup_tables", "solve_chunked", "solve_lw", "solve_sw",
]
