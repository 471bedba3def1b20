"""rrtmgp_tpu_torch — RTE+RRTMGP radiative transfer in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rrtmgp_tpu`` (JAX), which stays beside it as the reference.
Layouts match the JAX package: optics (nlay, ncol, ngpt), fluxes
(nlev, ncol) with level 0 at the surface. ``solve_lw`` (no-scattering or
two-stream) and ``solve_sw`` (two-stream or direct beam), clear sky or with
McICA clouds and MERRA aerosols, f32 or f64, ``solve_chunked`` and the
``RRTMGPSolver`` API over them, run the CUDA kernels of ``ops.mega`` /
``ops.aerosol_bands`` on CUDA tensors and plain torch on the CPU.
``differentiable_solve_lw`` / ``_sw`` differentiate them (kernel forward,
plain-torch backward). The gray model (``models.gray``, ``GrayRadiation``)
is plain torch. ``lookup_tables(data_dir=...)`` loads the tables of an
rrtmgp-data checkout (``data.loader``, ``data.netcdf``); ``utils`` holds
profiling, accounting and debug helpers.
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
from .models.gray import (
    GrayAtmosphericState,
    GrayOpticalThicknessOGorman2008,
    GrayOpticalThicknessSchneider2004,
    compute_gray_heating_rate,
    gray_lw_equilibrium,
    setup_gray_as_pr_grid,
    solve_gray_lw,
    solve_gray_sw,
    update_profile_lw,
)
from .models.rrtmgp import (
    FluxLW,
    FluxSW,
    SolveDiagnostics,
    differentiable_solve_lw,
    differentiable_solve_sw,
    solve_chunked,
    solve_lw,
    solve_sw,
)
from .parameters import RRTMGPParameters, pow_fast
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
    "CloudLookup", "CloudState", "FluxLW", "FluxSW", "GasLookup", "GrayAtmosphericState",
    "GrayOpticalThicknessOGorman2008", "GrayOpticalThicknessSchneider2004", "GrayRadiation",
    "LookupBundle", "LwBCs", "MinorInterval", "RRTMGPGridParams", "RRTMGPParameters",
    "RRTMGPSolver", "SolveDiagnostics", "SwBCs", "Vmr", "VmrGM", "aerosol_names",
    "angular_discretization", "band_limits_to_gpt2band", "compute_col_gas",
    "compute_gray_heating_rate", "compute_relative_humidity", "differentiable_solve_lw",
    "differentiable_solve_sw", "domain_view", "gas_names_sw", "get_vmr", "gray_lw_equilibrium",
    "lookup_tables", "pow_fast", "setup_gray_as_pr_grid", "solve_chunked", "solve_gray_lw",
    "solve_gray_sw", "solve_lw", "solve_sw", "update_profile_lw",
]
