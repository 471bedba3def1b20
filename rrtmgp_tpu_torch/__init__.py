"""rrtmgp_tpu_torch — RTE+RRTMGP radiative transfer in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``rrtmgp_tpu`` (JAX), which stays beside it as the reference.
Layouts match the JAX package: optics (nlay, ncol, ngpt), fluxes
(nlev, ncol) with level 0 at the surface. This slice covers the clear-sky
main path: ``solve_lw`` (LW no-scattering) and ``solve_sw`` (SW
two-stream), with the CUDA megakernels of ``ops.mega`` on CUDA tensors and
plain torch on the CPU.
"""

from .angular import angular_discretization
from .data.lookups import GasLookup, MinorInterval, band_limits_to_gpt2band
from .models.rrtmgp import FluxLW, FluxSW, SolveDiagnostics, solve_lw, solve_sw
from .parameters import RRTMGPParameters
from .states import (
    AtmosphericState,
    LwBCs,
    SwBCs,
    Vmr,
    VmrGM,
    compute_col_gas,
    get_vmr,
)

__all__ = [
    "AtmosphericState", "FluxLW", "FluxSW", "GasLookup", "LwBCs", "MinorInterval",
    "RRTMGPParameters", "SolveDiagnostics", "SwBCs", "Vmr", "VmrGM",
    "angular_discretization", "band_limits_to_gpt2band", "compute_col_gas",
    "get_vmr", "solve_lw", "solve_sw",
]
