"""Physical constants (counterpart of ``rrtmgp_tpu/parameters.py``).

Defaults are the standard ClimaParams values used by the reference
parameter struct ``RRTMGPParameters{FT}``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RRTMGPParameters:
    """Physical constants used by optics and source computations.

    All values are Python floats; they are cast to the working dtype where
    they meet a tensor.
    """

    grav: float = 9.81                   # gravitational acceleration [m/s^2]
    molmass_dryair: float = 0.02897      # molar mass of dry air [kg/mol]
    molmass_water: float = 0.01801528    # molar mass of water [kg/mol]
    gas_constant: float = 8.3144598      # universal gas constant [J/mol/K]
    kappa_d: float = 2.0 / 7.0           # adiabatic exponent, dry air
    Stefan: float = 5.67e-8              # Stefan-Boltzmann constant [W/m^2/K^4]
    avogad: float = 6.02214076e23        # Avogadro constant [1/mol]

    @property
    def R_d(self) -> float:
        return self.gas_constant / self.molmass_dryair

    @property
    def cp_d(self) -> float:
        return self.R_d / self.kappa_d
