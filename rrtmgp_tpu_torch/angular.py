"""Gauss-Jacobi-5 angular quadrature for the LW no-scattering solver
(counterpart of ``rrtmgp_tpu/angular.py``; numpy only).

Values from Table 1, R. J. Hogan 2023, doi:10.1002/qj.4598. The solvers use
the first angle's secant ``Ds`` and weight unless more angles are requested.
"""

from __future__ import annotations

import numpy as np

_GAUSS_MU = {
    1: ([0.6096748751], [1.0]),
    2: ([0.2509907356, 0.7908473988], [0.2300253764, 0.7699746236]),
    3: ([0.1024922169, 0.4417960320, 0.8633751621], [0.0437820218, 0.3875796738, 0.5686383044]),
    4: (
        [0.0454586727, 0.2322334416, 0.5740198775, 0.9030775973],
        [0.0092068785, 0.1285704278, 0.4323381850, 0.4298845087],
    ),
}


def angular_discretization(n_gauss_angles: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Return (secants Ds, weights) for ``n_gauss_angles`` in [1, 4]."""
    if not 1 <= n_gauss_angles <= 4:
        raise ValueError(f"n_gauss_angles must be in [1,4], got {n_gauss_angles}")
    mu, wts = _GAUSS_MU[n_gauss_angles]
    return 1.0 / np.asarray(mu, dtype=np.float64), np.asarray(wts, dtype=np.float64)
