"""The sweep kernels of the two-kernel path and their plain torch twins
(counterpart of ``rrtmgp_tpu/ops/pallas_rte.py``): from optics materialized
per (layer, column, g-point) to fluxes summed over g-points.

- ``lw_noscat_banded_reduced``: LW no-scattering sweep for one angle, the
  Planck sources built in the kernel from band Planck values and the Planck
  fraction (replaces ``lw_noscat_banded_reduced``);
- ``sw_2stream_reduced``: SW two-stream sweep, the asymmetry optional
  (replaces ``sw_2stream_pallas_reduced``, blocked and streamed).

Each wrapper launches its CUDA kernel (``csrc/lw_noscat_banded.cu``,
``csrc/sw_2stream_reduced.cu``) for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it returns its twin.
``<wrapper>.launches`` counts the launches. The kernels are f32. Band-valued
boundary conditions come as the solves hold them, (nbnd, ncol), and
``gpt2band`` is the (ngpt,) int32 band of each g-point
(``KernelTables.gpt2band``).

The TPU sweeps from precomputed sources (``lw_noscat_pallas_reduced``), LW
two-stream (``lw_2stream_pallas_reduced``) and with per-g-point output
(``sw_2stream_pallas``, ``lw_noscat_pallas``) are not ported yet (ROADMAP
queue 2).
"""

from __future__ import annotations

import torch

from . import _build
from ._launch import MAX_GPT, cuda_device, ptr, require, stream
from .gas_optics import planck_sources_from_bands
from .rte import intensity_to_flux, lw_noscat, round_to, sw_2stream


def lw_noscat_banded_reduced_ref(
    tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds: float, w_mu: float, inc_flux=None,
):
    """Plain twin of ``lw_noscat_banded_reduced``: the Planck sources of
    ``ops.gas_optics.planck_sources_from_bands``, then ``ops.rte.lw_noscat``,
    summed over g-points. Any float dtype."""
    g2b = gpt2band.long()
    src = planck_sources_from_bands(g2b, plk_lay, plk_lev, plk_sfc, pfrac)
    up, dn = lw_noscat(
        tau, src.lay_source, src.lev_source, src.sfc_source, sfc_emis.T[:, g2b], ds, w_mu, inc_flux
    )
    return up.sum(-1), dn.sum(-1)


def lw_noscat_banded_reduced(
    tau: torch.Tensor,       # (nlay, ncol, ngpt) optical depth
    pfrac: torch.Tensor,     # (nlay, ncol, ngpt) Planck fraction
    plk_lay: torch.Tensor,   # (nlay, ncol, nbnd) band Planck at t_lay
    plk_lev: torch.Tensor,   # (nlay+1, ncol, nbnd) band Planck at t_lev
    plk_sfc: torch.Tensor,   # (ncol, nbnd) band Planck at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    gpt2band: torch.Tensor,  # (ngpt,) int32
    ds: float, w_mu: float,
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """LW no-scattering transport for one angle (secant ``ds``, weight
    ``w_mu``) with the sources built from band Planck values times the Planck
    fraction (level values: the geometric mean of the adjacent layers'
    fractions, the boundary levels their layer's own). Returns (flux_up,
    flux_dn), each (nlay+1, ncol), summed over g-points."""
    if tau.device.type == "cpu":
        return lw_noscat_banded_reduced_ref(
            tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds, w_mu, inc_flux)
    dev = cuda_device(tau, "lw_noscat_banded_reduced")
    if tau.dim() != 3 or plk_sfc.dim() != 2 or not 1 <= tau.shape[2] <= MAX_GPT:
        raise ValueError(f"lw_noscat_banded_reduced: tau {tuple(tau.shape)}, plk_sfc {tuple(plk_sfc.shape)}")
    nlay, ncol, ngpt = tau.shape
    nbnd = plk_sfc.shape[1]
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("pfrac", pfrac, (nlay, ncol, ngpt)),
        ("plk_lay", plk_lay, (nlay, ncol, nbnd)), ("plk_lev", plk_lev, (nlay + 1, ncol, nbnd)),
        ("plk_sfc", plk_sfc, (ncol, nbnd)), ("sfc_emis", sfc_emis, (nbnd, ncol)),
    ):
        require(x, name, shape, f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc_flux is not None:
        require(inc_flux, "inc_flux", (ncol, ngpt), f32, dev)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_noscat_banded(
            *map(ptr, (tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, inc_flux, up, dn)),
            nlay, ncol, ngpt, nbnd, round_to(ds, f32), intensity_to_flux(w_mu, f32), stream(dev),
        )
    _build.check(err, "lw_noscat_banded_reduced")
    lw_noscat_banded_reduced.launches += 1
    return up, dn


lw_noscat_banded_reduced.launches = 0


def sw_2stream_reduced_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse=None):
    """Plain twin of ``sw_2stream_reduced``: ``ops.rte.sw_2stream`` (g None
    is asymmetry 0), summed over g-points. Night columns are not zeroed. Any
    float dtype."""
    g2b = gpt2band.long()
    up, dn, dn_dir = sw_2stream(
        tau, ssa, 0.0 if g is None else g, mu0[:, None], toa_gpt,
        alb_dir.T[:, g2b], alb_dif.T[:, g2b], inc_flux_diffuse,
    )
    return up.sum(-1), dn.sum(-1), dn_dir.sum(-1)


def sw_2stream_reduced(
    tau: torch.Tensor,        # (nlay, ncol, ngpt) optical depth
    ssa: torch.Tensor,        # (nlay, ncol, ngpt) single-scattering albedo
    g: torch.Tensor | None,   # (nlay, ncol, ngpt) asymmetry; None: 0 (clear sky)
    mu0: torch.Tensor,        # (ncol,) cosine of the solar zenith angle
    toa_gpt: torch.Tensor,    # (ncol, ngpt) TOA flux per g-point
    alb_dir: torch.Tensor,    # (nbnd, ncol)
    alb_dif: torch.Tensor,    # (nbnd, ncol)
    gpt2band: torch.Tensor,   # (ngpt,) int32
    inc_flux_diffuse: torch.Tensor | None = None,  # (ncol, ngpt)
):
    """SW two-stream transport: direct beam, layer coefficients, adding and
    diffuse flux. Returns (flux_up, flux_dn, flux_dn_dir), each (nlay+1,
    ncol), summed over g-points; flux_dn includes the direct beam. Night
    columns are the caller's to zero."""
    if tau.device.type == "cpu":
        return sw_2stream_reduced_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse)
    dev = cuda_device(tau, "sw_2stream_reduced")
    if tau.dim() != 3 or alb_dir.dim() != 2 or not 1 <= tau.shape[2] <= MAX_GPT:
        raise ValueError(f"sw_2stream_reduced: tau {tuple(tau.shape)}, alb_dir {tuple(alb_dir.shape)}")
    nlay, ncol, ngpt = tau.shape
    nbnd = alb_dir.shape[0]
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("ssa", ssa, (nlay, ncol, ngpt)), ("mu0", mu0, (ncol,)),
        ("toa_gpt", toa_gpt, (ncol, ngpt)), ("alb_dir", alb_dir, (nbnd, ncol)),
        ("alb_dif", alb_dif, (nbnd, ncol)),
    ):
        require(x, name, shape, f32, dev)
    if g is not None:
        require(g, "g", (nlay, ncol, ngpt), f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc_flux_diffuse is not None:
        require(inc_flux_diffuse, "inc_flux_diffuse", (ncol, ngpt), f32, dev)
    scratch = [torch.empty((nlay, ncol, ngpt), dtype=f32, device=dev) for _ in range(4)]
    fluxes = [torch.empty((nlay + 1, ncol), dtype=f32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_sw_2stream_reduced(
            *map(ptr, (tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse,
                       *scratch, *fluxes)),
            nlay, ncol, ngpt, nbnd, stream(dev),
        )
    _build.check(err, "sw_2stream_reduced")
    sw_2stream_reduced.launches += 1
    return tuple(fluxes)


sw_2stream_reduced.launches = 0
