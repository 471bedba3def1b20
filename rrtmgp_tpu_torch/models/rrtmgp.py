"""Clear-sky RRTMGP radiation solves (counterpart of
``rrtmgp_tpu/models/rrtmgp.py``): LW no-scattering and SW two-stream.

Two implementations of the same functions, chosen by ``impl``:

- ``"kernel"``: the hand-written CUDA kernels of ``ops.mega`` (band Planck,
  then one kernel for the whole solve), fed by ``ops.mega_inputs``. CUDA
  tensors, f32.
- ``"torch"``: plain torch, ``ops.gas_optics`` then ``ops.rte``; any device,
  f32 or f64.

``impl=None`` picks ``"kernel"`` for CUDA tensors and ``"torch"`` otherwise.
What this slice does not cover raises ``NotImplementedError`` naming the
ROADMAP item that will add it. Fluxes are (nlay+1, ncol), level 0 = surface.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..angular import angular_discretization
from ..data.lookups import GasLookup
from ..ops import rte
from ..ops.gas_optics import gas_optics_lw, gas_optics_sw, gpt2band
from ..ops.mega import lw_clear_mega, planck_band, sw_clear_mega
from ..ops.mega_inputs import mega_lw_inputs, mega_sw_inputs
from ..states import AtmosphericState, LwBCs, SwBCs


class FluxLW(NamedTuple):
    flux_up: torch.Tensor  # (nlev, ncol)
    flux_dn: torch.Tensor
    flux_net: torch.Tensor


class FluxSW(NamedTuple):
    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_dn_dir: torch.Tensor
    flux_net: torch.Tensor


class SolveDiagnostics(NamedTuple):
    cld_cover: torch.Tensor | None = None   # (ncol,) McICA cloud cover
    aod_sw_ext: torch.Tensor | None = None  # (ncol,) aerosol optical depth at 550 nm
    aod_sw_sca: torch.Tensor | None = None


IMPLS = ("kernel", "torch")


def _resolve_impl(impl: str | None, device: torch.device) -> str:
    if impl is None:
        return "kernel" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(
            f"impl='kernel' runs the CUDA kernels and needs CUDA tensors, got {device}"
        )
    return impl


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {item})")


def _reject_all_sky(lkp_cld, lkp_aero, cld_mask) -> None:
    if lkp_cld is not None or cld_mask is not None:
        _not_ported("cloud optics (lkp_cld / cld_mask)", "item 8, the all-sky slice")
    if lkp_aero is not None:
        _not_ported("aerosol optics (lkp_aero)", "item 8, the all-sky slice")


def _apply_metric_scaling(flux, metric_scaling):
    """Deep-atmosphere metric scaling of every flux field."""
    if metric_scaling is None:
        return flux
    return type(flux)(*(f * metric_scaling for f in flux))


def solve_lw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: LwBCs,
    *,
    two_stream: bool = False,
    n_gauss_angles: int = 1,
    lkp_cld=None,
    lkp_aero=None,
    cld_mask: torch.Tensor | None = None,
    metric_scaling: torch.Tensor | None = None,
    eta_node_mode: str = "continuous",
    impl: str | None = None,
) -> tuple[FluxLW, SolveDiagnostics]:
    """Longwave no-scattering flux solve over all g-points."""
    _reject_all_sky(lkp_cld, lkp_aero, cld_mask)
    if two_stream:
        _not_ported("the LW two-stream solve (two_stream=True)", "item 8, the all-sky slice")
    impl = _resolve_impl(impl, as_.p_lay.device)
    Ds, wts = angular_discretization(n_gauss_angles)

    if impl == "kernel":
        if n_gauss_angles != 1:
            _not_ported("the multi-angle LW kernel (n_gauss_angles > 1)", "item 10")
        tabs = lkp.kernel_tables
        inp = mega_lw_inputs(lkp, as_, eta_node_mode)
        plk = lambda t: planck_band(
            t.reshape(-1), lkp.totplnk, lkp.t_planck_min, lkp.t_planck_delta
        )
        flux_up, flux_dn = lw_clear_mega(
            inp, tabs, plk(as_.t_lay), plk(as_.t_lev), plk(as_.t_sfc),
            bcs.sfc_emis, bcs.inc_flux, float(Ds[0]), float(wts[0]),
        )
    else:
        optics = gas_optics_lw(lkp, as_, eta_node_mode=eta_node_mode)
        src = optics.sources
        sfc_emis = bcs.sfc_emis.T[:, gpt2band(lkp)]  # (ncol, ngpt)
        flux_up = flux_dn = 0.0
        # Gauss-Jacobi weights sum to 1, so the TOA incident flux splits by
        # weight and every angle sees the same isotropic intensity
        for k in range(n_gauss_angles):
            inc_k = None if bcs.inc_flux is None else bcs.inc_flux * float(wts[k])
            up, dn = rte.lw_noscat(
                optics.tau, src.lay_source, src.lev_source, src.sfc_source,
                sfc_emis, float(Ds[k]), float(wts[k]), inc_k,
            )
            flux_up = flux_up + up.sum(-1)
            flux_dn = flux_dn + dn.sum(-1)
    flux = FluxLW(flux_up, flux_dn, flux_up - flux_dn)
    return _apply_metric_scaling(flux, metric_scaling), SolveDiagnostics()


def solve_sw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: SwBCs,
    *,
    two_stream: bool = True,
    lkp_cld=None,
    lkp_aero=None,
    cld_mask: torch.Tensor | None = None,
    metric_scaling: torch.Tensor | None = None,
    eta_node_mode: str = "continuous",
    impl: str | None = None,
) -> tuple[FluxSW, SolveDiagnostics]:
    """Shortwave two-stream flux solve over all g-points. Night columns
    (cos_zenith <= 0) produce exactly zero fluxes."""
    _reject_all_sky(lkp_cld, lkp_aero, cld_mask)
    if not two_stream:
        _not_ported("the SW direct-beam-only solve (two_stream=False)", "item 3")
    impl = _resolve_impl(impl, as_.p_lay.device)
    mu0 = bcs.cos_zenith
    toa_gpt = bcs.toa_flux[:, None] * lkp.solar_src_scaled[None, :]  # (ncol, ngpt)

    if impl == "kernel":
        tabs = lkp.kernel_tables
        inp = mega_sw_inputs(lkp, as_, eta_node_mode)
        flux_up, flux_dn, flux_dn_dir = sw_clear_mega(
            inp, tabs, mu0, toa_gpt, bcs.sfc_alb_direct, bcs.sfc_alb_diffuse,
            bcs.inc_flux_diffuse,
        )
    else:
        optics = gas_optics_sw(lkp, as_, eta_node_mode=eta_node_mode)
        g2b = gpt2band(lkp)
        # clear-sky gas optics has zero asymmetry (Rayleigh g = 0)
        up, dn, dn_dir = rte.sw_2stream(
            optics.tau, optics.ssa, 0.0, mu0[:, None], toa_gpt,
            bcs.sfc_alb_direct.T[:, g2b], bcs.sfc_alb_diffuse.T[:, g2b],
            bcs.inc_flux_diffuse,
        )
        flux_up, flux_dn, flux_dn_dir = up.sum(-1), dn.sum(-1), dn_dir.sum(-1)

    day = (mu0 > 0)[None, :]
    flux_up, flux_dn, flux_dn_dir = (
        torch.where(day, f, 0.0) for f in (flux_up, flux_dn, flux_dn_dir)
    )
    flux = FluxSW(flux_up, flux_dn, flux_dn_dir, flux_up - flux_dn)
    return _apply_metric_scaling(flux, metric_scaling), SolveDiagnostics()
