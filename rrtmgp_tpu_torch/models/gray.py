"""Gray-atmosphere radiation model (counterpart of
``rrtmgp_tpu/models/gray.py``): the zero-data model family, analytic
optical thickness with sigma T^4 / pi sources, solved by the plain-torch
RTE of ``ops.rte`` (the JAX package solves it with XLA, not Pallas).

Layout: (nlay, ncol) / (nlay+1, ncol), level 0 = surface.

``gray_lw_equilibrium`` iterates the LW solve and the profile update to
radiative equilibrium with the semantics of the JAX package's
``lax.while_loop``: it stops at the first step whose flux-gradient error
is below ``flux_grad_tol``, or at ``max_steps``. The state lives in device
tensors; once the criterion holds, a device-side flag freezes it, so the
host reads the flag once per ``block`` steps instead of every step, and on
the card one block runs as a captured CUDA graph. Any ``block`` gives the
bits of the step-by-step loop (``block=1``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..angular import angular_discretization
from ..convert import default_device
from ..ops import rte
from ..parameters import RRTMGPParameters, pow_fast
from ..states import TensorContainer

# ---------------------------------------------------------------------------
# Optical-thickness parameterizations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrayOpticalThicknessSchneider2004:
    """Schneider 2004 (JAS 61, 1317) gray LW optical-thickness parameters."""

    alpha: float = 3.5  # lapse-rate exponent
    te: float = 300.0   # global-mean surface temperature [K]
    tt: float = 200.0   # TOA skin temperature [K]
    dt: float = 60.0    # equator-pole temperature difference [K]


@dataclasses.dataclass(frozen=True)
class GrayOpticalThicknessOGorman2008:
    """O'Gorman 2008 (J. Climate 21, 3815) gray optical-thickness parameters."""

    alpha: float = 1.0   # scaling factor
    fl: float = 0.2      # linear-term weight
    tau_e: float = 7.2   # LW optical thickness at equator
    tau_p: float = 1.8   # LW optical thickness at poles
    tau_0: float = 0.22  # SW optical thickness


GrayOpticalThickness = GrayOpticalThicknessSchneider2004 | GrayOpticalThicknessOGorman2008


def _deg2rad(lat):
    return lat * (math.pi / 180.0)


def gray_tau_lw(otp: GrayOpticalThickness, p0, dp, p, lat):
    """Gray LW layer optical thickness."""
    if isinstance(otp, GrayOpticalThicknessSchneider2004):
        ts_by_tt = (otp.te + otp.dt * (1.0 / 3.0 - torch.sin(_deg2rad(lat)) ** 2)) / otp.tt
        d0 = ts_by_tt**4 - 1.0
        return torch.abs((otp.alpha * d0 * pow_fast(p / p0, otp.alpha) / p) * dp)
    if isinstance(otp, GrayOpticalThicknessOGorman2008):
        sigma = p / p0
        tau = (
            (otp.alpha * dp / p)
            * (otp.fl * sigma + (1.0 - otp.fl) * 4.0 * sigma**4)
            * (otp.tau_e + (otp.tau_p - otp.tau_e) * torch.sin(_deg2rad(lat)) ** 2)
        )
        return torch.abs(tau)
    raise TypeError(f"unknown gray optical thickness parameterization: {otp!r}")


def gray_tau_sw(otp: GrayOpticalThickness, p0, dp, p, lat):
    """Gray SW layer optical thickness (zero for Schneider 2004)."""
    if isinstance(otp, GrayOpticalThicknessSchneider2004):
        return torch.zeros_like(p)
    if isinstance(otp, GrayOpticalThicknessOGorman2008):
        return torch.abs(2.0 * otp.tau_0 * (p / p0) * (dp / p0))
    raise TypeError(f"unknown gray optical thickness parameterization: {otp!r}")


# ---------------------------------------------------------------------------
# Atmospheric state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrayAtmosphericState(TensorContainer):
    """Gray atmospheric state: lat / t_sfc (ncol,), p_lay / t_lay (nlay,
    ncol), p_lev / t_lev / z_lev (nlay+1, ncol); ``otp`` is static."""

    lat: torch.Tensor
    p_lay: torch.Tensor
    p_lev: torch.Tensor
    t_lay: torch.Tensor
    t_lev: torch.Tensor
    z_lev: torch.Tensor
    t_sfc: torch.Tensor
    otp: GrayOpticalThickness

    @property
    def nlay(self) -> int:
        return self.p_lay.shape[0]

    @property
    def ncol(self) -> int:
        return self.p_lay.shape[-1]


def setup_gray_as_pr_grid(
    nlay: int,
    lat,
    p0: float,
    pe: float,
    otp: GrayOpticalThickness,
    params: RRTMGPParameters,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GrayAtmosphericState:
    """Schneider-2004 radiative-equilibrium temperature and pressure
    profiles on a linear pressure grid from ``p0`` (surface) to ``pe``.
    ``lat`` in degrees, (ncol,); ``device`` None is the card when there is
    one (``convert.default_device``)."""
    device = default_device() if device is None else device
    lat = torch.as_tensor(lat).to(device=device, dtype=dtype)
    te, tt, dt, alpha = 300.0, 200.0, 60.0, 3.5

    ts = te + dt * (1.0 / 3.0 - torch.sin(_deg2rad(lat)) ** 2)
    d0 = (ts / tt) ** 4 - 1.0  # (ncol,)

    dp = (p0 - pe) / nlay
    ilev = torch.arange(nlay + 1, dtype=dtype, device=device)
    p_lev_1d = p0 - ilev * dp
    p_lev = p_lev_1d[:, None].expand(nlay + 1, lat.shape[0]).contiguous()
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])

    def temp(p):
        return tt * (1.0 + d0[None, :] * (p / p0) ** alpha) ** 0.25

    t_lev = temp(p_lev)
    t_lay = temp(p_lay)

    # hydrostatic level altitudes
    H = params.R_d * t_lay / params.grav
    dz_lay = H * torch.log(p_lev[:-1] / p_lev[1:])
    z_lev = torch.cat([torch.zeros_like(dz_lay[:1]), torch.cumsum(dz_lay, dim=0)], dim=0)
    return GrayAtmosphericState(
        lat=lat, p_lay=p_lay, p_lev=p_lev, t_lay=t_lay, t_lev=t_lev, z_lev=z_lev,
        t_sfc=t_lev[0].clone(), otp=otp,
    )


# ---------------------------------------------------------------------------
# Gray optics and Planck sources
# ---------------------------------------------------------------------------


def gray_optics_lw(as_: GrayAtmosphericState, params: RRTMGPParameters):
    """Gray LW optical depth and sigma T^4 / pi sources: (tau, lay_source,
    lev_source, sfc_source). An interior level's source is the geometric
    mean of the sources seen from the layers below and above, both the
    level's own here (kept, as in the reference)."""
    dtype = as_.p_lay.dtype
    sbc = rte.round_to(params.Stefan, dtype)
    pi = rte.round_to(math.pi, dtype)

    dp = as_.p_lev[1:] - as_.p_lev[:-1]
    p0 = as_.p_lev[0]
    tau = gray_tau_lw(as_.otp, p0[None, :], dp, as_.p_lay, as_.lat[None, :]).to(dtype)

    def planck(t):
        return sbc * (t * t * t * t) / pi

    lay_source = planck(as_.t_lay)
    lev_src = planck(as_.t_lev)
    lev_source = torch.cat([lev_src[:1], torch.sqrt(lev_src[1:-1] * lev_src[1:-1]), lev_src[-1:]], dim=0)
    sfc_source = planck(as_.t_sfc)
    return tau, lay_source, lev_source, sfc_source


def gray_optics_sw(as_: GrayAtmosphericState) -> torch.Tensor:
    """Gray SW optical depth (nlay, ncol)."""
    dp = as_.p_lev[1:] - as_.p_lev[:-1]
    p0 = as_.p_lev[0]
    return gray_tau_sw(as_.otp, p0[None, :], dp, as_.p_lay, as_.lat[None, :]).to(as_.p_lay.dtype)


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


def solve_gray_lw(
    as_: GrayAtmosphericState,
    sfc_emis: torch.Tensor,  # (ncol,)
    params: RRTMGPParameters = RRTMGPParameters(),
    inc_flux: torch.Tensor | None = None,
    two_stream: bool = False,
    n_gauss_angles: int = 1,
):
    """Gray LW solve; returns (flux_up, flux_dn, flux_net), each (nlay+1,
    ncol). No-scattering uses the first quadrature angle only, as the
    reference does (``angular.py``)."""
    tau, lay_source, lev_source, sfc_source = gray_optics_lw(as_, params)
    if two_stream:
        zero = torch.zeros_like(tau)
        flux_up, flux_dn = rte.lw_2stream(tau, zero, zero, lev_source, sfc_source, sfc_emis, inc_flux)
    else:
        Ds, wts = angular_discretization(n_gauss_angles)
        flux_up, flux_dn = rte.lw_noscat(
            tau, lay_source, lev_source, sfc_source, sfc_emis, float(Ds[0]), float(wts[0]), inc_flux)
    return flux_up, flux_dn, flux_up - flux_dn


def solve_gray_sw(
    as_: GrayAtmosphericState,
    cos_zenith: torch.Tensor,       # (ncol,)
    toa_flux: torch.Tensor,         # (ncol,)
    sfc_alb_direct: torch.Tensor | None = None,   # (ncol,), two-stream
    sfc_alb_diffuse: torch.Tensor | None = None,  # (ncol,)
    inc_flux_diffuse: torch.Tensor | None = None,
    two_stream: bool = False,
):
    """Gray SW solve; returns (flux_up, flux_dn, flux_dn_dir, flux_net).
    Night columns (cos_zenith <= 0) are zero."""
    tau = gray_optics_sw(as_)
    if two_stream:
        zero = torch.zeros_like(tau)
        flux_up, flux_dn, flux_dn_dir = rte.sw_2stream(
            tau, zero, zero, cos_zenith, toa_flux, sfc_alb_direct, sfc_alb_diffuse, inc_flux_diffuse)
    else:
        flux_dn_dir = rte.sw_noscat(tau, cos_zenith, toa_flux)
        flux_up = torch.zeros_like(flux_dn_dir)
        flux_dn = torch.zeros_like(flux_dn_dir)
    day = (cos_zenith > 0)[None, :]
    flux_up, flux_dn, flux_dn_dir = (torch.where(day, f, 0.0) for f in (flux_up, flux_dn, flux_dn_dir))
    return flux_up, flux_dn, flux_dn_dir, flux_up - flux_dn


# ---------------------------------------------------------------------------
# Radiative equilibrium
# ---------------------------------------------------------------------------


def compute_gray_heating_rate(flux_net, p_lev, params: RRTMGPParameters):
    """Heating rate [K/s] of each layer from the net-flux divergence."""
    return params.grav * (flux_net[1:] - flux_net[:-1]) / (p_lev[1:] - p_lev[:-1]) / params.cp_d


def update_profile_lw(t_lay, t_lev, flux_dn, flux_net, hr_lay, dt_sec, params: RRTMGPParameters):
    """One explicit step of the gray radiative-equilibrium iteration: layer
    temperatures by the heating rate, level temperatures by the reference's
    one-sided stencil; with the analytic equilibrium level temperature and
    the flux-gradient measure. Returns (t_lay, t_lev, T_ex_lev, flux_grad)."""
    nlay = t_lay.shape[0]
    t_lay = t_lay + dt_sec * hr_lay
    # t_lev[i] = t_lay[i-1]/3 + 5/6 t_lay[i] - 1/6 t_lay[i+1], i = 1..nlay-2,
    # then the reference's rows at the bottom and top
    interior = t_lay[:-2] / 3.0 + (5.0 / 6.0) * t_lay[1:-1] - (1.0 / 6.0) * t_lay[2:]
    t_lev_nlaym1 = t_lay[nlay - 1] / 3.0 + (5.0 / 6.0) * t_lay[nlay - 2] - (1.0 / 6.0) * t_lay[nlay - 3]
    mid = torch.cat([interior, t_lev_nlaym1[None]], dim=0)
    t_lev_0 = 2.0 * t_lay[0] - mid[0]
    t_lev_top = 2.0 * t_lay[nlay - 1] - mid[-1]
    t_lev = torch.cat([t_lev_0[None], mid, t_lev_top[None]], dim=0)

    T_ex_lev = torch.sqrt(torch.sqrt((flux_dn + 0.5 * flux_net) / params.Stefan))
    flux_grad = torch.abs(flux_net[1:] - flux_net[:-1])
    return t_lay, t_lev, T_ex_lev, flux_grad


class _Equilibrium:
    """The loop state of ``gray_lw_equilibrium`` in device tensors, and one
    step that leaves it unchanged once the loop's condition fails."""

    def __init__(self, as_, sfc_emis, params, dt_sec, max_steps, flux_grad_tol, two_stream):
        self.as_, self.sfc_emis, self.params = as_, sfc_emis, params
        self.dt_sec, self.max_steps, self.tol, self.two_stream = dt_sec, max_steps, flux_grad_tol, two_stream
        dev, dtype = as_.t_lay.device, as_.t_lay.dtype
        self.t_lay, self.t_lev = as_.t_lay.clone(), as_.t_lev.clone()
        self.T_ex = torch.zeros_like(as_.t_lev)
        self.err = torch.full((), math.inf, dtype=dtype, device=dev)
        self.step = torch.zeros((), dtype=torch.int32, device=dev)

    def running(self) -> torch.Tensor:
        """``lax.while_loop``'s condition, on the device."""
        return (self.step < self.max_steps) & (self.err >= self.tol)

    def advance(self, t_lay, t_lev, T_ex, err, step):
        """One body of the loop on the given state tensors, written into
        them where the condition holds."""
        go = (step < self.max_steps) & (err >= self.tol)
        atm = dataclasses.replace(self.as_, t_lay=t_lay, t_lev=t_lev)
        _, flux_dn, flux_net = solve_gray_lw(atm, self.sfc_emis, self.params, two_stream=self.two_stream)
        hr_lay = compute_gray_heating_rate(flux_net, atm.p_lev, self.params)
        new_lay, new_lev, new_T_ex, flux_grad = update_profile_lw(
            t_lay, t_lev, flux_dn, flux_net, hr_lay, self.dt_sec, self.params)
        new_err = torch.max(flux_grad).to(err.dtype)
        t_lay.copy_(torch.where(go, new_lay, t_lay))
        t_lev.copy_(torch.where(go, new_lev, t_lev))
        T_ex.copy_(torch.where(go, new_T_ex, T_ex))
        err.copy_(torch.where(go, new_err, err))
        step.add_(go.to(step.dtype))

    def state(self):
        return self.t_lay, self.t_lev, self.T_ex, self.err, self.step


def gray_lw_equilibrium(
    as_: GrayAtmosphericState,
    sfc_emis: torch.Tensor,
    params: RRTMGPParameters = RRTMGPParameters(),
    dt_sec: float = 21600.0,
    max_steps: int = 58400,
    flux_grad_tol: float = 1e-5,
    two_stream: bool = False,
    block: int = 64,
):
    """Iterate the gray LW solve and the profile update to radiative
    equilibrium: stop at the first step whose largest flux gradient is below
    ``flux_grad_tol``, or after ``max_steps``. Returns (as_, T_ex_lev,
    flux_grad_err, n_steps), the last two 0-dim tensors.

    The host reads the stopping condition once per ``block`` steps; steps
    past it leave the state unchanged. On CUDA tensors with ``block > 1``
    one block is captured as a CUDA graph and replayed (the same launches,
    without their host cost). ``block=1`` is the step-by-step loop, with the
    same bits as any other block."""
    if block < 1:
        raise ValueError(f"block={block}: need at least one step per block")
    eq = _Equilibrium(as_, sfc_emis, params, dt_sec, max_steps, flux_grad_tol, two_stream)
    if as_.t_lay.is_cuda and block > 1:
        run = _captured_block(eq, block)
    else:
        def run():
            for _ in range(block):
                eq.advance(*eq.state())
    while bool(eq.running()):
        run()
    out = dataclasses.replace(as_, t_lay=eq.t_lay, t_lev=eq.t_lev)
    return out, eq.T_ex, eq.err, eq.step


def _captured_block(eq: _Equilibrium, block: int):
    """``block`` steps of ``eq`` captured as a CUDA graph on its state
    tensors; returns the replay. Warmed up on copies of the state first, so
    the capture advances nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scratch = [x.clone() for x in eq.state()]
        eq.advance(*scratch)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(block):
            eq.advance(*eq.state())
    return graph.replay
