"""RTE vertical-transport solvers in plain torch (counterpart of
``rrtmgp_tpu/ops/rte.py``): LW no-scattering, LW two-stream, SW
direct-beam only and SW two-stream.

Layer recurrences are Python loops over layers; each step works on whole
(*B) batches (columns x g-points). Per-layer coefficients are computed inside
the loops, so only what the second sweep needs is kept for every layer.

Index convention: level 0 = surface, level nlay = top of atmosphere; layer i
spans levels i -> i+1. Functions return ``(flux_up, flux_dn, ...)``.
"""

from __future__ import annotations

import math

import torch

from .bounds import at_least


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _level(x, like: torch.Tensor, shape: torch.Size | None = None) -> torch.Tensor:
    """One level of a recurrence as a preallocated buffer of levels shaped
    ``shape`` (default ``like.shape``) in ``like``'s dtype would store it:
    cast and broadcast. The recurrences keep their levels in lists and
    stack them at the end, so that no tensor is written after autograd saved
    it and gradients pass through."""
    dtype, shape = like.dtype, like.shape if shape is None else shape
    if not isinstance(x, torch.Tensor):
        return torch.full(shape, x, dtype=dtype, device=like.device)
    if x.dtype != dtype:
        x = x.to(dtype)
    return x if x.shape == shape else x.expand(shape)


def round_to(x: float, dtype) -> float:
    """Python float rounded to ``dtype`` (constants enter the arithmetic at
    the working precision, as in the JAX package)."""
    return float(torch.tensor(x, dtype=dtype))


def intensity_to_flux(w_mu: float, dtype) -> float:
    """pi * w_mu as the working precision computes it."""
    return round_to(round_to(math.pi, dtype) * round_to(w_mu, dtype), dtype)


# ---------------------------------------------------------------------------
# Longwave, no scattering (single angle)
# ---------------------------------------------------------------------------


def lw_noscat(
    tau: torch.Tensor,         # (nlay, *B) optical depth
    lay_source: torch.Tensor,  # (nlay, *B) layer Planck source (intensity units)
    lev_source: torch.Tensor,  # (nlay+1, *B) level Planck source
    sfc_source: torch.Tensor,  # (*B,) surface Planck source
    sfc_emis: torch.Tensor,    # (*B,) surface emissivity
    Ds: float,                 # secant of propagation angle
    w_mu: float,               # quadrature weight
    inc_flux: torch.Tensor | None = None,  # (*B,) incident flux at TOA
) -> tuple[torch.Tensor, torch.Tensor]:
    """LW no-scattering transport; returns (flux_up, flux_dn), each (nlay+1, *B).

    Linear-in-tau source (Clough et al. 1992 Eq 13) with a 3-term Taylor
    series below tau_thresh = 100 eps.
    """
    dtype = tau.dtype
    tau_thresh = 100.0 * _eps(dtype)
    i2f = intensity_to_flux(w_mu, dtype)
    ds = round_to(Ds, dtype)
    nlay = tau.shape[0]

    lev, lay = lev_source[0], tau[0]  # a level's and a layer's dtype and shape
    i_dn = [None] * (nlay + 1)
    i_dn[nlay] = _level(0.0 if inc_flux is None else inc_flux / i2f, lev)
    trans_all = [None] * nlay
    src_up_all = [None] * nlay
    # downward recurrence, TOA -> surface: I[l] = trans[l]*I[l+1] + src_dn[l];
    # the emission toward the surface uses the layer's bottom level source,
    # the emission toward space its top level source
    for l in range(nlay - 1, -1, -1):
        tau_loc = tau[l] * ds
        trans = torch.exp(-tau_loc)
        big = tau_loc > tau_thresh
        fact = torch.where(
            big,
            (1.0 - trans) / torch.where(big, tau_loc, 1.0) - trans,
            tau_loc * (0.5 + tau_loc * (-1.0 / 3.0 + tau_loc * 0.125)),
        )
        src_dn = (1.0 - trans) * lev_source[l] + 2.0 * fact * (lay_source[l] - lev_source[l])
        src_up_all[l] = _level((1.0 - trans) * lev_source[l + 1] + 2.0 * fact * (
            lay_source[l] - lev_source[l + 1]
        ), lay)
        trans_all[l] = _level(trans, lay)
        i_dn[l] = _level(trans * i_dn[l + 1] + src_dn, lev)

    # surface reflection + emission, then the upward recurrence
    i_up = [_level(i_dn[0] * (1.0 - sfc_emis) + sfc_emis * sfc_source, lev)]
    for l in range(nlay):
        i_up.append(_level(trans_all[l] * i_up[l] + src_up_all[l], lev))
    del trans_all, src_up_all
    dn = torch.stack(i_dn).mul_(i2f)
    del i_dn
    return torch.stack(i_up).mul_(i2f), dn


# ---------------------------------------------------------------------------
# Longwave two-stream
# ---------------------------------------------------------------------------


def lw_2stream_coeffs(tau, ssa, g, lev_src_bot, lev_src_top):
    """Meador-Weaver diffuse R/T + Toon-1989 linear-in-tau layer sources
    (flux units). Elementwise; returns (Rdif, Tdif, src_up, src_dn)."""
    dtype = tau.dtype
    eps = _eps(dtype)
    k_min = eps ** 0.5
    tau_thresh = 100.0 * eps
    lw_diff_sec = 1.66
    pi = round_to(math.pi, dtype)

    gamma1 = lw_diff_sec * (1.0 - 0.5 * ssa * (1.0 + g))
    gamma2 = lw_diff_sec * 0.5 * ssa * (1.0 - g)
    k = torch.sqrt(at_least((gamma1 + gamma2) * (gamma1 - gamma2), k_min))

    coeff = torch.exp(-2.0 * tau * k)
    rt_term = 1.0 / (k * (1.0 + coeff) + gamma1 * (1.0 - coeff))
    Rdif = rt_term * gamma2 * (1.0 - coeff)            # MW Eq 25
    Tdif = rt_term * 2.0 * k * torch.exp(-tau * k)     # MW Eq 26

    # Toon et al. 1989 Eqs 26-27
    big = tau > tau_thresh
    tau_safe = torch.where(big, tau, 1.0)
    Z = (lev_src_bot - lev_src_top) / (tau_safe * (gamma1 + gamma2))
    Zup_top = Z + lev_src_top
    Zup_bottom = Z + lev_src_bot
    Zdn_top = -Z + lev_src_top
    Zdn_bottom = -Z + lev_src_bot
    src_up = torch.where(big, pi * (Zup_top - Rdif * Zdn_top - Tdif * Zup_bottom), 0.0)
    src_dn = torch.where(big, pi * (Zdn_bottom - Rdif * Zup_bottom - Tdif * Zdn_top), 0.0)
    return Rdif, Tdif, src_up, src_dn


def lw_2stream(
    tau: torch.Tensor,         # (nlay, *B)
    ssa: torch.Tensor,         # (nlay, *B)
    g: torch.Tensor,           # (nlay, *B)
    lev_source: torch.Tensor,  # (nlay+1, *B)
    sfc_source: torch.Tensor,  # (*B,)
    sfc_emis: torch.Tensor,    # (*B,)
    inc_flux: torch.Tensor | None = None,  # (*B,)
) -> tuple[torch.Tensor, torch.Tensor]:
    """LW two-stream adding; returns (flux_up, flux_dn), each (nlay+1, *B)."""
    nlay = tau.shape[0]
    pi = round_to(math.pi, tau.dtype)
    Rdif, Tdif, src_up, src_dn = ([None] * nlay for _ in range(4))
    for l in range(nlay):
        Rdif[l], Tdif[l], src_up[l], src_dn[l] = (_level(x, tau[0]) for x in lw_2stream_coeffs(
            tau[l], ssa[l], g[l], lev_source[l], lev_source[l + 1]
        ))
    flux_dn_top = 0.0 if inc_flux is None else inc_flux
    return _adding(
        Rdif, Tdif, src_up, src_dn, 1.0 - sfc_emis, pi * sfc_emis * sfc_source, flux_dn_top
    )


# ---------------------------------------------------------------------------
# Shortwave, direct beam only
# ---------------------------------------------------------------------------


def sw_noscat(tau: torch.Tensor, mu0: torch.Tensor, toa_flux: torch.Tensor) -> torch.Tensor:
    """Direct-beam extinction; returns flux_dn_dir (nlay+1, *B): the TOA beam
    times exp(-(optical depth above the level) / mu0)."""
    mu0_safe = at_least(mu0, _eps(tau.dtype))
    tau_above = torch.flip(torch.cumsum(torch.flip(tau, (0,)), dim=0), (0,))
    tau_to_lev = torch.cat([tau_above, torch.zeros_like(tau_above[:1])], dim=0)
    return toa_flux * mu0 * torch.exp(-tau_to_lev / mu0_safe)


# ---------------------------------------------------------------------------
# Shortwave two-stream
# ---------------------------------------------------------------------------


def sw_2stream_coeffs(tau, ssa, g, mu0):
    """Zdunkowski PIFM gammas + Meador-Weaver direct R/T with energy clamps.

    Elementwise over broadcastable arguments; ``g`` may be a tensor or a
    Python float (0.0 for clear sky). Returns (Rdir, Tdir, T0, Rdif, Tdif).
    ``mu0`` enters unguarded except in the beam transmittance T0.
    """
    dtype = tau.dtype
    eps = _eps(dtype)
    k_min = eps ** 0.5

    gamma1 = (8.0 - ssa * (5.0 + 3.0 * g)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - g)) * 0.25
    gamma3 = (2.0 - (3.0 * mu0) * g) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3   # Eq 16
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4   # Eq 17
    k = torch.sqrt(at_least((gamma1 - gamma2) * (gamma1 + gamma2), k_min))

    exp_minusktau = torch.exp(-tau * k)
    exp_minus2ktau = exp_minusktau * exp_minusktau

    rt_term = 1.0 / (k * (1.0 + exp_minus2ktau) + gamma1 * (1.0 - exp_minus2ktau))
    Rdif = rt_term * gamma2 * (1.0 - exp_minus2ktau)  # Eq 25
    Tdif = rt_term * 2.0 * k * exp_minusktau          # Eq 26

    T0 = torch.exp(-tau / at_least(mu0, eps))  # direct transmittance

    k_mu = k * mu0
    k_gamma3 = k * gamma3
    k_gamma4 = k * gamma4

    # Eq 14/15 with the reference's div-by-zero guard
    one_minus_kmu2 = 1.0 - k_mu * k_mu
    denom_safe = torch.where(torch.abs(one_minus_kmu2) >= eps, one_minus_kmu2, eps)
    rt_term2 = ssa * rt_term / denom_safe

    Rdir_unc = rt_term2 * (
        (1.0 - k_mu) * (alpha2 + k_gamma3)
        - (1.0 + k_mu) * (alpha2 - k_gamma3) * exp_minus2ktau
        - 2.0 * (k_gamma3 - alpha2 * k_mu) * exp_minusktau * T0
    )
    Tdir_unc = -rt_term2 * (
        (1.0 + k_mu) * (alpha1 + k_gamma4) * T0
        - (1.0 - k_mu) * (alpha1 - k_gamma4) * exp_minus2ktau * T0
        - 2.0 * (k_gamma4 + alpha1 * k_mu) * exp_minusktau
    )
    # energy conservation clamps (Hogan/Ukkonen)
    zero = tau.new_zeros(())
    Rdir = torch.maximum(zero, torch.minimum(Rdir_unc, 1.0 - T0))
    Tdir = torch.maximum(zero, torch.minimum(Tdir_unc, 1.0 - T0 - Rdir))
    return Rdir, Tdir, T0, Rdif, Tdif


def _adding(Rdif, Tdif, src_up, src_dn, albedo_sfc, src_sfc, flux_dn_top):
    """Shonk-Hogan adding over the layers' lists of coefficients and sources:
    bottom-up albedo/source (Eqs 9-11), then the top-down diffuse flux (Eqs
    12-13). Returns diffuse (flux_up, flux_dn) at all levels, stacked. A
    level's albedo and source are dropped once its upward flux is formed, so
    at most three level fields are alive at a time."""
    nlay = len(Rdif)
    lev = Rdif[0]  # a level's dtype and shape
    albedo = [_level(albedo_sfc, lev)]
    src = [_level(src_sfc, lev)]
    for l in range(nlay):
        denom = 1.0 / (1.0 - Rdif[l] * albedo[l])                                     # Eq 10
        albedo.append(Rdif[l] + Tdif[l] * Tdif[l] * albedo[l] * denom)                # Eq 9
        src.append(src_up[l] + Tdif[l] * denom * (src[l] + albedo[l] * src_dn[l]))    # Eq 11

    flux_dn = [None] * (nlay + 1)
    flux_up = [None] * (nlay + 1)
    flux_dn[nlay] = _level(flux_dn_top, lev)
    for l in range(nlay, -1, -1):
        if l < nlay:
            denom = 1.0 / (1.0 - Rdif[l] * albedo[l])
            flux_dn[l] = (Tdif[l] * flux_dn[l + 1] + Rdif[l] * src[l] + src_dn[l]) * denom  # Eq 13
        flux_up[l] = albedo[l] * flux_dn[l] + src[l]  # Eq 12
        albedo[l] = src[l] = None
    flux_up = torch.stack(flux_up)
    return flux_up, torch.stack(flux_dn)


def sw_2stream(
    tau: torch.Tensor,              # (nlay, *B)
    ssa: torch.Tensor,              # (nlay, *B)
    g,                              # (nlay, *B) tensor, or 0.0 for clear sky
    mu0: torch.Tensor,              # (*B,) (broadcastable)
    toa_flux: torch.Tensor,         # (*B,) TOA flux (already x solar_frac)
    sfc_alb_direct: torch.Tensor,   # (*B,)
    sfc_alb_diffuse: torch.Tensor,  # (*B,)
    inc_flux_diffuse: torch.Tensor | None = None,  # (*B,)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SW two-stream; returns (flux_up, flux_dn_total, flux_dn_dir), (nlay+1, *B).

    Night columns (mu0 <= 0) must be zeroed by the caller, as in the
    reference.
    """
    dtype = tau.dtype
    mu0_safe = at_least(mu0, _eps(dtype))
    nlay = tau.shape[0]
    batch = torch.broadcast_shapes(tau.shape[1:], mu0.shape, toa_flux.shape)
    lev = (tau[0], batch)

    # direct beam at every level from the optical depth summed down from TOA
    flux_dn_dir = [None] * (nlay + 1)
    flux_dn_dir[nlay] = _level(toa_flux * mu0, *lev)
    tau_above = torch.zeros_like(tau[0])
    for l in range(nlay - 1, -1, -1):
        tau_above = tau_above + tau[l]
        flux_dn_dir[l] = _level(flux_dn_dir[nlay] * torch.exp(-tau_above / mu0_safe), *lev)

    Rdif, Tdif, src_up, src_dn = ([None] * nlay for _ in range(4))
    for l in range(nlay):
        g_l = g[l] if isinstance(g, torch.Tensor) else g
        Rdir, Tdir, _, rdif, tdif = sw_2stream_coeffs(tau[l], ssa[l], g_l, mu0)
        Rdif[l], Tdif[l] = _level(rdif, *lev), _level(tdif, *lev)
        # layer direct sources use the direct beam at the top of the layer
        src_up[l] = _level(Rdir * flux_dn_dir[l + 1], *lev)
        src_dn[l] = _level(Tdir * flux_dn_dir[l + 1], *lev)

    flux_dn_top = 0.0 if inc_flux_diffuse is None else inc_flux_diffuse
    flux_up, flux_dn = _adding(
        Rdif, Tdif, src_up, src_dn, sfc_alb_diffuse,
        flux_dn_dir[0] * sfc_alb_direct, flux_dn_top,
    )
    flux_dn_dir = torch.stack(flux_dn_dir)
    return flux_up, flux_dn.add_(flux_dn_dir), flux_dn_dir
