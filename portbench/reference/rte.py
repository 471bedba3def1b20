"""Vertical transport in plain torch: LW no-scattering (linear-in-tau
source, Clough et al. 1992), LW two-stream (Meador-Weaver coefficients,
Toon et al. 1989 sources) and SW two-stream (Zdunkowski PIFM, Meador-Weaver
direct reflection and transmission with the energy clamps), the latter two
closed by Shonk-Hogan adding. Layer loops over whole (ncol, ngpt) planes;
level 0 = surface. Each returns g-point fluxes (nlay+1, ncol, ngpt).
"""

from __future__ import annotations

import math

import torch


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def lw_noscat(tau, lay_src, lev_src, sfc_src, sfc_emis, ds: float, w: float):
    """LW no-scattering transport at secant ``ds``, quadrature weight ``w``."""
    nlay = tau.shape[0]
    thresh = 100.0 * _eps(tau.dtype)
    i2f = math.pi * w
    i_dn = [None] * (nlay + 1)
    i_dn[nlay] = torch.zeros_like(lev_src[0])
    trans, src_up = [None] * nlay, [None] * nlay
    for lay in range(nlay - 1, -1, -1):
        t = tau[lay] * ds
        tr = torch.exp(-t)
        big = t > thresh
        fact = torch.where(big, (1.0 - tr) / torch.where(big, t, 1.0) - tr,
                           t * (0.5 + t * (-1.0 / 3.0 + t * 0.125)))
        src_dn = (1.0 - tr) * lev_src[lay] + 2.0 * fact * (lay_src[lay] - lev_src[lay])
        src_up[lay] = (1.0 - tr) * lev_src[lay + 1] + 2.0 * fact * (lay_src[lay] - lev_src[lay + 1])
        trans[lay] = tr
        i_dn[lay] = tr * i_dn[lay + 1] + src_dn
    i_up = [i_dn[0] * (1.0 - sfc_emis) + sfc_emis * sfc_src]
    for lay in range(nlay):
        i_up.append(trans[lay] * i_up[lay] + src_up[lay])
    return torch.stack(i_up) * i2f, torch.stack(i_dn) * i2f


def _adding(rdif, tdif, src_up, src_dn, alb_sfc, src_sfc, flux_dn_top):
    """Shonk-Hogan adding: albedo and source of the atmosphere below each
    level, bottom up; then the diffuse fluxes top down."""
    nlay = len(rdif)
    albedo, src = [alb_sfc.expand_as(rdif[0])], [src_sfc.expand_as(rdif[0])]
    for lay in range(nlay):
        denom = 1.0 / (1.0 - rdif[lay] * albedo[lay])
        albedo.append(rdif[lay] + tdif[lay] * tdif[lay] * albedo[lay] * denom)
        src.append(src_up[lay] + tdif[lay] * denom * (src[lay] + albedo[lay] * src_dn[lay]))
    dn = [None] * (nlay + 1)
    up = [None] * (nlay + 1)
    dn[nlay] = torch.full_like(rdif[0], flux_dn_top)
    for lev in range(nlay, -1, -1):
        if lev < nlay:
            denom = 1.0 / (1.0 - rdif[lev] * albedo[lev])
            dn[lev] = (tdif[lev] * dn[lev + 1] + rdif[lev] * src[lev] + src_dn[lev]) * denom
        up[lev] = albedo[lev] * dn[lev] + src[lev]
    return torch.stack(up), torch.stack(dn)


def lw_2stream(tau, ssa, g, lev_src, sfc_src, sfc_emis):
    """LW two-stream adding; sources in intensity units."""
    eps = _eps(tau.dtype)
    pi = math.pi
    rdif, tdif, up, dn = [], [], [], []
    for lay in range(tau.shape[0]):
        t, w, gg, bot, top = tau[lay], ssa[lay], g[lay], lev_src[lay], lev_src[lay + 1]
        gamma1 = 1.66 * (1.0 - 0.5 * w * (1.0 + gg))
        gamma2 = 1.66 * 0.5 * w * (1.0 - gg)
        k = torch.sqrt(torch.clamp((gamma1 + gamma2) * (gamma1 - gamma2), min=eps ** 0.5))
        coeff = torch.exp(-2.0 * t * k)
        rt = 1.0 / (k * (1.0 + coeff) + gamma1 * (1.0 - coeff))
        r, tr = rt * gamma2 * (1.0 - coeff), rt * 2.0 * k * torch.exp(-t * k)
        big = t > 100.0 * eps
        z = (bot - top) / (torch.where(big, t, 1.0) * (gamma1 + gamma2))
        up.append(torch.where(big, pi * ((z + top) - r * (-z + top) - tr * (z + bot)), 0.0))
        dn.append(torch.where(big, pi * ((-z + bot) - r * (z + bot) - tr * (-z + top)), 0.0))
        rdif.append(r)
        tdif.append(tr)
    return _adding(rdif, tdif, up, dn, 1.0 - sfc_emis, pi * sfc_emis * sfc_src, 0.0)


def sw_2stream(tau, ssa, g, mu0, toa, alb_dir, alb_dif):
    """SW two-stream; returns (up, down total, down direct). ``g`` a tensor
    or 0.0 (clear sky); ``mu0`` (ncol, 1)."""
    eps = _eps(tau.dtype)
    nlay = tau.shape[0]
    mu0_safe = torch.clamp(mu0, min=eps)
    direct = [None] * (nlay + 1)
    direct[nlay] = (toa * mu0).expand_as(tau[0])
    above = torch.zeros_like(tau[0])
    for lay in range(nlay - 1, -1, -1):
        above = above + tau[lay]
        direct[lay] = direct[nlay] * torch.exp(-above / mu0_safe)
    rdif, tdif, up, dn = [], [], [], []
    for lay in range(nlay):
        t, w = tau[lay], ssa[lay]
        gg = g[lay] if isinstance(g, torch.Tensor) else g
        gamma1 = (8.0 - w * (5.0 + 3.0 * gg)) * 0.25
        gamma2 = 3.0 * (w * (1.0 - gg)) * 0.25
        gamma3 = (2.0 - (3.0 * mu0) * gg) * 0.25
        gamma4 = 1.0 - gamma3
        alpha1 = gamma1 * gamma4 + gamma2 * gamma3
        alpha2 = gamma1 * gamma3 + gamma2 * gamma4
        k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2), min=eps ** 0.5))
        e1 = torch.exp(-t * k)
        e2 = e1 * e1
        rt = 1.0 / (k * (1.0 + e2) + gamma1 * (1.0 - e2))
        rdif.append(rt * gamma2 * (1.0 - e2))
        tdif.append(rt * 2.0 * k * e1)
        t0 = torch.exp(-t / mu0_safe)
        kmu = k * mu0
        d = 1.0 - kmu * kmu
        rt2 = w * rt / torch.where(torch.abs(d) >= eps, d, eps)
        r_dir = rt2 * ((1.0 - kmu) * (alpha2 + k * gamma3) - (1.0 + kmu) * (alpha2 - k * gamma3) * e2
                       - 2.0 * (k * gamma3 - alpha2 * kmu) * e1 * t0)
        t_dir = -rt2 * ((1.0 + kmu) * (alpha1 + k * gamma4) * t0 - (1.0 - kmu) * (alpha1 - k * gamma4) * e2 * t0
                        - 2.0 * (k * gamma4 + alpha1 * kmu) * e1)
        r_dir = torch.clamp(torch.minimum(r_dir, 1.0 - t0), min=0.0)
        t_dir = torch.clamp(torch.minimum(t_dir, 1.0 - t0 - r_dir), min=0.0)
        up.append(r_dir * direct[lay + 1])
        dn.append(t_dir * direct[lay + 1])
    f_up, f_dn = _adding(rdif, tdif, up, dn, alb_dif, direct[0] * alb_dir, 0.0)
    direct = torch.stack(direct)
    return f_up, f_dn + direct, direct
