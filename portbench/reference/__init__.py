"""The benchmark's plain-torch reference of one radiation step: the LW and
SW solves of an atmospheric state, clear sky or all-sky with McICA clouds
and MERRA aerosols, as ``RRTMGPSolver.update_fluxes`` computes them.

It imports nothing of the program and takes nothing the program made: it
reads the tables, states and boundary values the benchmark generated and
works out everything else again (interpolation data, Planck sources, the
McICA mask of the step, cloud and aerosol optics, the transport). Columns
are independent, so ``step_fluxes`` solves any block of them.
"""

from __future__ import annotations

import torch

from . import clouds, gas, rte

#: secant and weight of the one-angle Gauss-Jacobi quadrature (Hogan 2023, Table 1)
LW_SECANT, LW_WEIGHT = 1.0 / 0.6096748751, 1.0


def columns(tree, lo: int, hi: int):
    """Columns [lo, hi) of a state or boundary dict (trailing column axis;
    the global-mean vmr vector has none)."""
    if isinstance(tree, dict):
        return {k: v if k == "vmr_gm" else columns(v, lo, hi) for k, v in tree.items()}
    return tree[..., lo:hi] if isinstance(tree, torch.Tensor) else tree


def longwave(tables, state, bcs, two_stream: bool, step: int, col0: int, cdt):
    """LW (up, down) at every level, summed over g-points, (nlay+1, ncol)."""
    lk = tables["lw"]
    tau, lay_src, lev_src, sfc_src = gas.longwave(lk, state, cdt)
    band = torch.tensor(gas.g2b(lk["meta"]), device=tau.device)
    ssa = g = None
    if two_stream:
        ssa, g = torch.zeros_like(tau), torch.zeros_like(tau)
    if "cloud" in state:
        mask = clouds.mcica_mask(state["cloud"]["cld_frac"], tau.shape[-1], 2 * step, col0)
        tc, sc, gc = clouds.cloud_bands(tables["lw_cld"], state["cloud"], cdt)
        if two_stream:
            tau, ssa, g = clouds.compose(tau, ssa, g, tc[..., band], sc[..., band], gc[..., band], mask)
        else:
            tau = tau + torch.where(mask, (tc - sc * tc)[..., band], 0.0)
    if "aerosol" in state:
        (t, ts, tsg), active = clouds.aerosol_bands(tables["lw_aero"], state["aerosol"], state["rel_hum"], cdt)
        if two_stream:
            props = clouds.aerosol_props(t[..., band], ts[..., band], tsg[..., band], delta=False)
            tau, ssa, g = clouds.compose(tau, ssa, g, *props, active[..., None])
        else:
            tau = tau + (t - ts)[..., band]
    emis = bcs["sfc_emis"].to(cdt).T[:, band]
    if two_stream:
        up, dn = rte.lw_2stream(tau, ssa, g, lev_src, sfc_src, emis)
    else:
        up, dn = rte.lw_noscat(tau, lay_src, lev_src, sfc_src, emis, LW_SECANT, LW_WEIGHT)
    return up.sum(-1), dn.sum(-1)


def shortwave(tables, state, bcs, step: int, col0: int, cdt):
    """SW (up, down, direct down) at every level, summed over g-points."""
    lk = tables["sw"]
    tau, ssa = gas.shortwave(lk, state, cdt)
    band = torch.tensor(gas.g2b(lk["meta"]), device=tau.device)
    g = 0.0
    if "cloud" in state or "aerosol" in state:
        g = torch.zeros_like(tau)
    if "cloud" in state:
        mask = clouds.mcica_mask(state["cloud"]["cld_frac"], tau.shape[-1], 2 * step + 1, col0)
        props = clouds.delta_scale(*(x[..., band] for x in clouds.cloud_bands(tables["sw_cld"], state["cloud"], cdt)))
        tau, ssa, g = clouds.compose(tau, ssa, g, *props, mask)
    if "aerosol" in state:
        (t, ts, tsg), active = clouds.aerosol_bands(tables["sw_aero"], state["aerosol"], state["rel_hum"], cdt)
        props = clouds.aerosol_props(t[..., band], ts[..., band], tsg[..., band], delta=True)
        tau, ssa, g = clouds.compose(tau, ssa, g, *props, active[..., None])
    mu0 = bcs["cos_zenith"].to(cdt)[:, None]
    toa = bcs["toa_flux"].to(cdt)[:, None] * lk["solar_src_scaled"].to(cdt)[None, :]
    up, dn, direct = rte.sw_2stream(tau, ssa, g, mu0, toa, bcs["sfc_alb_direct"].to(cdt).T[:, band],
                                    bcs["sfc_alb_diffuse"].to(cdt).T[:, band])
    day = (bcs["cos_zenith"] > 0)[None, :]
    return tuple(torch.where(day, f.sum(-1), 0.0) for f in (up, dn, direct))


def step_fluxes(tables, state, bcs, two_stream_lw: bool, step: int, lo: int, hi: int, cdt=torch.float64):
    """The fluxes of McICA step ``step`` (the seeds 2 * step, LW, and
    2 * step + 1, SW) in columns [lo, hi), computed in ``cdt``."""
    st, b = columns(state, lo, hi), columns(bcs, lo, hi)
    lw_up, lw_dn = longwave(tables, st, b, two_stream_lw, step, lo, cdt)
    sw_up, sw_dn, sw_dir = shortwave(tables, st, b, step, lo, cdt)
    return dict(lw_up=lw_up, lw_dn=lw_dn, sw_up=sw_up, sw_dn=sw_dn, sw_dir=sw_dir)

