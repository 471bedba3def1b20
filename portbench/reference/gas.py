"""RRTMGP k-distribution gas optics in plain torch: the pressure,
temperature and binary-species (eta) interpolation of the major-gas table,
the minor-gas intervals and their scaling laws, Rayleigh scattering and the
band Planck sources.

Arithmetic runs in the compute dtype ``cdt`` given to each function. The one
discontinuous decision, the troposphere side of a layer (``p_lay >
p_ref_tropo``), is taken on the inputs in the precision the configuration
states, as the program takes it; every other interpolation is continuous
across its grid cells, so the cell chosen in ``cdt`` does not matter.
Layout: (nlay, ncol, ngpt); level 0 = surface.
"""

from __future__ import annotations

import torch


def g2b(meta) -> list:
    """Band of each g-point."""
    return [b for b, (g0, g1) in enumerate(meta["bnd_lims_gpt"]) for _ in range(g0, g1)]


def vmr(state, ig: int, cdt):
    """Volume mixing ratio of gas ``ig`` (1-based; 0: none, 1.0): h2o and o3
    per layer, the other gases global means."""
    if ig == 0:
        return torch.ones((), dtype=cdt, device=state["p_lay"].device)
    if ig == 1:
        return state["vmr_h2o"].to(cdt)
    if ig == 3:
        return state["vmr_o3"].to(cdt)
    return state["vmr_gm"][ig].to(cdt)


def pt_interp(meta, state, cdt):
    """Temperature and pressure grid cells and fractions, and the
    troposphere side of each layer."""
    tropo = state["p_lay"] > meta["p_ref_tropo"]
    p, t = state["p_lay"].to(cdt), state["t_lay"].to(cdt)
    loc_t = (t - meta["t_ref_min"]) / meta["t_ref_delta"]
    jt = torch.clamp(torch.floor(loc_t), 0, meta["n_temp"] - 2)
    loc_p = (meta["ln_p_ref_max"] - torch.log(p)) / meta["ln_p_ref_delta"]
    jp = torch.clamp(torch.floor(loc_p), 0, meta["n_press"] - 2)
    # the lower atmosphere reads pressure slabs (jp, jp+1) of the n_press+1,
    # the upper (jp+1, jp+2)
    return dict(jt=jt.long(), ft=loc_t - jt, jpb=jp.long() + (~tropo).long(), fp=loc_p - jp, tropo=tropo)


def eta_interp(meta, eta_half, state, pt, cdt):
    """Per band and temperature node (0, 1): the eta cell, its fraction and
    the column mixing amount, each (nlay, ncol, nbnd)."""
    ks = meta["key_species"]
    tropo = pt["tropo"][..., None]
    stack = lambda side, slot: torch.stack(
        [vmr(state, ks[b][side][slot], cdt).expand(state["p_lay"].shape) for b in range(len(ks))], dim=-1)
    vmr1 = torch.where(tropo, stack(0, 0), stack(1, 0))
    vmr2 = torch.where(tropo, stack(0, 1), stack(1, 1))
    n_eta, n_temp = meta["n_eta"], meta["n_temp"]
    eh = eta_half.to(cdt).permute(1, 2, 0).reshape(2 * n_temp, -1)  # (side, temperature) rows
    row = pt["jt"] + torch.where(pt["tropo"], 0, n_temp)
    out = []
    for node in (0, 1):
        col_mix = vmr1 + eh[row + node] * vmr2
        pos = col_mix > 0.0
        eta = torch.where(pos, vmr1 / torch.where(pos, col_mix, 1.0), 0.5)
        loc = eta * (n_eta - 1)
        je = torch.clamp(torch.floor(loc), max=n_eta - 2)
        out.append(dict(je=je.long(), fe=loc - je, col_mix=col_mix))
    return out


def interp3d(table, meta, pt, eta, cdt, use_colmix: bool):
    """Trilinear (pressure, temperature, eta) interpolation of a (ngpt,
    npress+1, ntemp, neta) table, band by band; with ``use_colmix`` each
    temperature node scaled by its column mixing amount."""
    ngpt, _, n_temp, n_eta = table.shape
    tab = table.to(cdt).reshape(ngpt, -1).T.contiguous()
    slab = n_temp * n_eta
    fp, ft = pt["fp"][..., None], pt["ft"][..., None]
    pieces = []
    for b, (g0, g1) in enumerate(meta["bnd_lims_gpt"]):
        tb = tab[:, g0:g1]
        acc = 0.0
        for node in (0, 1):
            je, fe = eta[node]["je"][..., b], eta[node]["fe"][..., b, None]
            row = (pt["jpb"] * n_temp + pt["jt"] + node) * n_eta + je
            lo = (1.0 - fp) * tb[row] + fp * tb[row + slab]
            hi = (1.0 - fp) * tb[row + 1] + fp * tb[row + slab + 1]
            val = lo * (1.0 - fe) + hi * fe
            if use_colmix:
                val = val * eta[node]["col_mix"][..., b, None]
            acc = acc + (ft if node else 1.0 - ft) * val
        pieces.append(acc)
    return torch.cat(pieces, dim=-1)


def tau_minor(tables, state, pt, eta, cdt):
    """Minor-gas optical depth: per interval on its troposphere side, the
    (temperature, eta) interpolation of its rows at the eta of the band of
    its first g-point, times the gas's scaled column amount."""
    meta = tables["meta"]
    nlay, ncol = state["p_lay"].shape
    n_temp, n_eta = meta["n_temp"], meta["n_eta"]
    band = g2b(meta)
    col_dry = state["col_dry"].to(cdt)
    h2o = vmr(state, meta["idx_h2o"], cdt)
    dry_fact = 1.0 / (1.0 + h2o)
    density = 0.01 * state["p_lay"].to(cdt) / state["t_lay"].to(cdt)
    jt, ft = pt["jt"], pt["ft"][..., None]
    tau = torch.zeros((nlay, ncol, len(band)), dtype=cdt, device=col_dry.device)
    for side, key in ((0, "minor_lower"), (1, "minor_upper")):
        kminor = tables["kminor_lower" if side == 0 else "kminor_upper"].to(cdt)
        for gas, sgas, dens, compl, g0, g1, k0 in meta[key]:
            if gas == 0:
                continue
            scaling = vmr(state, gas, cdt) * col_dry
            if dens:
                scaling = scaling * density
                if sgas > 0:
                    sg = vmr(state, sgas, cdt) * dry_fact
                    scaling = scaling * (1.0 - sg if compl else sg)
            on_side = pt["tropo"] if side == 0 else ~pt["tropo"]
            scaling = torch.where(on_side, scaling, 0.0)
            b = band[g0]
            k2 = kminor[k0:k0 + g1 - g0].reshape(g1 - g0, -1).T
            fe1, fe2 = eta[0]["fe"][..., b, None], eta[1]["fe"][..., b, None]
            i0 = jt * n_eta + eta[0]["je"][..., b]
            i1 = (jt + 1) * n_eta + eta[1]["je"][..., b]
            v0 = (1.0 - fe1) * k2[i0] + fe1 * k2[i0 + 1]
            v1 = (1.0 - fe2) * k2[i1] + fe2 * k2[i1 + 1]
            tau[:, :, g0:g1] += ((1.0 - ft) * v0 + ft * v1) * scaling[..., None]
    return tau


def tau_rayleigh(tables, state, pt, eta, cdt):
    """Rayleigh optical depth: (side, temperature, eta) interpolation of
    ``rayl`` times (vmr_h2o + 1) * col_dry."""
    meta = tables["meta"]
    n_temp, n_eta = meta["n_temp"], meta["n_eta"]
    rayl = tables["rayl"].to(cdt)
    tab = rayl.permute(0, 2, 3, 1).reshape(2 * n_temp * n_eta, rayl.shape[1])
    off = torch.where(pt["tropo"], 0, n_temp)
    ft = pt["ft"][..., None]
    pieces = []
    for b, (g0, g1) in enumerate(meta["bnd_lims_gpt"]):
        tb = tab[:, g0:g1]
        acc = 0.0
        for node in (0, 1):
            je, fe = eta[node]["je"][..., b], eta[node]["fe"][..., b, None]
            row = (off + pt["jt"] + node) * n_eta + je
            acc = acc + (ft if node else 1.0 - ft) * (tb[row] * (1.0 - fe) + tb[row + 1] * fe)
        pieces.append(acc)
    factor = (vmr(state, meta["idx_h2o"], cdt) + 1.0) * state["col_dry"].to(cdt)
    return torch.cat(pieces, dim=-1) * factor[..., None]


def planck_bands(totplnk, t, meta, cdt):
    """Band Planck emission at temperatures ``t``: linear in temperature,
    the end values outside the table; (*t.shape, nbnd)."""
    tp = totplnk.to(cdt)
    loc = (t.to(cdt) - meta["t_planck_min"]) / meta["t_planck_delta"]
    j = torch.clamp(torch.floor(loc), 0, tp.shape[0] - 2)
    f = torch.clamp(loc - j, 0.0, 1.0)[..., None]
    j = j.long()
    return tp[j] * (1.0 - f) + tp[j + 1] * f


def longwave(tables, state, cdt):
    """LW gas optics: tau, and the layer, level and surface Planck sources
    per g-point (intensity units)."""
    meta = tables["meta"]
    pt = pt_interp(meta, state, cdt)
    eta = eta_interp(meta, tables["eta_half"], state, pt, cdt)
    tau = interp3d(tables["kmajor"], meta, pt, eta, cdt, True) * state["col_dry"].to(cdt)[..., None]
    tau = torch.clamp(tau + tau_minor(tables, state, pt, eta, cdt), min=0.0)
    pfrac = interp3d(tables["planck_fraction"], meta, pt, eta, cdt, False)
    band = torch.tensor(g2b(meta), device=tau.device)
    plk = lambda t: planck_bands(tables["totplnk"], t, meta, cdt)[..., band]
    lev = plk(state["t_lev"])
    nlay = tau.shape[0]
    lev_source = torch.cat([(lev[0] * pfrac[0])[None], lev[1:nlay] * torch.sqrt(pfrac[:-1] * pfrac[1:]),
                            (lev[nlay] * pfrac[-1])[None]])
    return tau, plk(state["t_lay"]) * pfrac, lev_source, plk(state["t_sfc"]) * pfrac[0]


def shortwave(tables, state, cdt):
    """SW gas optics: tau (gases and Rayleigh) and the Rayleigh single
    scattering albedo."""
    meta = tables["meta"]
    pt = pt_interp(meta, state, cdt)
    eta = eta_interp(meta, tables["eta_half"], state, pt, cdt)
    tau_gas = interp3d(tables["kmajor"], meta, pt, eta, cdt, True) * state["col_dry"].to(cdt)[..., None]
    tau_gas = tau_gas + tau_minor(tables, state, pt, eta, cdt)
    tau_ray = tau_rayleigh(tables, state, pt, eta, cdt)
    tau = torch.clamp(tau_gas + tau_ray, min=0.0)
    pos = tau > 0.0
    return tau, torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)
