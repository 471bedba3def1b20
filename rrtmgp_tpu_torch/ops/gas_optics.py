"""RRTMGP k-distribution gas optics in plain torch (counterpart of
``rrtmgp_tpu/ops/gas_optics.py``).

Same numerics as the JAX XLA path, written with gathers:

- pressure/temperature interpolation indices are computed once per
  (layer, column);
- eta (binary species parameter) data is computed per band;
- the trilinear table interpolation runs band by band and gathers, for each
  (layer, column), only the two eta nodes of that band at the four
  (pressure, temperature) corners — never whole (ngpt*neta) table rows.

Layout: optics tensors are (nlay, ncol, ngpt); band data is (nlay, ncol,
nbnd). Dtype-generic: everything follows the dtype of the inputs.
Index conventions: level/layer 0 = surface; g-points and bands 0-based; gas
indices 1-based like the reference's vmr convention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..data.lookups import GasLookup, band_limits_to_gpt2band
from ..states import AtmosphericState, get_vmr


class PTInterp(NamedTuple):
    """Per-(layer, column) pressure/temperature interpolation data."""

    jtemp: torch.Tensor        # (nlay, ncol) int32, lower temperature index
    ftemp: torch.Tensor        # (nlay, ncol)
    jpress_base: torch.Tensor  # (nlay, ncol) int32, base slab on the (npress+1) axis
    fpress: torch.Tensor       # (nlay, ncol)
    tropo_lower: torch.Tensor  # (nlay, ncol) bool, True = lower atmosphere


class EtaInterp(NamedTuple):
    """Eta interpolation data per band, each (nlay, ncol, nbnd). Field 1 is
    for the lower temperature node, field 2 for the upper one."""

    jeta1: torch.Tensor
    feta1: torch.Tensor
    jeta2: torch.Tensor
    feta2: torch.Tensor
    col_mix1: torch.Tensor
    col_mix2: torch.Tensor


class LWSources(NamedTuple):
    lay_source: torch.Tensor | None  # (nlay, ncol, ngpt); None when not needed
    lev_source: torch.Tensor  # (nlay+1, ncol, ngpt)
    sfc_source: torch.Tensor  # (ncol, ngpt)


class LWOptics(NamedTuple):
    tau: torch.Tensor  # (nlay, ncol, ngpt)
    sources: LWSources


class SWOptics(NamedTuple):
    tau: torch.Tensor  # (nlay, ncol, ngpt)
    ssa: torch.Tensor  # (nlay, ncol, ngpt)


#: Eta grid-node semantics at exact nodes (see rrtmgp_tpu.ops.gas_optics):
#: "continuous" takes the fraction against the clamped index; "reference"
#: takes frac(loc_eta) like the reference. Identical everywhere off-node.
ETA_NODE_MODES = ("continuous", "reference")


def gpt2band(lkp: GasLookup) -> torch.Tensor:
    """(ngpt,) int64 band of each g-point, on the lookup's device."""
    g2b = band_limits_to_gpt2band(lkp.bnd_lims_gpt, lkp.n_gpt)
    return torch.as_tensor(g2b, dtype=torch.int64, device=lkp.device)


def compute_pt_interp(lkp: GasLookup, p_lay: torch.Tensor, t_lay: torch.Tensor) -> PTInterp:
    """Temperature/pressure interpolation indices and fractions on the
    uniform reference grids, clamped like the reference."""
    loc_t = (t_lay - lkp.t_ref_min) / lkp.t_ref_delta
    jtemp = torch.clamp(torch.floor(loc_t), 0, lkp.n_temp - 2).to(torch.int32)
    ftemp = loc_t - jtemp

    loc_p = (lkp.ln_p_ref_max - torch.log(p_lay)) / lkp.ln_p_ref_delta
    jp = torch.clamp(torch.floor(loc_p), 0, lkp.n_press - 2).to(torch.int32)
    fpress = loc_p - jp

    tropo_lower = p_lay > lkp.p_ref_tropo
    # kmajor's pressure axis has n_press+1 slabs: the lower atmosphere uses
    # (jp, jp+1), the upper (jp+1, jp+2)
    jpress_base = jp + (~tropo_lower).to(torch.int32)
    return PTInterp(jtemp, ftemp, jpress_base, fpress, tropo_lower)


def compute_eta_interp(
    lkp: GasLookup, vmr, pt: PTInterp, node_mode: str = "continuous"
) -> EtaInterp:
    """Eta interpolation data per band, each field (nlay, ncol, nbnd)."""
    if node_mode not in ETA_NODE_MODES:
        raise ValueError(f"eta node_mode {node_mode!r} not in {ETA_NODE_MODES}")
    n_eta = lkp.n_eta
    dtype = lkp.eta_half.dtype
    shape2d = pt.jtemp.shape

    # the few distinct key-species VMRs, then one gather per (slot, side)
    # picks each band's: cheaper than stacking nbnd broadcast views
    species = sorted({s for bnd in lkp.key_species for pair in bnd for s in pair})
    vmrs = torch.stack(
        [get_vmr(vmr, ig).to(dtype).expand(shape2d) for ig in species], dim=-1
    )  # (nlay, ncol, n_species)

    def vmr_bands(slot, tropo):
        idx = [species.index(lkp.key_species[b][tropo][slot]) for b in range(lkp.n_bnd)]
        return vmrs[..., torch.tensor(idx, device=vmrs.device)]  # (nlay, ncol, nbnd)

    sel = pt.tropo_lower[..., None]
    vmr1 = torch.where(sel, vmr_bands(0, 0), vmr_bands(0, 1))
    vmr2 = torch.where(sel, vmr_bands(1, 0), vmr_bands(1, 1))

    # eta_half rows indexed by (troposphere side, temperature)
    ntemp = lkp.n_temp
    eh = lkp.eta_half.permute(1, 2, 0).reshape(2 * ntemp, lkp.n_bnd)
    row = pt.jtemp.long() + torch.where(pt.tropo_lower, 0, ntemp)
    outs = []
    for itemp in (0, 1):
        eta_half = eh[row + itemp]  # (nlay, ncol, nbnd)
        col_mix = vmr1 + eta_half * vmr2
        pos = col_mix > 0.0
        eta = torch.where(pos, vmr1 / torch.where(pos, col_mix, 1.0), 0.5)
        loc_eta = eta * (n_eta - 1)
        jeta_f = torch.clamp(torch.floor(loc_eta), max=n_eta - 2)
        if node_mode == "continuous":
            feta = loc_eta - jeta_f
        else:
            feta = loc_eta - torch.floor(loc_eta)
        outs.append((jeta_f.to(torch.int32), feta, col_mix))
    (j1, f1, c1), (j2, f2, c2) = outs
    return EtaInterp(j1, f1, j2, f2, c1, c2)


def _g_fastest(table: torch.Tensor) -> torch.Tensor:
    """(ngpt, *rest) -> (prod(rest), ngpt): one row per table node, g-points
    contiguous, so a band's g-points are one slice of a gathered row."""
    return table.reshape(table.shape[0], -1).T.contiguous()


def _interp3d(table, pt: PTInterp, eta: EtaInterp, lkp: GasLookup, use_colmix: bool):
    """Trilinear (pressure, temperature, eta) interpolation of a
    (ngpt, npress+1, ntemp, neta) table, scaled per temperature node by
    col_mix when ``use_colmix``; returns (nlay, ncol, ngpt)."""
    _, _, ntemp, neta = table.shape
    tab = _g_fastest(table)
    slab = ntemp * neta
    fp = pt.fpress[..., None]
    ft = pt.ftemp[..., None]
    jp = pt.jpress_base.long()
    jt = pt.jtemp.long()
    pieces = []
    for ibnd, (g0, g1) in enumerate(lkp.bnd_lims_gpt):
        tb = tab[:, g0:g1]
        out = 0.0
        for half in (0, 1):
            je = (eta.jeta1 if half == 0 else eta.jeta2)[..., ibnd].long()
            fe = (eta.feta1 if half == 0 else eta.feta2)[..., ibnd, None]
            row = (jp * ntemp + jt + half) * neta + je  # (nlay, ncol)
            node0 = (1.0 - fp) * tb[row] + fp * tb[row + slab]
            node1 = (1.0 - fp) * tb[row + 1] + fp * tb[row + slab + 1]
            val = node0 * (1.0 - fe) + node1 * fe
            if use_colmix:
                cm = eta.col_mix1 if half == 0 else eta.col_mix2
                val = val * cm[..., ibnd, None]
            out = out + (ft if half else 1.0 - ft) * val
        pieces.append(out)
    return torch.cat(pieces, dim=-1)


def compute_tau_major(lkp: GasLookup, col_dry, pt: PTInterp, eta: EtaInterp) -> torch.Tensor:
    """Major-species optical depth (nlay, ncol, ngpt)."""
    return _interp3d(lkp.kmajor, pt, eta, lkp, use_colmix=True) * col_dry[..., None]


def compute_planck_fraction(lkp: GasLookup, pt: PTInterp, eta: EtaInterp) -> torch.Tensor:
    """Planck fraction (nlay, ncol, ngpt)."""
    return _interp3d(lkp.planck_fraction, pt, eta, lkp, use_colmix=False)


def minor_intervals(lkp: GasLookup) -> list:
    """The minor intervals that have a gas, as (side, interval), side 0 =
    lower atmosphere: lower side first, each side in file order. Minor
    scalings and the kernels' interval index follow this order."""
    return [
        (side, itv)
        for side, intervals in ((0, lkp.minor_lower), (1, lkp.minor_upper))
        for itv in intervals
        if itv.gas != 0
    ]


def minor_scalings(lkp: GasLookup, vmr, col_dry, p_lay, t_lay, pt: PTInterp) -> list:
    """Per ``minor_intervals`` entry: (side, interval, scaling), the scaling
    (nlay, ncol) already zeroed outside the interval's troposphere side."""
    vmr_h2o = get_vmr(vmr, lkp.idx_h2o)
    dry_fact = 1.0 / (1.0 + vmr_h2o)
    density_fact = 0.01 * p_lay / t_lay  # pa2hpa * p / t
    out = []
    for side, itv in minor_intervals(lkp):
        mask = pt.tropo_lower if side == 0 else ~pt.tropo_lower
        scaling = get_vmr(vmr, itv.gas) * col_dry
        if itv.scales_with_density:
            scaling = scaling * density_fact
            if itv.scaling_gas > 0:
                sg = get_vmr(vmr, itv.scaling_gas)
                if itv.scale_by_complement:
                    scaling = scaling * (1.0 - sg * dry_fact)
                else:
                    scaling = scaling * (sg * dry_fact)
        out.append((side, itv, torch.where(mask, scaling, 0.0)))
    return out


def tau_minor_from_scalings(lkp: GasLookup, scalings: list, pt: PTInterp, eta: EtaInterp):
    """Minor-gas optical depth (nlay, ncol, ngpt) from ``minor_scalings``:
    per interval, a (temperature, eta) interpolation of its kminor rows at the
    eta data of the band holding the interval's first g-point."""
    nlay, ncol = pt.jtemp.shape
    ntemp, neta = lkp.n_temp, lkp.n_eta
    dtype = lkp.kmajor.dtype
    tau = torch.zeros((nlay, ncol, lkp.n_gpt), dtype=dtype, device=pt.jtemp.device)
    g2b = band_limits_to_gpt2band(lkp.bnd_lims_gpt, lkp.n_gpt)
    jt = pt.jtemp.long()
    ft = pt.ftemp[..., None]
    for side, itv, scaling in scalings:
        kminor = lkp.kminor_lower if side == 0 else lkp.kminor_upper
        ng = itv.gpt1 - itv.gpt0
        ibnd = int(g2b[itv.gpt0])
        k2 = _g_fastest(kminor[itv.k0 : itv.k0 + ng])  # (ntemp*neta, ng)
        fe1 = eta.feta1[..., ibnd, None]
        fe2 = eta.feta2[..., ibnd, None]
        i00 = jt * neta + eta.jeta1[..., ibnd].long()
        i10 = (jt + 1) * neta + eta.jeta2[..., ibnd].long()
        v1 = (1.0 - fe1) * k2[i00] + fe1 * k2[i00 + 1]
        v2 = (1.0 - fe2) * k2[i10] + fe2 * k2[i10 + 1]
        contrib = ((1.0 - ft) * v1 + ft * v2) * scaling[..., None]
        tau[:, :, itv.gpt0 : itv.gpt1] += contrib
    return tau


def compute_tau_minor(
    lkp: GasLookup, vmr, col_dry, p_lay, t_lay, pt: PTInterp, eta: EtaInterp
) -> torch.Tensor:
    """Minor-gas optical depth (nlay, ncol, ngpt)."""
    return tau_minor_from_scalings(
        lkp, minor_scalings(lkp, vmr, col_dry, p_lay, t_lay, pt), pt, eta
    )


def rayleigh_factor(lkp: GasLookup, vmr, col_dry) -> torch.Tensor:
    """(vmr_h2o + 1) * col_dry, the Rayleigh column amount (nlay, ncol)."""
    return (get_vmr(vmr, lkp.idx_h2o) + 1.0) * col_dry


def tau_rayleigh_from_factor(lkp: GasLookup, factor, pt: PTInterp, eta: EtaInterp):
    """Rayleigh optical depth (nlay, ncol, ngpt): (tropo side, temperature,
    eta) interpolation of ``rayl`` times ``factor``."""
    ntemp, neta = lkp.n_temp, lkp.n_eta
    tab = lkp.rayl.permute(0, 2, 3, 1).reshape(2 * ntemp * neta, lkp.n_gpt)
    tropo_off = torch.where(pt.tropo_lower, 0, ntemp).long()
    jt = pt.jtemp.long()
    ft = pt.ftemp[..., None]
    pieces = []
    for ibnd, (g0, g1) in enumerate(lkp.bnd_lims_gpt):
        tb = tab[:, g0:g1]
        out = 0.0
        for half in (0, 1):
            je = (eta.jeta1 if half == 0 else eta.jeta2)[..., ibnd].long()
            fe = (eta.feta1 if half == 0 else eta.feta2)[..., ibnd, None]
            row = (tropo_off + jt + half) * neta + je
            val = tb[row] * (1.0 - fe) + tb[row + 1] * fe
            out = out + (ft if half else 1.0 - ft) * val
        pieces.append(out)
    return torch.cat(pieces, dim=-1) * factor[..., None]


def compute_tau_rayleigh(lkp: GasLookup, vmr, col_dry, pt: PTInterp, eta: EtaInterp) -> torch.Tensor:
    """Rayleigh scattering optical depth (nlay, ncol, ngpt)."""
    return tau_rayleigh_from_factor(lkp, rayleigh_factor(lkp, vmr, col_dry), pt, eta)


def planck_bands(totplnk: torch.Tensor, t: torch.Tensor, t_min: float, t_delta: float):
    """Band Planck emission (*t.shape, nbnd): linear interpolation of
    ``totplnk`` (n_t, nbnd) in temperature on a uniform grid; outside the
    grid the clamped fraction gives the end values."""
    n = totplnk.shape[0]
    loc = (t - t_min) / t_delta
    j = torch.clamp(torch.floor(loc), 0, n - 2)
    f = torch.clamp(loc - j, 0.0, 1.0)[..., None]
    jl = j.long()
    return totplnk[jl] * (1.0 - f) + totplnk[jl + 1] * f


def planck_sources_from_bands(
    g2b: torch.Tensor, plk_lay, plk_lev, plk_sfc, pfrac
) -> LWSources:
    """Planck sources from band Planck values (band axis last), the (ngpt,)
    int64 band of each g-point ``g2b`` and the per-g-point Planck fraction.
    Interior level sources use the geometric mean of the adjacent layers'
    fractions; the surface, bottom and top levels use the adjacent layer's
    own. ``plk_lay=None`` skips the layer source (the two-stream solve needs
    only level and surface sources)."""
    nlay = pfrac.shape[0]
    planck_lev = plk_lev[..., g2b]
    planck_sfc = plk_sfc[..., g2b]
    lay_source = None if plk_lay is None else plk_lay[..., g2b] * pfrac
    lev0 = planck_lev[0] * pfrac[0]
    interior = planck_lev[1:nlay] * torch.sqrt(pfrac[:-1] * pfrac[1:])
    top = planck_lev[nlay] * pfrac[-1]
    lev_source = torch.cat([lev0[None], interior, top[None]], dim=0)
    sfc_source = planck_sfc * pfrac[0]
    return LWSources(lay_source=lay_source, lev_source=lev_source, sfc_source=sfc_source)


def compute_planck_sources(lkp: GasLookup, as_: AtmosphericState, pfrac) -> LWSources:
    """Planck sources (intensity units) for all g-points."""
    bands = lambda t: planck_bands(lkp.totplnk, t, lkp.t_planck_min, lkp.t_planck_delta)
    return planck_sources_from_bands(
        gpt2band(lkp), bands(as_.t_lay), bands(as_.t_lev), bands(as_.t_sfc), pfrac
    )


def gas_optics_lw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> LWOptics:
    """LW gas optics: tau + Planck sources for all g-points, (nlay, ncol, ngpt)."""
    pt = compute_pt_interp(lkp, as_.p_lay, as_.t_lay)
    eta = compute_eta_interp(lkp, as_.vmr, pt, node_mode=eta_node_mode)
    tau = compute_tau_major(lkp, as_.col_dry, pt, eta)
    tau += compute_tau_minor(lkp, as_.vmr, as_.col_dry, as_.p_lay, as_.t_lay, pt, eta)
    tau = torch.clamp_(tau, min=0.0)
    pfrac = compute_planck_fraction(lkp, pt, eta)
    return LWOptics(tau=tau, sources=compute_planck_sources(lkp, as_, pfrac))


def gas_optics_sw(
    lkp: GasLookup, as_: AtmosphericState, eta_node_mode: str = "continuous"
) -> SWOptics:
    """SW gas optics: tau + Rayleigh single-scattering albedo, (nlay, ncol, ngpt)."""
    pt = compute_pt_interp(lkp, as_.p_lay, as_.t_lay)
    eta = compute_eta_interp(lkp, as_.vmr, pt, node_mode=eta_node_mode)
    tau_gas = compute_tau_major(lkp, as_.col_dry, pt, eta)
    tau_gas += compute_tau_minor(lkp, as_.vmr, as_.col_dry, as_.p_lay, as_.t_lay, pt, eta)
    return sw_tau_ssa(tau_gas, compute_tau_rayleigh(lkp, as_.vmr, as_.col_dry, pt, eta))


def sw_tau_ssa(tau_gas, tau_ray) -> SWOptics:
    """Total tau (major + minor ``tau_gas`` plus Rayleigh, clamped at 0) and
    the Rayleigh single-scattering albedo; updates ``tau_gas`` in place to
    save a full-size temporary."""
    tau = tau_gas.add_(tau_ray).clamp_(min=0.0)
    pos = tau > 0.0
    ssa = torch.where(pos, tau_ray / torch.where(pos, tau, 1.0), 0.0)
    return SWOptics(tau=tau, ssa=ssa)
