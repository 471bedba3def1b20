"""Cloud and MERRA aerosol band optics, two-stream property algebra, and
the McICA cloud mask in plain torch.

The McICA mask is the max-random-overlap sample drawn from a Threefry-2x32
counter stream (the off-TPU stream of ``jax.random``: ``key(seed)``, one key
``fold_in(key, column)`` per global column, element ``layer * ngpt + g`` of
that key's uniform draws). The mask is a discrete decision, so it is drawn
and compared in the precision the configuration states (the cloud
fraction's dtype, float32 or float64), whatever the compute dtype of the
rest.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _eps(cdt) -> float:
    return float(torch.finfo(cdt).eps)


# ---------------------------------------------------------------------------
# Two-stream property algebra
# ---------------------------------------------------------------------------


def delta_scale(tau, ssa, g):
    eps = _eps(tau.dtype)
    f = g * g
    wf = ssa * f
    return (1.0 - wf) * tau, (ssa - wf) / torch.clamp(1.0 - wf, min=eps), (g - f) / torch.clamp(1.0 - f, min=eps)


def compose(tau, ssa, g, tau2, ssa2, g2, mask):
    """(tau, ssa, g) incremented by (tau2, ssa2, g2) where ``mask`` holds."""
    eps = _eps(tau.dtype)
    t = tau + tau2
    sw = tau * ssa + tau2 * ssa2
    gn = (tau * ssa * g + tau2 * ssa2 * g2) / torch.clamp(sw, min=eps)
    sn = sw / torch.clamp(t, min=eps)
    return torch.where(mask, t, tau), torch.where(mask, sn, ssa), torch.where(mask, gn, g)


# ---------------------------------------------------------------------------
# Clouds
# ---------------------------------------------------------------------------


def _radius_interp(table, re, path, lwr, upr, nsize, cdt):
    """(tau, tau*ssa, tau*ssa*g) per band, linear in effective radius; zero
    where the water path is not positive."""
    eps = _eps(cdt)
    lwr, upr = lwr.to(cdt), upr.to(cdt)
    dr = (upr - lwr) / (nsize - 1)
    rc = torch.minimum(torch.maximum(re, lwr), upr)
    loc = torch.clamp(torch.floor((rc - lwr) / dr), 0, nsize - 2).long()
    fac = ((rc - lwr - loc * dr) / dr)[..., None]
    lo, hi = table[:, loc], table[:, loc + 1]
    ext, ssa, asy = ((1.0 - fac) * lo[i] + fac * hi[i] for i in range(3))
    tau = torch.clamp(ext * path[..., None], min=0.0)
    on = (path > eps)[..., None]
    return torch.where(on, tau, 0.0), torch.where(on, ssa * tau, 0.0), torch.where(on, asy * ssa * tau, 0.0)


def cloud_bands(tab, cloud, cdt):
    """Cloud (tau, ssa, g) per band, each (nlay, ncol, nbnd)."""
    eps = _eps(cdt)
    m = tab["meta"]
    c = {k: v.to(cdt) if isinstance(v, torch.Tensor) else v for k, v in cloud.items()}
    tl, tls, tlg = _radius_interp(tab["liq"].to(cdt), c["cld_r_eff_liq"], c["cld_path_liq"],
                                  tab["radliq_lwr"], tab["radliq_upr"], m["nsize_liq"], cdt)
    ti, tis, tig = _radius_interp(tab["ice"].to(cdt)[..., c["ice_rgh"] - 1], c["cld_r_eff_ice"], c["cld_path_ice"],
                                  tab["radice_lwr"], tab["radice_upr"], m["nsize_ice"], cdt)
    tau, ts = tl + ti, tls + tis
    return tau, ts / torch.clamp(tau, min=eps), (tlg + tig) / torch.clamp(ts, min=eps)


# ---------------------------------------------------------------------------
# Aerosols
# ---------------------------------------------------------------------------

DUST, SALT = (0, 7, 8, 9, 10), (1, 11, 12, 13, 14)
RH_TABLES = (("sulfate", 2), ("black_carbon_rh", 3), ("organic_carbon_rh", 5))
DRY_TABLES = (("black_carbon", 4), ("organic_carbon", 6))


def _size_bin(limits, size):
    """First size bin whose [lo, hi] holds the size, else the last."""
    inside = (size[..., None] >= limits[0]) & (size[..., None] <= limits[1])
    first = torch.argmax(inside.to(torch.uint8), dim=-1)
    return torch.where(inside.any(dim=-1), first, limits.shape[1] - 1)


def aerosol_bands(tab, aerosol, rel_hum, cdt):
    """Summed aerosol (tau, tau*ssa, tau*ssa*g) per band, zero in layers
    with no aerosol mass, and the (nlay, ncol) mask of layers with some."""
    t = {k: v.to(cdt) for k, v in tab.items() if k != "meta"}
    mass, size, rh = aerosol["aero_mass"].to(cdt), aerosol["aero_size"].to(cdt), rel_hum.to(cdt)
    levels = t["rh_levels"]
    loc = torch.clamp(torch.searchsorted(levels, rh.contiguous(), right=True) - 1, 0, levels.shape[0] - 2)
    fac = torch.clamp((rh - levels[loc]) / (levels[loc + 1] - levels[loc]), 0.0, 1.0)[..., None]
    sums = [0.0, 0.0, 0.0]

    def add(vals, m):
        mm = m[..., None]
        tau = torch.where(mm > 0.0, mm * vals[0], 0.0)
        sums[0] = sums[0] + tau
        sums[1] = sums[1] + tau * vals[1]
        sums[2] = sums[2] + tau * vals[1] * vals[2]

    for i in DUST:
        add(t["dust"][:, _size_bin(t["size_bin_limits"], size[i])], mass[i])
    for i in SALT:
        b = _size_bin(t["size_bin_limits"], size[i])
        add(t["sea_salt"][:, loc, b] * (1.0 - fac) + t["sea_salt"][:, loc + 1, b] * fac, mass[i])
    for name, i in RH_TABLES:
        add(t[name][:, loc] * (1.0 - fac) + t[name][:, loc + 1] * fac, mass[i])
    for name, i in DRY_TABLES:
        add(t[name][:, None, None, :], mass[i])
    active = (aerosol["aero_mass"] > 0.0).any(dim=0)
    return tuple(torch.where(active[..., None], s, 0.0) for s in sums), active


def aerosol_props(t, ts, tsg, delta: bool):
    eps = _eps(t.dtype)
    props = (t, ts / torch.clamp(t, min=eps), tsg / torch.clamp(ts, min=eps))
    return delta_scale(*props) if delta else props


# ---------------------------------------------------------------------------
# McICA
# ---------------------------------------------------------------------------


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds; uint32 words held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & M32)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def mcica_mask(cld_frac, ngpt: int, seed: int, col0: int):
    """Max-random-overlap McICA mask (nlay, ncol, ngpt), columns keyed by
    their global index ``col0 + c``. From the top layer down: above the
    first cloudy layer u_eff = u; below a masked layer the layer above's
    u_eff; below an unmasked one u * (1 - cf above); a point is cloudy where
    cf > 0 and u_eff >= 1 - cf."""
    nlay, ncol = cld_frac.shape
    dev, dt = cld_frac.device, cld_frac.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the McICA stream is drawn in float32 or float64, not {dt}")
    seed = int(seed)
    key = ((seed >> 32) & M32, seed & M32)
    cols = torch.arange(ncol, dtype=torch.int64, device=dev) + int(col0)
    ck0, ck1 = threefry2x32(key[0], key[1], torch.zeros_like(cols), cols & M32)
    g = torch.arange(ngpt, dtype=torch.int64, device=dev)
    mask = torch.empty((nlay, ncol, ngpt), dtype=torch.bool, device=dev)
    u_above = torch.zeros((ncol, ngpt), dtype=dt, device=dev)
    m_above = torch.zeros((ncol, ngpt), dtype=torch.bool, device=dev)
    cf_above = torch.zeros((ncol, 1), dtype=dt, device=dev)
    started = torch.zeros((ncol, 1), dtype=torch.bool, device=dev)
    for lay in range(nlay - 1, -1, -1):
        idx = lay * ngpt + g
        b0, b1 = threefry2x32(ck0[:, None], ck1[:, None], (idx >> 32) & M32, idx & M32)
        if dt == torch.float32:
            u = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        else:
            u = ((b0 << 20) | (b1 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0
        cf = cld_frac[lay][:, None]
        u_eff = torch.where(started, torch.where(m_above, u_above, u * (1.0 - cf_above)), u)
        cloudy = cf > 0.0
        mask[lay] = cloudy & (u_eff >= 1.0 - cf)
        u_above, m_above, cf_above, started = u_eff, mask[lay], cf, started | cloudy
    return mask
