"""Seeded inputs of a cell: lookup tables, atmospheric states and boundary
values, made on the device from ``--seed`` in a few large calls.

The tables have the structure and dimensions of the rrtmgp-data v1.9 files
(key species per band, minor-gas intervals, Planck fractions that sum to one
over a band's g-points, physical magnitudes); the atmospheres are RFMIP-like
columns with clouds and MERRA aerosols. The arithmetic is a frozen copy of
the port's synthetic generators (``data/synthetic.py``) and of the all-sky
slice's cloud-fraction scaling, written for a ``torch.Generator`` on the
device instead of numpy on the host. Everything is returned as plain dicts
of tensors: the reference reads these, and ``program.py`` builds the
port's containers from copies of them.
"""

from __future__ import annotations

import math

import torch

#: gas order of the lookups' vmr index (1-based, 0 = none), as in the files
GAS_NAMES = ("h2o", "co2", "o3", "n2o", "co", "ch4", "o2", "n2")
#: global-mean volume mixing ratios by 1-based gas index
GLOBAL_MEAN_VMR = {2: 397e-6, 4: 3.2e-7, 5: 1.5e-7, 6: 1.8e-6, 7: 0.209, 8: 0.781}
#: physical constants (ClimaParams defaults)
GRAV, MOLMASS_DRYAIR, MOLMASS_WATER, AVOGAD = 9.81, 0.02897, 0.01801528, 6.02214076e23
N_AEROSOL_SPECIES = 15


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one of a run's streams (tables, state
    0, state 1, ...), a pure function of (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * stream) % (2**63 - 1))
    return g


def _smooth(shape, scale, gen, device):
    """scale * exp(0.5 * x), x normal noise averaged over three neighbours
    (zero-padded) along every axis but the first."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float64)
    for axis in range(1, len(shape)):
        pad = [0, 0] * (len(shape) - 1 - axis) + [1, 1]
        xp = torch.nn.functional.pad(x, pad)
        n = x.shape[axis]
        x = (xp.narrow(axis, 0, n) + xp.narrow(axis, 1, n) + xp.narrow(axis, 2, n)) / 3.0
    return scale * torch.exp(0.5 * x)


def gas_tables(dims: dict, longwave: bool, gen, device, dtype) -> dict:
    """Gas-optics tables of one band set: the arrays of the port's
    ``GasLookup`` and its static fields under ``meta``."""
    n_gpt, n_bnd, n_eta = dims["n_gpt"], dims["n_bnd"], dims["n_eta"]
    n_press, n_temp = dims["n_press"], dims["n_temp"]
    f64 = dict(device=device, dtype=torch.float64)
    per_bnd = n_gpt // n_bnd
    bnd_lims_gpt = tuple((b * per_bnd, (b + 1) * per_bnd) for b in range(n_bnd))
    p_ref = torch.logspace(math.log10(109663.0), math.log10(1.005), n_press, **f64)
    t_ref = torch.linspace(160.0, 355.0, n_temp, **f64)

    kmajor = _smooth((n_gpt, n_press + 1, n_temp, n_eta), 2e-22, gen, device)
    kmajor = kmajor * torch.linspace(0.3, 1.5, n_press + 1, **f64)[None, :, None, None]
    key_species = tuple(((1, 2), (1, 2)) if b % 2 == 0 else ((3, 2), (3, 3)) for b in range(n_bnd))
    vmr_ref = torch.abs(1.0 + 0.2 * torch.randn((2, len(GAS_NAMES) + 1, n_temp), generator=gen, **f64)) + 0.1
    eta_half = torch.stack([
        torch.stack([vmr_ref[t, key_species[b][t][0]] / vmr_ref[t, key_species[b][t][1]] for t in (0, 1)])
        for b in range(n_bnd)
    ])

    def minor():
        # (gas, scaling gas, scales with density, by complement, band)
        specs = ((4, 0, True, False, 0), (5, 1, True, True, 0), (6, 0, False, False, min(1, n_bnd - 1)))
        intervals, rows, k0 = [], [], 0
        for gas, sgas, dens, compl, band in specs:
            g0, g1 = bnd_lims_gpt[band]
            intervals.append((gas, sgas, dens, compl, g0, g1, k0))
            rows.append(_smooth((g1 - g0, n_temp, n_eta), 3e-24, gen, device))
            k0 += g1 - g0
        return tuple(intervals), torch.cat(rows)

    minor_lower, kminor_lower = minor()
    minor_upper, kminor_upper = minor()
    out = dict(kmajor=kmajor, kminor_lower=kminor_lower, kminor_upper=kminor_upper, eta_half=eta_half,
               planck_fraction=None, totplnk=None, rayl=None, solar_src_scaled=None)
    t_planck_min = t_planck_delta = solar_src_tot = 0.0
    if longwave:
        pf = torch.abs(_smooth((n_gpt, n_press + 1, n_temp, n_eta), 1.0, gen, device))
        pf = pf.reshape(n_bnd, per_bnd, *pf.shape[1:])
        out["planck_fraction"] = (pf / pf.sum(dim=1, keepdim=True)).reshape(n_gpt, *pf.shape[2:])
        t_planck = torch.linspace(160.0, 355.0, dims["n_t_plnk"], **f64)
        t_planck_min, t_planck_delta = 160.0, float(t_planck[1] - t_planck[0])
        share = 0.8 + 0.4 * torch.arange(n_bnd, **f64) / max(n_bnd - 1, 1)
        out["totplnk"] = (5.67e-8 * t_planck**4 / math.pi)[:, None] / n_bnd * share[None, :]
    else:
        out["rayl"] = _smooth((2, n_gpt, n_temp, n_eta), 1e-26, gen, device)
        src = torch.abs(1.0 + 0.3 * torch.randn(n_gpt, generator=gen, **f64)) + 0.2
        out["solar_src_scaled"] = src / src.sum()
        solar_src_tot = 1361.0
    out = {k: None if v is None else v.to(dtype) for k, v in out.items()}
    ln_p0, ln_p1 = math.log(float(p_ref[0])), math.log(float(p_ref[1]))
    out["meta"] = dict(
        idx_h2o=1, p_ref_tropo=9948.4, p_ref_min=float(p_ref.min()), key_species=key_species,
        bnd_lims_gpt=bnd_lims_gpt, minor_lower=minor_lower, minor_upper=minor_upper,
        gas_names=GAS_NAMES, n_eta=n_eta, n_press=n_press, n_temp=n_temp,
        t_ref_min=float(t_ref[0]), t_ref_delta=float(t_ref[1] - t_ref[0]),
        ln_p_ref_max=ln_p0, ln_p_ref_delta=ln_p0 - ln_p1,
        t_planck_min=t_planck_min, t_planck_delta=t_planck_delta, solar_src_tot=solar_src_tot,
    )
    return out


def cloud_tables(dims: dict, n_bnd: int, gen, device, dtype) -> dict:
    """Liquid and ice cloud optics against effective radius."""
    nl, ni, nr = dims["nsize_liq"], dims["nsize_ice"], dims["nrghice"]
    f64 = dict(device=device, dtype=torch.float64)
    normal = lambda mean, sd, shape: mean + sd * torch.randn(shape, generator=gen, **f64)
    liq = torch.stack([torch.abs(normal(0.1, 0.02, (nl, n_bnd))) + 0.02,
                       normal(0.6, 0.1, (nl, n_bnd)).clamp(0.05, 0.999),
                       normal(0.85, 0.05, (nl, n_bnd)).clamp(0.0, 0.99)])
    ice = torch.stack([torch.abs(normal(0.05, 0.01, (ni, n_bnd, nr))) + 0.01,
                       normal(0.55, 0.1, (ni, n_bnd, nr)).clamp(0.05, 0.999),
                       normal(0.8, 0.05, (ni, n_bnd, nr)).clamp(0.0, 0.99)])
    scalar = lambda v: torch.tensor(v, **f64)
    out = dict(liq=liq, ice=ice, bnd_lims_wn=torch.linspace(10.0, 3000.0, 2 * n_bnd, **f64).reshape(2, n_bnd),
               radliq_lwr=scalar(2.5), radliq_upr=scalar(21.5), radice_lwr=scalar(10.0), radice_upr=scalar(90.0))
    out = {k: v.to(dtype) for k, v in out.items()}
    out["meta"] = dict(nsize_liq=nl, nsize_ice=ni, nrghice=nr)
    return out


def aerosol_tables(dims: dict, n_bnd: int, gen, device, dtype) -> dict:
    """MERRA aerosol optics: dust and sea salt by size bin, the hydrophilic
    species by relative humidity."""
    nbin, nrh = dims["n_bin"], dims["n_rh"]
    f64 = dict(device=device, dtype=torch.float64)
    normal = lambda mean, sd, shape: mean + sd * torch.randn(shape, generator=gen, **f64)

    def props(shape):
        return torch.stack([torch.abs(normal(0.3, 0.05, shape)) + 0.05,
                            normal(0.7, 0.1, shape).clamp(0.05, 0.999),
                            normal(0.6, 0.1, shape).clamp(0.0, 0.95)])

    out = dict(
        size_bin_limits=torch.tensor([[0.1, 1.0, 2.0, 3.0, 6.0], [1.0, 2.0, 3.0, 6.0, 10.0]], **f64)[:, :nbin],
        rh_levels=torch.linspace(0.0, 0.99, nrh, **f64),
        dust=props((nbin, n_bnd)), sea_salt=props((nrh, nbin, n_bnd)), sulfate=props((nrh, n_bnd)),
        black_carbon_rh=props((nrh, n_bnd)), black_carbon=props((n_bnd,)),
        organic_carbon_rh=props((nrh, n_bnd)), organic_carbon=props((n_bnd,)),
        bnd_lims_wn=torch.linspace(2600.0, 50000.0, 2 * n_bnd, **f64).reshape(2, n_bnd),
    )
    out = {k: v.to(dtype) for k, v in out.items()}
    out["meta"] = dict(iband_550nm=min(1, n_bnd - 1), n_bin=nbin, n_rh=nrh)
    return out


def atmosphere(cfg: dict, gen, device, dtype) -> dict:
    """One atmospheric state of ``cfg["ncol"]`` x ``cfg["nlay"]`` (level 0
    = surface): surface pressure and temperature drawn per column, with
    clouds (fraction 0 or 1 between 100 and 900 hPa, every third column
    clear, times a uniform draw in ``cloud_scale``) and aerosols in the
    layers below 800 hPa when the configuration has them."""
    ncol, nlay = cfg["ncol"], cfg["nlay"]
    f64 = dict(device=device, dtype=torch.float64)
    p0 = 101000.0 + 500.0 * torch.randn(ncol, generator=gen, **f64)
    t_sfc = 288.0 + 5.0 * torch.randn(ncol, generator=gen, **f64)
    s = torch.linspace(0.0, 1.0, nlay + 1, **f64)[:, None]
    ln_p0 = torch.log(p0)[None, :]
    p_lev = torch.exp(ln_p0 + (math.log(cfg["p_top"]) - ln_p0) * s)
    p_lay = 0.5 * (p_lev[:-1] + p_lev[1:])
    lapse = lambda p: (t_sfc[None, :] + 45.0 * torch.log(p / p[0:1]) / math.log(0.1)).clamp(205.0, 320.0)
    t_lay, t_lev = lapse(p_lay), lapse(p_lev)
    vmr_h2o = 8e-3 * (p_lay / p_lay[0:1]) ** 2 + 3e-6
    vmr_o3 = 5e-8 + 8e-6 * torch.exp(-torch.log(p_lay / 2500.0) ** 2)
    vmr_gm = torch.zeros(len(GAS_NAMES) + 1, **f64)
    for idx, val in GLOBAL_MEAN_VMR.items():
        vmr_gm[idx] = val
    m_air = MOLMASS_DRYAIR + MOLMASS_WATER * vmr_h2o
    col_dry = (p_lev[:-1] - p_lev[1:]) * AVOGAD / (1.0e4 * m_air * GRAV)
    st = dict(p_lay=p_lay, t_lay=t_lay, p_lev=p_lev, t_lev=t_lev, t_sfc=t_sfc, col_dry=col_dry,
              vmr_h2o=vmr_h2o, vmr_o3=vmr_o3, vmr_gm=vmr_gm)
    if cfg["sky"] == "allsky":
        lo, hi = cfg["cloud_scale"]
        cols = torch.arange(ncol, device=device)[None, :]
        in_cloud = (p_lay > 10000.0) & (p_lay < 90000.0) & (cols % 3 != 2)
        scale = lo + (hi - lo) * torch.rand((nlay, ncol), generator=gen, **f64)
        warm = t_lay > 263.0
        where = lambda m, v: torch.where(m, v, 0.0)
        st["cloud"] = dict(cld_r_eff_liq=where(in_cloud & warm, 12.0), cld_r_eff_ice=where(in_cloud & ~warm, 35.0),
                           cld_path_liq=where(in_cloud & warm, 60.0), cld_path_ice=where(in_cloud & ~warm, 80.0),
                           cld_frac=where(in_cloud, scale), ice_rgh=2)
    if cfg["aerosols"]:
        mass = torch.zeros((N_AEROSOL_SPECIES, nlay, ncol), **f64)
        size = torch.zeros_like(mass)
        low = p_lay > 80000.0
        # dust1, sea_salt1, sulfate, black carbon (hydrophobic): mass, size
        for i, m, r in ((0, 1e-5, 0.5), (1, 2e-5, 0.8), (2, 5e-6, 0.0), (4, 1e-6, 0.0)):
            mass[i] = torch.where(low, m, 0.0)
            size[i] = torch.where(low, r, 0.0)
        st["aerosol"] = dict(aero_size=size, aero_mass=mass)
        mmr = vmr_h2o * (MOLMASS_WATER / MOLMASS_DRYAIR)
        q = torch.clamp(mmr / (1.0 + mmr), min=1e-7)
        es = torch.exp(17.67 * (t_lay - 273.16) / (t_lay - 29.65))
        st["rel_hum"] = torch.clamp(0.01 * 0.263 * p_lay * q / es, min=0.0)
    return cast_tree(st, dtype)


def cast_tree(tree, dtype):
    """A dict tree with every floating tensor cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype).contiguous()
    return tree


def boundary(cfg: dict, device, dtype) -> dict:
    """Surface emissivity, cosine of the solar zenith angle, TOA flux and
    surface albedo, the same in every column."""
    b, ncol = cfg["boundary"], cfg["ncol"]
    full = lambda shape, v: torch.full(shape, v, device=device, dtype=dtype)
    nlw, nsw = cfg["lw"]["n_bnd"], cfg["sw"]["n_bnd"]
    return dict(sfc_emis=full((nlw, ncol), b["sfc_emis"]), cos_zenith=full((ncol,), b["cos_zenith"]),
                toa_flux=full((ncol,), b["toa_flux"]), sfc_alb_direct=full((nsw, ncol), b["sfc_alb"]),
                sfc_alb_diffuse=full((nsw, ncol), b["sfc_alb"]))


def make_inputs(cfg: dict, seed: int, n_states: int, device) -> dict:
    """Tables, ``n_states`` atmospheric states and the boundary values of a
    configuration, from ``seed``, in the configuration's dtype."""
    dtype = getattr(torch, cfg["dtype"])
    gen = generator(seed, 0, device)
    tables = dict(lw=gas_tables(cfg["lw"], True, gen, device, dtype),
                  sw=gas_tables(cfg["sw"], False, gen, device, dtype))
    if cfg["sky"] == "allsky":
        tables["lw_cld"] = cloud_tables(cfg["cloud"], cfg["lw"]["n_bnd"], gen, device, dtype)
        tables["sw_cld"] = cloud_tables(cfg["cloud"], cfg["sw"]["n_bnd"], gen, device, dtype)
    if cfg["aerosols"]:
        tables["lw_aero"] = aerosol_tables(cfg["aerosol"], cfg["lw"]["n_bnd"], gen, device, dtype)
        tables["sw_aero"] = aerosol_tables(cfg["aerosol"], cfg["sw"]["n_bnd"], gen, device, dtype)
    states = [atmosphere(cfg, generator(seed, 1 + k, device), device, dtype) for k in range(n_states)]
    return dict(tables=tables, states=states, bcs=boundary(cfg, device, dtype))
