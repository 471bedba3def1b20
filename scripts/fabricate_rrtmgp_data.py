"""Write a fabricated rrtmgp-data checkout from lookups and atmospheres held
in memory, for driving the port's loaders without the real data.

    from fabricate_rrtmgp_data import write_checkout   # scripts/ on sys.path

The files are NetCDF3 (``scipy.io.netcdf_file``, so no h5py is needed to
read them) in the layout of rrtmgp-data v1.9: the v1.9 file names and
dimension names, every variable in the axis order of the real files, some
(``reverse=``) with their axes reversed, the lookups' 0-based g-point
limits and kminor starts written 1-based. ``with_hard_cases`` adds what the
synthetic lookups lack and real files have: a band whose upper key species
is written 0/0 (the loader makes it 2/2), a minor gas missing from
``gas_names`` (the loader makes it gas 0, which the solves skip), two
intervals over one g-point range, density scaling without a scaling gas
over part of a band, the h2o_self alias, and more intervals a side than
the synthetic lookup has. The expected lookup it returns is what the
loader must give back: the same integer metadata, and float tables equal
to rounding (the pressure grid is written as exp of its log grid).

Used by ``chip_smoke.py`` (the data phase) and the CPU tests
(``tests/test_torch_loader.py``, ``test_torch_readers.py``). Writes with
numpy and scipy; the lookups come in as the port's containers
(``lookup_numpy``).
"""

from __future__ import annotations

import os

import numpy as np

from rrtmgp_tpu_torch.convert import (
    AEROSOL_LOOKUP_ARRAYS as AEROSOL_ARRAYS,
    AEROSOL_LOOKUP_META as AEROSOL_META,
    CLOUD_LOOKUP_ARRAYS as CLOUD_ARRAYS,
    CLOUD_LOOKUP_META as CLOUD_META,
    GAS_LOOKUP_ARRAYS as GAS_ARRAYS,
    GAS_LOOKUP_META as GAS_META,
)
from rrtmgp_tpu_torch.data.manifest import V19_FILES as FILES

STRLEN = 32
RFMIP_FILE = os.path.join("examples", "rfmip-clear-sky", "inputs",
                          "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc")
ALLSKY_FILE = os.path.join("examples", "all-sky", "reference", "rrtmgp-allsky-lw.nc")
#: RFMIP global-mean variable of each gas the synthetic lookups name
GM_VARS = {"co2": "carbon_dioxide_GM", "n2o": "nitrous_oxide_GM", "co": "carbon_monoxide_GM",
           "ch4": "methane_GM", "o2": "oxygen_GM", "n2": "nitrogen_GM"}
#: the solar source's facular and sunspot indices the SW file carries
MG_DEFAULT, SB_DEFAULT = 0.1567652, 902.71260


def lookup_numpy(lkp, arrays, meta) -> tuple[dict, dict]:
    """(arrays, metadata) of a lookup container as numpy float64 arrays and
    plain values; ``arrays`` / ``meta`` name its fields."""
    out = {k: getattr(lkp, k) for k in arrays}
    out = {k: None if v is None else v.detach().cpu().double().numpy() for k, v in out.items()}
    return out, {k: getattr(lkp, k) for k in meta}


def _gas_index(name: str, gas_names) -> int:
    """The loader's index of a gas name: 1-based position, the h2o aliases, 0 if absent."""
    if name in ("h2o_frgn", "h2o_self"):
        name = "h2o"
    return gas_names.index(name) + 1 if name in gas_names else 0


def _name(idx: int, gas_names) -> str:
    return gas_names[idx - 1] if idx > 0 else ""


def with_hard_cases(arrays: dict, meta: dict, seed: int = 0) -> tuple[dict, dict, dict]:
    """The lookup with the loader's hard cases added (module docstring).
    Returns (arrays, metadata, names): the expected lookup, and what the
    file holds where the two differ: ``names["key_species"]`` the pairs as
    written (0/0 where the loader makes 2/2), ``names["lower"]`` /
    ``["upper"]`` each interval's (gas name, scaling gas name)."""
    arrays, meta = dict(arrays), dict(meta)
    gas_names = tuple(meta["gas_names"])
    lims = meta["bnd_lims_gpt"]
    band = lambda k: lims[min(k, len(lims) - 1)]
    rng = np.random.default_rng(seed)

    ks = [list(map(tuple, pairs)) for pairs in meta["key_species"]]
    written = [list(p) for p in ks]
    same = [b for b in range(len(ks)) if ks[b][1][0] == ks[b][1][1]]
    if not same:
        raise ValueError("no band keyed by one gas on its upper side, to write as 0/0")
    b0 = same[-1]
    written[b0][1] = (0, 0)
    ks[b0][1] = (2, 2)   # vmr_ref[2] / vmr_ref[2] = 1: eta_half stays 1
    meta["key_species"] = tuple(tuple(p) for p in ks)

    g0, g1 = band(3)
    extras = [  # (gas name, scaling gas name, scales with density, by complement, (gpt0, gpt1))
        ("cfc11", "o2", True, False, band(2)),        # absent from gas_names: gas 0, skipped
        ("co2", "h2o", True, False, band(0)),         # the g-points of the first interval
        ("o3", "", True, False, (g0, (g0 + g1) // 2)),  # density scaling, no scaling gas, part of a band
        ("h2o_self", "", False, False, band(4)),      # the h2o alias
    ]
    names = {"key_species": tuple(tuple(p) for p in written)}
    Itv = type(meta["minor_lower"][0])  # the lookup's MinorInterval
    for side in ("lower", "upper"):
        intervals = list(meta[f"minor_{side}"])
        names[side] = [(_name(i.gas, gas_names), _name(i.scaling_gas, gas_names)) for i in intervals]
        kminor = arrays[f"kminor_{side}"]
        rows = [kminor]
        k0 = kminor.shape[0]
        for gas, sgas, dens, compl, (a, b) in extras:
            intervals.append(Itv(_gas_index(gas, gas_names), _gas_index(sgas, gas_names), dens, compl, a, b, k0))
            names[side].append((gas, sgas))
            rows.append(3e-24 * np.exp(0.5 * rng.normal(size=(b - a, *kminor.shape[1:]))))
            k0 += b - a
        meta[f"minor_{side}"] = tuple(intervals)
        arrays[f"kminor_{side}"] = np.concatenate(rows, axis=0)
    return arrays, meta, names


def _vmr_ref(eta_half: np.ndarray, key_species, n_gas: int) -> np.ndarray:
    """A vmr_ref (2, n_gas + 1, ntemp) whose key-species ratios are
    ``eta_half``: every denominator gas 1, every numerator gas its ratio."""
    vmr = np.ones((2, n_gas + 1, eta_half.shape[-1]))
    role = {}
    for b, pairs in enumerate(key_species):
        for t, (g1, g2) in enumerate(pairs):
            if g1 == g2:
                if not np.all(eta_half[b, t] == 1.0):
                    raise ValueError(f"band {b}: key species {g1}/{g1} with eta_half != 1")
                continue
            ratio = role.setdefault((t, g1), ("num", eta_half[b, t]))
            if role.setdefault((t, g2), ("den", None))[0] != "den" or ratio[0] != "num" \
                    or not np.array_equal(ratio[1], eta_half[b, t]):
                raise ValueError(f"band {b}: key species {g1}/{g2} conflict with another band's")
            vmr[t, g1] = eta_half[b, t]
    return vmr


class _File:
    """A NetCDF3 file being written: dimensions created as variables need them."""

    def __init__(self, path: str, reverse=()):
        from scipy.io import netcdf_file

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = netcdf_file(path, "w")
        self.reverse = set(reverse)

    def dim(self, name: str, size: int) -> None:
        if name not in self.f.dimensions:
            self.f.createDimension(name, size)
        elif self.f.dimensions[name] != size:
            raise ValueError(f"dimension {name}: {self.f.dimensions[name]} != {size}")

    def var(self, name: str, dims: tuple, data, kind: str = "d") -> None:
        data = np.asarray(data)
        if name in self.reverse and data.ndim > 1:
            dims, data = tuple(dims)[::-1], np.transpose(data)
        for d, n in zip(dims, data.shape):
            self.dim(d, n)
        v = self.f.createVariable(name, kind, dims)
        v[:] = data.astype(np.int32) if kind == "i" else data

    def strings(self, name: str, dim: str, values) -> None:
        arr = np.full((len(values), STRLEN), b" ", dtype="S1")
        for i, s in enumerate(values):
            arr[i, : len(s)] = list(s)
        self.var(name, (dim, "string_len"), arr, "c")

    def close(self) -> None:
        self.f.close()


def write_gas_file(path: str, arrays: dict, meta: dict, names: dict | None = None, reverse=()) -> None:
    """An rrtmgp-gas-*.nc file holding the lookup ``arrays`` / ``meta``
    (``lookup_numpy``; ``names`` from ``with_hard_cases``, else the
    lookup's own). ``reverse``: variables written with their axes reversed."""
    gas_names = tuple(meta["gas_names"])
    lw = arrays["planck_fraction"] is not None
    n_press, n_temp = meta["n_press"], meta["n_temp"]
    names = names or {
        "key_species": meta["key_species"],
        **{s: [(_name(i.gas, gas_names), _name(i.scaling_gas, gas_names)) for i in meta[f"minor_{s}"]]
           for s in ("lower", "upper")},
    }
    f = _File(path, reverse)
    f.dim("atmos_layer", 2)
    f.dim("pair", 2)
    f.dim("one", 1)
    f.strings("gas_names", "absorber", gas_names)
    p_ref = np.exp(meta["ln_p_ref_max"] - meta["ln_p_ref_delta"] * np.arange(n_press))
    f.var("press_ref", ("pressure",), p_ref)
    f.dim("pressure_interp", n_press + 1)
    f.var("temp_ref", ("temperature",), meta["t_ref_min"] + meta["t_ref_delta"] * np.arange(n_temp))
    f.var("press_ref_trop", ("one",), [meta["p_ref_tropo"]])
    f.var("key_species", ("bnd", "atmos_layer", "pair"), np.asarray(names["key_species"]), "i")
    f.var("bnd_limits_gpt", ("bnd", "pair"), [(a + 1, b) for a, b in meta["bnd_lims_gpt"]], "i")
    # the tables in the real files' C order: (temperature, pressure_interp, mixing_fraction, gpt)
    order4 = ("temperature", "pressure_interp", "mixing_fraction", "gpt")
    f.var("kmajor", order4, np.transpose(arrays["kmajor"], (2, 1, 3, 0)))
    f.var("vmr_ref", ("atmos_layer", "absorber_ext", "temperature"),
          _vmr_ref(arrays["eta_half"], meta["key_species"], len(gas_names)))
    for side in ("lower", "upper"):
        itv = meta[f"minor_{side}"]
        n = f"minor_absorber_intervals_{side}"
        f.strings(f"minor_gases_{side}", n, [g for g, _ in names[side]])
        f.strings(f"scaling_gas_{side}", n, [s for _, s in names[side]])
        f.var(f"minor_scales_with_density_{side}", (n,), [i.scales_with_density for i in itv], "i")
        f.var(f"scale_by_complement_{side}", (n,), [i.scale_by_complement for i in itv], "i")
        f.var(f"minor_limits_gpt_{side}", (n, "pair"), [(i.gpt0 + 1, i.gpt1) for i in itv], "i")
        f.var(f"kminor_start_{side}", (n,), [i.k0 + 1 for i in itv], "i")
        f.var(f"kminor_{side}", ("temperature", "mixing_fraction", f"contributors_{side}"),
              np.transpose(arrays[f"kminor_{side}"], (1, 2, 0)))
    if lw:
        f.var("plank_fraction", order4, np.transpose(arrays["planck_fraction"], (2, 1, 3, 0)))
        n_t = arrays["totplnk"].shape[0]
        f.var("temperature_Planck", ("temperature_Planck",),
              meta["t_planck_min"] + meta["t_planck_delta"] * np.arange(n_t))
        f.var("totplnk", ("temperature_Planck", "bnd"), arrays["totplnk"])
    else:
        for k, side in enumerate(("lower", "upper")):
            f.var(f"rayl_{side}", ("temperature", "mixing_fraction", "gpt"),
                  np.transpose(arrays["rayl"][k], (1, 2, 0)))
        # quiet + (mg - a) facular + (sb - b) sunspot = the lookup's source
        target = arrays["solar_src_scaled"] * meta["solar_src_tot"]
        facular = 0.01 * target
        sunspot = 1e-6 * target
        quiet = target - (MG_DEFAULT - 0.1495954) * facular - (SB_DEFAULT - 0.00066696) * sunspot
        f.var("solar_source_quiet", ("gpt",), quiet)
        f.var("solar_source_facular", ("gpt",), facular)
        f.var("solar_source_sunspot", ("gpt",), sunspot)
        f.var("mg_default", ("one",), [MG_DEFAULT])
        f.var("sb_default", ("one",), [SB_DEFAULT])
    f.close()


def write_cloud_file(path: str, arrays: dict, meta: dict, reverse=()) -> None:
    """An rrtmgp-clouds-*-bnd.nc file of a cloud lookup (``lookup_numpy``)."""
    f = _File(path, reverse)
    f.dim("one", 1)
    for k, name in enumerate(("ext", "ssa", "asy")):
        f.var(f"{name}liq", ("nband", "nsize_liq"), arrays["liq"][k].T)
        f.var(f"{name}ice", ("nrghice", "nband", "nsize_ice"), np.transpose(arrays["ice"][k], (2, 1, 0)))
    for k in ("radliq_lwr", "radliq_upr"):
        f.var(k, ("one",), [float(arrays[k])])
    f.var("diamice_lwr", ("one",), [2.0 * float(arrays["radice_lwr"])])
    f.var("diamice_upr", ("one",), [2.0 * float(arrays["radice_upr"])])
    f.var("bnd_limits_wavenumber", ("nband", "pair"), arrays["bnd_lims_wn"].T)
    f.close()


def aerosol_band_limits(nbnd: int) -> np.ndarray:
    """(2, nbnd) wavenumber limits [cm^-1] with 550 nm (18182 cm^-1) in band 1."""
    edges = np.concatenate([[2600.0, 16000.0], 20000.0 + 2500.0 * np.arange(nbnd - 1)])
    return np.stack([edges[:-1], edges[1:]])


def write_aerosol_file(path: str, arrays: dict, meta: dict, reverse=()) -> None:
    """An rrtmgp-aerosols-merra-*.nc file of an aerosol lookup
    (``lookup_numpy``); its tables in the real files' order, the axes of
    the lookup's reversed."""
    f = _File(path, reverse)
    f.var("merra_aero_bin_lims", ("nbin", "pair"), arrays["size_bin_limits"].T)
    f.var("aero_rh", ("nrh",), arrays["rh_levels"])
    dims = {"dust": ("nval", "nbin", "nband"), "sea_salt": ("nval", "nrh", "nbin", "nband"),
            "sulfate": ("nval", "nrh", "nband"), "black_carbon_rh": ("nval", "nrh", "nband"),
            "black_carbon": ("nval", "nband"), "organic_carbon_rh": ("nval", "nrh", "nband"),
            "organic_carbon": ("nval", "nband")}
    var = {"dust": "aero_dust_tbl", "sea_salt": "aero_salt_tbl", "sulfate": "aero_sulf_tbl",
           "black_carbon_rh": "aero_bcar_rh_tbl", "black_carbon": "aero_bcar_tbl",
           "organic_carbon_rh": "aero_ocar_rh_tbl", "organic_carbon": "aero_ocar_tbl"}
    for k, d in dims.items():
        f.var(var[k], d[::-1], np.transpose(arrays[k]))
    f.var("bnd_limits_wavenumber", ("nband", "pair"), arrays["bnd_lims_wn"].T)
    f.close()


def write_rfmip_file(path: str, atm: dict, gm: dict, sfc_emis, sfc_alb, zenith_deg, tsi, nexpt: int = 2) -> None:
    """An RFMIP input file: ``atm`` surface-first (nlev|nlay, nsite) arrays
    p_lev, p_lay, t_lev, t_lay, vmr_h2o, vmr_o3 and t_sfc (nsite,), written
    TOA-first as (site, level) with an experiment axis on the
    per-experiment fields (experiment 0 these values, the others scaled
    decoys); ``gm`` global means by RFMIP variable name; the surface and
    sun per site."""
    f = _File(path)
    expt = lambda a: np.stack([a * (1.0 + 0.01 * e) for e in range(nexpt)])
    toa_first = lambda a: a[::-1].T
    f.var("pres_level", ("site", "level"), toa_first(atm["p_lev"]))
    f.var("pres_layer", ("site", "layer"), toa_first(atm["p_lay"]))
    f.var("temp_level", ("expt", "site", "level"), expt(toa_first(atm["t_lev"])))
    f.var("temp_layer", ("expt", "site", "layer"), expt(toa_first(atm["t_lay"])))
    f.var("water_vapor", ("expt", "site", "layer"), expt(toa_first(atm["vmr_h2o"])))
    f.var("ozone", ("expt", "site", "layer"), expt(toa_first(atm["vmr_o3"])))
    f.var("surface_temperature", ("expt", "site"), expt(atm["t_sfc"]))
    f.var("surface_emissivity", ("site",), sfc_emis)
    f.var("surface_albedo", ("site",), sfc_alb)
    f.var("solar_zenith_angle", ("site",), zenith_deg)
    f.var("total_solar_irradiance", ("site",), tsi)
    for name, value in gm.items():
        f.var(name, ("expt",), expt(np.asarray(value)))
    f.close()


def write_allsky_file(path: str, atm: dict, aero: dict, fluxes: dict | None = None) -> None:
    """An rrtmgp-allsky-*.nc example file: ``atm`` surface-first (nlev|nlay,
    ncol) arrays p_lev, p_lay, t_lev, t_lay, h2o, o3 and ``aero`` (nlay,
    ncol) aero_type (1-based MERRA species, 0 none), aero_size, aero_mass,
    written TOA-first as (lev|lay, col); ``fluxes`` surface-first (nlev,
    ncol) by variable name (e.g. lw_flux_up)."""
    f = _File(path)
    for k in ("p_lev", "t_lev"):
        f.var(k, ("lev", "col"), atm[k][::-1])
    for k in ("p_lay", "t_lay", "h2o", "o3"):
        f.var(k, ("lay", "col"), atm[k][::-1])
    for k in ("aero_type", "aero_size", "aero_mass"):
        f.var(k, ("lay", "col"), aero[k][::-1])
    for k, v in (fluxes or {}).items():
        f.var(k, ("lev", "col"), v[::-1])
    f.close()


def allsky_aerosols(p_lay: np.ndarray, seed: int = 5) -> dict:
    """Aerosol columns for an all-sky file: below 500 hPa a seeded MERRA
    species (1-15) in two of every three (layer, column) cells, its size and
    mass; 0 (none) elsewhere."""
    rng = np.random.default_rng(seed)
    nlay, ncol = p_lay.shape
    kind = rng.integers(1, 16, size=(nlay, ncol))
    lay, col = np.meshgrid(np.arange(nlay), np.arange(ncol), indexing="ij")
    kind[((lay + col) % 3 == 0) | (p_lay <= 50000.0)] = 0
    on = kind > 0
    return {"aero_type": kind.astype(np.float64),
            "aero_size": np.where(on, rng.uniform(0.2, 8.0, (nlay, ncol)), 0.0),
            "aero_mass": np.where(on, rng.uniform(1e-6, 2e-5, (nlay, ncol)), 0.0)}


def allsky_expected(atm: dict, aero: dict, r_eff_liq: float, r_eff_ice: float, ncol: int,
                    cldfrac: float = 1.0) -> dict:
    """What the all-sky reader must build from ``write_allsky_file(atm,
    aero)`` at ``ncol`` columns, as fields of an AtmosphericState (numpy,
    float64; col_dry and rel_hum left to the caller): the file's column 0
    tiled, the aerosols scattered into the 15 species and tiled over the
    file's columns, idealized clouds between 100 and 900 hPa in two of every
    three file columns (liquid above 263 K, ice below 273 K, path 10 g/m2)."""
    tile0 = lambda a: np.repeat(a[:, :1], ncol, axis=1)
    out = {k: tile0(atm[k]) for k in ("p_lev", "p_lay", "t_lev", "t_lay")}
    out["vmr_h2o"], out["vmr_o3"] = tile0(atm["h2o"]), tile0(atm["o3"])
    out["t_sfc"] = out["t_lev"][0].copy()
    nlay, ncol_ds = aero["aero_type"].shape
    cols = np.arange(ncol) % ncol_ds
    kind = aero["aero_type"][:, cols].astype(np.int64)
    lay, col = np.nonzero(kind > 0)
    out["aerosol_state"] = {}
    for k in ("aero_mass", "aero_size"):
        v = np.zeros((15, nlay, ncol))
        v[kind[lay, col] - 1, lay, col] = aero[k][:, cols][lay, col]
        out["aerosol_state"][k] = v
    cloudy = ((np.arange(ncol) % ncol_ds + 1) % 3 != 0)[None, :]
    p, t = out["p_lay"], out["t_lay"]
    cld = (p > 1e4) & (p < 9e4) & cloudy
    liq, ice = cld & (t > 263.0), cld & (t < 273.0)
    out["cloud_state"] = {"cld_frac": np.where(cld, cldfrac, 0.0), "ice_rgh": 2,
                          "cld_r_eff_liq": np.where(liq, r_eff_liq, 0.0),
                          "cld_r_eff_ice": np.where(ice, r_eff_ice, 0.0),
                          "cld_path_liq": np.where(liq, 10.0, 0.0), "cld_path_ice": np.where(ice, 10.0, 0.0)}
    return out


def write_checkout(root: str, lookups: dict, reverse=()) -> dict:
    """The six lookup files under ``root`` from ``lookups``: name ->
    (arrays, meta[, names]) by the keys of ``FILES`` (gas_* may carry
    ``with_hard_cases``' names). Returns name -> path."""
    os.makedirs(root, exist_ok=True)
    paths = {}
    for key, spec in lookups.items():
        path = paths[key] = os.path.join(root, FILES[key])
        if key.startswith("gas"):
            write_gas_file(path, spec[0], spec[1], spec[2] if len(spec) > 2 else None, reverse)
        elif key.startswith("cloud"):
            write_cloud_file(path, spec[0], spec[1], reverse)
        else:
            write_aerosol_file(path, spec[0], spec[1], reverse)
    return paths
