"""Loaders: rrtmgp-data NetCDF files -> lookup containers (counterpart of
``rrtmgp_tpu/data/loader.py``).

Replicates the parsing semantics of RRTMGP.jl's loaders
(``ext/lookup_constructors.jl``): gas-name -> index mapping with the
h2o_frgn/h2o_self aliases (lines 108-110), the key-species 0/0 -> 2/2 rule
(147-153), minor-gas interval metadata packing (120-144, 282-308; a minor
or scaling gas missing from ``gas_names`` becomes gas 0, which the solves
skip), the solar source composition from quiet/facular/sunspot components
(543-551), and cloud/aerosol LUT packing (602-624, 4-56).

Axis order in the file is resolved by the variable's dimension NAMES from
the NetCDF header, robust to any on-disk axis order, including size ties
(temperature == nbnd == 14 in the SW g224 file). Size matching is only a
fallback for files without dimension metadata, and warns when the mapping
is ambiguous.

Every float table is formed in numpy float64 with the JAX loader's
arithmetic in its order and cast to the requested dtype only at the end,
through ``convert``'s ``*_from_numpy`` (on the card unless ``device`` says
otherwise), so that the lookups equal the JAX package's bit for bit.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..convert import (
    aerosol_lookup_from_numpy,
    cloud_lookup_from_numpy,
    gas_lookup_from_numpy,
    torch_dtype,
)
from .lookups import AerosolLookup, CloudLookup, GasLookup, MinorInterval
from .netcdf import Dataset, char_to_strings


def _permute_to(arr: np.ndarray, sizes: tuple[int, ...]) -> np.ndarray:
    """Fallback: permute ``arr`` axes so its shape equals ``sizes`` by size
    matching. Warns when two axes share a size (the mapping is then a guess —
    dimension names should disambiguate; see ``_oriented``)."""
    if arr.shape == sizes:
        return arr
    shape_counts = {s: list(arr.shape).count(s) for s in set(arr.shape)}
    if any(c > 1 for c in shape_counts.values()):
        warnings.warn(
            f"ambiguous axis-size mapping {arr.shape} -> {sizes}: two axes "
            "share a size and the file carries no dimension names; the "
            "first-match permutation is a guess",
            stacklevel=2,
        )
    perm = []
    used = [False] * arr.ndim
    for s in sizes:
        for i, d in enumerate(arr.shape):
            if d == s and not used[i]:
                perm.append(i)
                used[i] = True
                break
        else:
            raise ValueError(f"cannot map shape {arr.shape} to {sizes}")
    return np.transpose(arr, perm)


def _oriented(
    ds: Dataset,
    name: str,
    want_dims: tuple[str, ...],
    want_sizes: tuple[int, ...],
    np_dtype=np.float64,
) -> np.ndarray:
    """Read variable ``name`` permuted into ``want_dims`` axis order.

    Primary path: the variable's dimension names from the NetCDF header
    (``ds.var_dims``) give the exact permutation regardless of on-disk order.
    Fallback (files without dimension metadata): size matching via
    ``_permute_to``. The result shape is always verified against
    ``want_sizes``.
    """
    arr = np.asarray(ds[name], np_dtype)
    dims = ds.var_dims.get(name, ())
    if (
        len(dims) == arr.ndim
        and len(set(dims)) == arr.ndim
        and all(d in dims for d in want_dims)
        and len(want_dims) == arr.ndim
    ):
        out = np.transpose(arr, [dims.index(d) for d in want_dims])
    else:
        out = _permute_to(arr, want_sizes)
    if out.shape != tuple(want_sizes):
        raise ValueError(
            f"{name}: expected shape {tuple(want_sizes)} (dims {want_dims}), "
            f"got {out.shape} from file dims {dims} shape {arr.shape}"
        )
    return out


def _uniform_grid(x: np.ndarray) -> tuple[float, float]:
    """Return (x0, dx), raising unless the grid is uniform."""
    dx = float(x[1] - x[0])
    if not np.allclose(np.diff(x), dx, rtol=1e-6):
        raise ValueError("grid is not uniform")
    return float(x[0]), dx


def _minor_intervals(
    names: list[str],
    scaling_names: list[str],
    scales_density: np.ndarray,
    scale_complement: np.ndarray,
    gpt_lims: np.ndarray,       # (2, n) or (n, 2), 1-based inclusive
    kminor_start: np.ndarray,   # (n,), 1-based
    idx_gases: dict[str, int],
) -> tuple[MinorInterval, ...]:
    n = len(names)
    if gpt_lims.shape == (2, n) and n != 2:
        lims = gpt_lims.T
    else:
        lims = gpt_lims.reshape(n, 2)
    out = []
    for i in range(n):
        gas = idx_gases.get(names[i], 0)
        sgas = idx_gases.get(scaling_names[i], 0)
        out.append(
            MinorInterval(
                gas=int(gas),
                scaling_gas=int(sgas),
                scales_with_density=bool(scales_density[i]),
                scale_by_complement=bool(scale_complement[i]),
                gpt0=int(lims[i, 0]) - 1,
                gpt1=int(lims[i, 1]),
                k0=int(kminor_start[i]) - 1,
            )
        )
    return tuple(out)


def _dataset(path_or_ds) -> Dataset:
    return path_or_ds if isinstance(path_or_ds, Dataset) else Dataset(path_or_ds)


def load_gas_lookup(path_or_ds, dtype=np.float64, device=None) -> GasLookup:
    """Load an rrtmgp-gas-{lw,sw}-*.nc file into a :class:`GasLookup`.

    LW files carry Planck data, SW files carry Rayleigh + solar source
    (detected from variable presence, as RRTMGP.jl's LookUpLW / LookUpSW).
    ``dtype`` (numpy or torch, float32 or float64) and ``device`` (None: the
    card when there is one) are those of the tables.
    """
    ds = _dataset(path_or_ds)

    n_bnd = int(ds.dims["bnd"])
    n_gpt = int(ds.dims["gpt"])
    n_t_ref = int(ds.dims["temperature"])
    n_p_ref = int(ds.dims["pressure"])
    n_eta = int(ds.dims["mixing_fraction"])

    gas_names = char_to_strings(ds["gas_names"])
    # 1-based gas indices, as in the reference loader
    idx_gases = {name: i + 1 for i, name in enumerate(gas_names)}
    idx_h2o = idx_gases["h2o"]
    idx_gases["h2o_frgn"] = idx_h2o
    idx_gases["h2o_self"] = idx_h2o
    idx_gases[""] = 0

    p_ref = np.asarray(ds["press_ref"], np.float64)
    t_ref = np.asarray(ds["temp_ref"], np.float64)
    p_ref_tropo = float(np.ravel(ds["press_ref_trop"])[0])
    t0, dt = _uniform_grid(t_ref)
    ln_p = np.log(p_ref)
    lnp0, neg_dlnp = _uniform_grid(ln_p)
    dlnp = -neg_dlnp  # pressures decrease; store positive delta

    # key species with the 0/0 -> 2/2 rule
    ks = _oriented(ds, "key_species", ("bnd", "atmos_layer", "pair"), (n_bnd, 2, 2), np.int64)
    key_species = []
    for b in range(n_bnd):
        pairs = []
        for t in range(2):
            g1, g2 = int(ks[b, t, 0]), int(ks[b, t, 1])
            if g1 == 0 and g2 == 0:
                g1 = g2 = 2
            pairs.append((g1, g2))
        key_species.append(tuple(pairs))
    key_species = tuple(key_species)

    bnd_lims = _oriented(ds, "bnd_limits_gpt", ("bnd", "pair"), (n_bnd, 2), np.int64)
    # size-fallback guard: ensure (n_bnd, 2) orientation even when n_bnd == 2
    if bnd_lims.shape[0] == 2 and n_bnd == 2 and bnd_lims[0, 1] < bnd_lims[0, 0]:
        bnd_lims = bnd_lims.T
    bnd_lims_gpt = tuple((int(a) - 1, int(b)) for a, b in bnd_lims)

    kmajor = _oriented(
        ds, "kmajor",
        ("gpt", "pressure_interp", "temperature", "mixing_fraction"),
        (n_gpt, n_p_ref + 1, n_t_ref, n_eta),
    )

    # vmr_ref: (atmos_layer=2, absorber_ext, ntemp); row ig (1-based gas) = index ig
    n_absrb_ext = int(ds.dims["absorber_ext"])
    vmr_ref = _oriented(
        ds, "vmr_ref", ("atmos_layer", "absorber_ext", "temperature"),
        (2, n_absrb_ext, n_t_ref),
    )
    eta_half = np.empty((n_bnd, 2, n_t_ref), np.float64)
    for b in range(n_bnd):
        for t in range(2):
            g1, g2 = key_species[b][t]
            eta_half[b, t] = vmr_ref[t, g1] / vmr_ref[t, g2]

    # minor gas intervals (metadata static, kminor in file order)
    def load_minor(side: str):
        names = char_to_strings(ds[f"minor_gases_{side}"])
        snames = char_to_strings(ds[f"scaling_gas_{side}"])
        dens = np.ravel(np.asarray(ds[f"minor_scales_with_density_{side}"]))
        compl = np.ravel(np.asarray(ds[f"scale_by_complement_{side}"]))
        n_itv = len(names)
        lims = _oriented(
            ds, f"minor_limits_gpt_{side}",
            (f"minor_absorber_intervals_{side}", "pair"), (n_itv, 2), np.int64,
        )
        kstart = np.ravel(np.asarray(ds[f"kminor_start_{side}"], np.int64))
        n_contrib = int(ds.dims[f"contributors_{side}"])
        kminor = _oriented(
            ds, f"kminor_{side}",
            (f"contributors_{side}", "temperature", "mixing_fraction"),
            (n_contrib, n_t_ref, n_eta),
        )
        meta = _minor_intervals(names, snames, dens, compl, lims, kstart, idx_gases)
        return meta, kminor

    minor_lower, kminor_lower = load_minor("lower")
    minor_upper, kminor_upper = load_minor("upper")

    is_lw = "plank_fraction" in ds or "planck_fraction" in ds

    planck_fraction = totplnk = rayl = solar_src_scaled = None
    t_planck_min = t_planck_delta = 0.0
    solar_src_tot = 0.0
    if is_lw:
        pf_name = "plank_fraction" if "plank_fraction" in ds else "planck_fraction"
        planck_fraction = _oriented(
            ds, pf_name,
            ("gpt", "pressure_interp", "temperature", "mixing_fraction"),
            (n_gpt, n_p_ref + 1, n_t_ref, n_eta),
        )
        t_planck = np.asarray(ds["temperature_Planck"], np.float64)
        n_t_plnk = t_planck.shape[0]
        t_planck_min, t_planck_delta = _uniform_grid(t_planck)
        totplnk = _oriented(
            ds, "totplnk", ("temperature_Planck", "bnd"), (n_t_plnk, n_bnd)
        )
    else:
        rdims = ("gpt", "temperature", "mixing_fraction")
        rayl_lower = _oriented(ds, "rayl_lower", rdims, (n_gpt, n_t_ref, n_eta))
        rayl_upper = _oriented(ds, "rayl_upper", rdims, (n_gpt, n_t_ref, n_eta))
        rayl = np.stack([rayl_lower, rayl_upper])
        # solar source composed from quiet + facular + sunspot
        # (RRTMGP.jl ext/lookup_constructors.jl:543-551)
        a_offset, b_offset = 0.1495954, 0.00066696
        mg = max(float(np.ravel(ds["mg_default"])[0]), 0.0)
        sb = max(float(np.ravel(ds["sb_default"])[0]), 0.0)
        solar_src = (
            np.asarray(ds["solar_source_quiet"], np.float64)
            + (mg - a_offset) * np.asarray(ds["solar_source_facular"], np.float64)
            + (sb - b_offset) * np.asarray(ds["solar_source_sunspot"], np.float64)
        )
        solar_src_tot = float(solar_src.sum())
        solar_src_scaled = solar_src / solar_src_tot

    arrays = dict(
        kmajor=kmajor, kminor_lower=kminor_lower, kminor_upper=kminor_upper,
        eta_half=eta_half, planck_fraction=planck_fraction, totplnk=totplnk,
        rayl=rayl, solar_src_scaled=solar_src_scaled,
    )
    meta = dict(
        idx_h2o=int(idx_h2o),
        p_ref_tropo=p_ref_tropo,
        p_ref_min=float(p_ref.min()),
        key_species=key_species,
        bnd_lims_gpt=bnd_lims_gpt,
        minor_lower=minor_lower,
        minor_upper=minor_upper,
        gas_names=tuple(gas_names),
        n_eta=n_eta,
        n_press=n_p_ref,
        n_temp=n_t_ref,
        t_ref_min=t0,
        t_ref_delta=dt,
        ln_p_ref_max=lnp0,
        ln_p_ref_delta=dlnp,
        t_planck_min=t_planck_min,
        t_planck_delta=t_planck_delta,
        solar_src_tot=solar_src_tot,
    )
    return gas_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)


def load_cloud_lookup(path_or_ds, dtype=np.float64, device=None) -> CloudLookup:
    """Load rrtmgp-clouds-{lw,sw}-bnd.nc (RRTMGP.jl lookup_constructors.jl:602-624)."""
    ds = _dataset(path_or_ds)
    nband = int(ds.dims["nband"])
    nrghice = int(ds.dims["nrghice"])
    nsize_liq = int(ds.dims["nsize_liq"])
    nsize_ice = int(ds.dims["nsize_ice"])

    liq = np.stack(
        [
            _oriented(ds, k, ("nsize_liq", "nband"), (nsize_liq, nband))
            for k in ("extliq", "ssaliq", "asyliq")
        ]
    )
    ice = np.stack(
        [
            _oriented(ds, k, ("nsize_ice", "nband", "nrghice"), (nsize_ice, nband, nrghice))
            for k in ("extice", "ssaice", "asyice")
        ]
    )
    scalar = lambda k: float(np.ravel(ds[k])[0])
    arrays = dict(
        liq=liq,
        ice=ice,
        bnd_lims_wn=_oriented(ds, "bnd_limits_wavenumber", ("pair", "nband"), (2, nband)),
        radliq_lwr=np.asarray(scalar("radliq_lwr")),
        radliq_upr=np.asarray(scalar("radliq_upr")),
        # ice radius bounds are the file's diameters halved
        radice_lwr=np.asarray(scalar("diamice_lwr") / 2),
        radice_upr=np.asarray(scalar("diamice_upr") / 2),
    )
    meta = dict(nsize_liq=nsize_liq, nsize_ice=nsize_ice, nrghice=nrghice)
    return cloud_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)


def load_aerosol_lookup(path_or_ds, dtype=np.float64, device=None) -> AerosolLookup:
    """Load rrtmgp-aerosols-merra-{lw,sw}.nc (RRTMGP.jl lookup_constructors.jl:4-56)."""
    ds = _dataset(path_or_ds)
    nband = int(ds.dims["nband"])
    nval = int(ds.dims["nval"])
    nbin = int(ds.dims["nbin"])
    nrh = int(ds.dims["nrh"])
    if nval != 3:
        raise ValueError(f"aerosol tables: nval = {nval}, expected 3 (ext, ssa, asy)")

    bnd_lims_wn = _oriented(ds, "bnd_limits_wavenumber", ("pair", "nband"), (2, nband))
    # 550 nm band detection (bnd_lims_wn in cm^-1)
    iband_550nm = -1
    for i in range(nband):
        if 1.0 / (bnd_lims_wn[1, i] * 100) <= 550e-9 <= 1.0 / (bnd_lims_wn[0, i] * 100):
            iband_550nm = i
            break

    adims = {2: "pair", nval: "nval", nbin: "nbin", nrh: "nrh", nband: "nband"}
    g = lambda k, shape: _oriented(ds, k, tuple(adims[s] for s in shape), shape)
    arrays = dict(
        size_bin_limits=g("merra_aero_bin_lims", (2, nbin)),
        rh_levels=np.asarray(ds["aero_rh"], np.float64),
        dust=g("aero_dust_tbl", (nval, nbin, nband)),
        sea_salt=g("aero_salt_tbl", (nval, nrh, nbin, nband)),
        sulfate=g("aero_sulf_tbl", (nval, nrh, nband)),
        black_carbon_rh=g("aero_bcar_rh_tbl", (nval, nrh, nband)),
        black_carbon=g("aero_bcar_tbl", (nval, nband)),
        organic_carbon_rh=g("aero_ocar_rh_tbl", (nval, nrh, nband)),
        organic_carbon=g("aero_ocar_tbl", (nval, nband)),
        bnd_lims_wn=bnd_lims_wn,
    )
    meta = dict(iband_550nm=iband_550nm, n_bin=nbin, n_rh=nrh)
    return aerosol_lookup_from_numpy(arrays, meta, dtype=torch_dtype(dtype), device=device)
