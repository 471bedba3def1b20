"""Build the port's containers from numpy arrays.

The JAX package's lookups, states and boundary conditions are pytrees: array
leaves plus static metadata. These functions take those leaves as numpy
arrays (``np.asarray`` of each leaf) together with the static fields and
build the matching torch containers, so the same weights and inputs feed both
packages. Nothing here imports jax.

Device: every function here, and through them ``data.synthetic`` and
``api.lookup_tables``, takes ``device``; None is ``default_device()``, the
card when there is one and the CPU otherwise, so that a solve runs on the
card unless the caller asks for the CPU (``device="cpu"``).

The kernels need no conversion of their own: the megakernels and the kernels
of the two-kernel path read ``KernelTables`` (``ops.mega_inputs``, built once
per converted ``GasLookup`` as ``lkp.kernel_tables``) and ``lkp.totplnk``.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.lookups import AerosolLookup, CloudLookup, GasLookup, MinorInterval
from .states import AerosolState, AtmosphericState, CloudState, LwBCs, SwBCs, Vmr, VmrGM

#: Array fields of GasLookup (None allowed for the LW-only / SW-only ones).
GAS_LOOKUP_ARRAYS = (
    "kmajor", "kminor_lower", "kminor_upper", "eta_half",
    "planck_fraction", "totplnk", "rayl", "solar_src_scaled",
)
#: Array and static fields of CloudLookup / AerosolLookup / CloudState.
CLOUD_LOOKUP_ARRAYS = (
    "liq", "ice", "bnd_lims_wn", "radliq_lwr", "radliq_upr", "radice_lwr", "radice_upr",
)
CLOUD_LOOKUP_META = ("nsize_liq", "nsize_ice", "nrghice")
AEROSOL_LOOKUP_ARRAYS = (
    "size_bin_limits", "rh_levels", "dust", "sea_salt", "sulfate", "black_carbon_rh",
    "black_carbon", "organic_carbon_rh", "organic_carbon", "bnd_lims_wn",
)
AEROSOL_LOOKUP_META = ("iband_550nm", "n_bin", "n_rh")
CLOUD_STATE_ARRAYS = ("cld_r_eff_liq", "cld_r_eff_ice", "cld_path_liq", "cld_path_ice", "cld_frac")
#: Static fields of GasLookup.
GAS_LOOKUP_META = (
    "idx_h2o", "p_ref_tropo", "p_ref_min", "key_species", "bnd_lims_gpt",
    "minor_lower", "minor_upper", "gas_names", "n_eta", "n_press", "n_temp",
    "t_ref_min", "t_ref_delta", "ln_p_ref_max", "ln_p_ref_delta",
    "t_planck_min", "t_planck_delta", "solar_src_tot",
)


def default_device() -> torch.device:
    """Where the port builds its tensors when the caller names no device:
    the card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


_TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """The torch float dtype of a torch or numpy dtype (np.float32 / np.float64)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPE[np.dtype(dtype).type]


def _tensor(x, dtype, device):
    if x is None:
        return None
    device = default_device() if device is None else device
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    # a C-ordered copy: the kernels take contiguous tensors, and a loader's
    # array may be a transposed view of what the file held
    return torch.from_numpy(np.array(x, order="C")).to(device=device, dtype=dtype)


def _float_dtype(x, dtype):
    if dtype is not None:
        return dtype
    return torch.float64 if np.asarray(x).dtype == np.float64 else torch.float32


def gas_lookup_from_numpy(
    arrays: dict[str, np.ndarray | None], meta: dict, *,
    dtype: torch.dtype | None = None, device=None,
) -> GasLookup:
    """GasLookup from its array fields (GAS_LOOKUP_ARRAYS) and static fields
    (GAS_LOOKUP_META). ``dtype`` defaults to the arrays' own float type."""
    dtype = _float_dtype(arrays["kmajor"], dtype)
    fields = {k: _tensor(arrays.get(k), dtype, device) for k in GAS_LOOKUP_ARRAYS}
    static = {k: meta[k] for k in GAS_LOOKUP_META}
    for side in ("minor_lower", "minor_upper"):
        static[side] = tuple(MinorInterval(*itv) for itv in static[side])
    static["key_species"] = tuple(
        tuple(tuple(int(i) for i in pair) for pair in bnd) for bnd in static["key_species"]
    )
    static["bnd_lims_gpt"] = tuple((int(a), int(b)) for a, b in static["bnd_lims_gpt"])
    return GasLookup(**fields, **static)


def gas_lookup_from_object(obj, **kwargs) -> GasLookup:
    """``gas_lookup_from_numpy`` of any object with GasLookup's field names
    (the JAX package's GasLookup among them), its arrays read with
    ``np.asarray``. ``kwargs`` go to ``gas_lookup_from_numpy``. The result's
    ``kernel_tables`` are built in its dtype: ``dtype=torch.float64`` (or f64
    arrays) feeds the f64 kernels, f32 the f32 ones."""
    arrays = {
        k: None if getattr(obj, k) is None else np.asarray(getattr(obj, k))
        for k in GAS_LOOKUP_ARRAYS
    }
    return gas_lookup_from_numpy(arrays, {k: getattr(obj, k) for k in GAS_LOOKUP_META}, **kwargs)


def _arrays_of(obj, names) -> dict:
    return {k: None if getattr(obj, k) is None else np.asarray(getattr(obj, k)) for k in names}


def cloud_lookup_from_numpy(arrays: dict, meta: dict, *, dtype=None, device=None) -> CloudLookup:
    """CloudLookup from its array fields (CLOUD_LOOKUP_ARRAYS; the radius
    bounds as 0-dim arrays) and static fields (CLOUD_LOOKUP_META)."""
    dtype = _float_dtype(arrays["liq"], dtype)
    return CloudLookup(
        **{k: _tensor(arrays[k], dtype, device) for k in CLOUD_LOOKUP_ARRAYS},
        **{k: int(meta[k]) for k in CLOUD_LOOKUP_META},
    )


def cloud_lookup_from_object(obj, **kwargs) -> CloudLookup:
    """``cloud_lookup_from_numpy`` of any object with CloudLookup's field
    names (the JAX package's CloudLookup among them)."""
    return cloud_lookup_from_numpy(
        _arrays_of(obj, CLOUD_LOOKUP_ARRAYS), {k: getattr(obj, k) for k in CLOUD_LOOKUP_META},
        **kwargs,
    )


def aerosol_lookup_from_numpy(arrays: dict, meta: dict, *, dtype=None, device=None) -> AerosolLookup:
    """AerosolLookup from its array fields (AEROSOL_LOOKUP_ARRAYS) and static
    fields (AEROSOL_LOOKUP_META)."""
    dtype = _float_dtype(arrays["dust"], dtype)
    return AerosolLookup(
        **{k: _tensor(arrays[k], dtype, device) for k in AEROSOL_LOOKUP_ARRAYS},
        **{k: int(meta[k]) for k in AEROSOL_LOOKUP_META},
    )


def aerosol_lookup_from_object(obj, **kwargs) -> AerosolLookup:
    """``aerosol_lookup_from_numpy`` of any object with AerosolLookup's
    field names (the JAX package's among them)."""
    return aerosol_lookup_from_numpy(
        _arrays_of(obj, AEROSOL_LOOKUP_ARRAYS), {k: getattr(obj, k) for k in AEROSOL_LOOKUP_META},
        **kwargs,
    )


def atmosphere_from_object(obj, **kwargs) -> AtmosphericState:
    """``atmosphere_from_numpy`` of any state object with AtmosphericState's
    field names and a global-mean vmr (``vmr_h2o``, ``vmr_o3``, ``vmr``), the
    JAX package's among them; its relative humidity, cloud and aerosol
    states come along when present."""
    cs, ae = getattr(obj, "cloud_state", None), getattr(obj, "aerosol_state", None)
    extra = {}
    if cs is not None:
        extra["cloud_state"] = {**_arrays_of(cs, CLOUD_STATE_ARRAYS), "ice_rgh": int(cs.ice_rgh)}
    if ae is not None:
        extra["aerosol_state"] = _arrays_of(ae, ("aero_size", "aero_mass"))
    return atmosphere_from_numpy(
        **_arrays_of(obj, ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "col_dry")),
        vmr_h2o=np.asarray(obj.vmr.vmr_h2o), vmr_o3=np.asarray(obj.vmr.vmr_o3),
        vmr_gm=np.asarray(obj.vmr.vmr), rel_hum=_arrays_of(obj, ("rel_hum",))["rel_hum"],
        **extra, **kwargs,
    )


def atmosphere_from_numpy(
    *, p_lay, t_lay, p_lev, t_lev, t_sfc, col_dry,
    vmr_h2o=None, vmr_o3=None, vmr_gm=None, vmr=None,
    rel_hum=None, cloud_state: dict | None = None, aerosol_state: dict | None = None,
    lon=None, lat=None, dtype: torch.dtype | None = None, device=None,
) -> AtmosphericState:
    """AtmosphericState from numpy fields (a field may also be a tensor,
    moved and cast like the arrays). Give either ``vmr_h2o``, ``vmr_o3``
    and ``vmr_gm`` (a VmrGM) or ``vmr`` (a full (ngas+1, nlay, ncol) Vmr).
    ``cloud_state`` holds CloudState's fields (``ice_rgh`` an int),
    ``aerosol_state`` AerosolState's."""
    dtype = _float_dtype(p_lay, dtype)
    t = lambda x: _tensor(x, dtype, device)
    if vmr is not None:
        vmr_c = Vmr(vmr=t(vmr))
    else:
        vmr_c = VmrGM(vmr_h2o=t(vmr_h2o), vmr_o3=t(vmr_o3), vmr=t(vmr_gm))
    cs = ae = None
    if cloud_state is not None:
        cs = CloudState(**{k: t(cloud_state[k]) for k in CLOUD_STATE_ARRAYS},
                        ice_rgh=int(cloud_state.get("ice_rgh", 2)))
    if aerosol_state is not None:
        ae = AerosolState(aero_size=t(aerosol_state["aero_size"]),
                          aero_mass=t(aerosol_state["aero_mass"]))
    return AtmosphericState(
        p_lay=t(p_lay), t_lay=t(t_lay), p_lev=t(p_lev), t_lev=t(t_lev),
        t_sfc=t(t_sfc), col_dry=t(col_dry), vmr=vmr_c, rel_hum=t(rel_hum),
        cloud_state=cs, aerosol_state=ae, lon=t(lon), lat=t(lat),
    )


def lw_bcs_from_numpy(*, sfc_emis, inc_flux=None, dtype=None, device=None) -> LwBCs:
    dtype = _float_dtype(sfc_emis, dtype)
    return LwBCs(
        sfc_emis=_tensor(sfc_emis, dtype, device),
        inc_flux=_tensor(inc_flux, dtype, device),
    )


def sw_bcs_from_numpy(
    *, cos_zenith, toa_flux, sfc_alb_direct, sfc_alb_diffuse,
    inc_flux_diffuse=None, dtype=None, device=None,
) -> SwBCs:
    dtype = _float_dtype(cos_zenith, dtype)
    t = lambda x: _tensor(x, dtype, device)
    return SwBCs(
        cos_zenith=t(cos_zenith), toa_flux=t(toa_flux),
        sfc_alb_direct=t(sfc_alb_direct), sfc_alb_diffuse=t(sfc_alb_diffuse),
        inc_flux_diffuse=t(inc_flux_diffuse),
    )
