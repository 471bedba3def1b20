"""Clear-sky kernels of the main path and their plain torch twins
(counterpart of ``rrtmgp_tpu/ops/pallas_mega.py``).

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for CUDA
tensors and raises on anything the kernel does not take; for CPU tensors it
returns its plain twin ``*_ref``. Each counts its launches in a plain integer
attribute, ``<wrapper>.launches``, incremented only where the kernel is
launched.

- ``planck_band``: band Planck emission (replaces ``planck_band_pallas_t``
  and ``planck_band_windowed``);
- ``lw_clear_mega``: whole LW no-scattering solve (replaces ``lw_clear_mega``);
- ``sw_clear_mega``: whole SW two-stream solve (replaces ``sw_clear_mega``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gas_optics import (
    compute_planck_fraction,
    compute_tau_major,
    gpt2band,
    minor_intervals,
    planck_bands,
    planck_sources_from_bands,
    sw_tau_ssa,
    tau_minor_from_scalings,
    tau_rayleigh_from_factor,
)
from .mega_inputs import KernelTables, MegaInputs
from .rte import intensity_to_flux, lw_noscat, round_to, sw_2stream

MAX_GPT = 1024  # one thread per g-point in a block


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require(t, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape/dtype on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {t.device}; the kernel runs on CUDA, "
                         "the plain version on CPU")
    return t.device


# ---------------------------------------------------------------------------
# Band Planck emission
# ---------------------------------------------------------------------------


def planck_band_ref(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Plain twin of ``planck_band``: (nbnd, N) band Planck values at the
    temperatures ``t`` (N,)."""
    return planck_bands(totplnk, t, t_min, t_delta).T.contiguous()


def planck_band(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Band Planck emission (nbnd, N) at temperatures ``t`` (N,), by linear
    interpolation of ``totplnk`` (n_t, nbnd) on the uniform grid
    (t_min, t_delta)."""
    if t.device.type == "cpu":
        return planck_band_ref(t, totplnk, t_min, t_delta)
    dev = _cuda_device(t, "planck_band")
    if t.dim() != 1 or totplnk.dim() != 2 or totplnk.shape[0] < 2:
        raise ValueError(f"planck_band: t {tuple(t.shape)}, totplnk {tuple(totplnk.shape)}")
    n = t.shape[0]
    n_t, nbnd = totplnk.shape
    _require(t, "t", (n,), torch.float32, dev)
    _require(totplnk, "totplnk", (n_t, nbnd), torch.float32, dev)
    out = torch.empty((nbnd, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_planck_band(
            _ptr(t), _ptr(totplnk), _ptr(out), n, nbnd, n_t, t_min, t_delta, _stream(dev)
        )
    _build.check(err, "planck_band")
    planck_band.launches += 1
    return out


planck_band.launches = 0


# ---------------------------------------------------------------------------
# Shared argument checks of the megakernels
# ---------------------------------------------------------------------------


def _check_inputs(inp: MegaInputs, tabs: KernelTables, dev, shortwave: bool) -> tuple:
    lkp = tabs.lkp
    nlay, ncol = inp.nlay, inp.ncol
    ngpt, nbnd = lkp.n_gpt, lkp.n_bnd
    if not 1 <= ngpt <= MAX_GPT:
        raise ValueError(f"n_gpt={ngpt}: the kernels take 1..{MAX_GPT} g-points")
    f32, i32 = torch.float32, torch.int32
    lc, lcb = (nlay, ncol), (nlay, ncol, nbnd)
    for name, shape, dtype in (
        ("jtemp", lc, i32), ("ftemp", lc, f32), ("jpress_base", lc, i32),
        ("fpress", lc, f32), ("tropo_lower", lc, torch.bool), ("col_dry", lc, f32),
        ("jeta1", lcb, i32), ("feta1", lcb, f32), ("col_mix1", lcb, f32),
        ("jeta2", lcb, i32), ("feta2", lcb, f32), ("col_mix2", lcb, f32),
        ("minor_scaling", (tabs.n_minor, nlay, ncol), f32),
    ):
        _require(getattr(inp, name), name, shape, dtype, dev)
    if shortwave:
        _require(inp.ray_factor, "ray_factor", lc, f32, dev)
    ntemp, neta = lkp.n_temp, lkp.n_eta
    npp = tabs.kmajor.shape[0]
    ncontrib = tabs.kminor.shape[-1]
    second = (2, ntemp, neta, ngpt) if shortwave else (npp, ntemp, neta, ngpt)
    for name, shape, dtype in (
        ("kmajor", (npp, ntemp, neta, ngpt), f32), ("second", second, f32),
        ("kminor", (ntemp, neta, ncontrib), f32), ("gpt2band", (ngpt,), i32),
        ("minor_start", (2, ngpt + 1), i32),
        ("minor_list", tuple(tabs.minor_list.shape), i32),
        ("minor_kbase", (tabs.n_minor,), i32), ("minor_band", (tabs.n_minor,), i32),
    ):
        _require(getattr(tabs, name), name, shape, dtype, dev)
    return nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib


def _input_ptrs(inp: MegaInputs) -> list:
    return [_ptr(getattr(inp, k)) for k in (
        "jtemp", "ftemp", "jpress_base", "fpress", "tropo_lower", "col_dry",
        "jeta1", "feta1", "col_mix1", "jeta2", "feta2", "col_mix2", "minor_scaling",
    )]


def _table_ptrs(tabs: KernelTables) -> list:
    return [_ptr(getattr(tabs, k)) for k in (
        "kmajor", "second", "kminor", "gpt2band",
        "minor_start", "minor_list", "minor_kbase", "minor_band",
    )]


def _tau_gas(inp: MegaInputs, tabs: KernelTables):
    """Major + minor optical depth (nlay, ncol, ngpt) of the plain twins."""
    lkp = tabs.lkp
    scalings = [
        (side, itv, inp.minor_scaling[i])
        for i, (side, itv) in enumerate(minor_intervals(lkp))
    ]
    tau = compute_tau_major(lkp, inp.col_dry, inp.pt, inp.eta)
    return tau.add_(tau_minor_from_scalings(lkp, scalings, inp.pt, inp.eta))


# ---------------------------------------------------------------------------
# LW no-scattering megakernel
# ---------------------------------------------------------------------------


def lw_clear_mega_ref(
    inp: MegaInputs, tabs: KernelTables, plk_lay, plk_lev, plk_sfc, sfc_emis,
    inc_flux, ds: float, w_mu: float,
):
    """Plain twin of ``lw_clear_mega``: ``ops.gas_optics`` optics and
    sources, then ``ops.rte.lw_noscat``, summed over g-points."""
    lkp = tabs.lkp
    nlay, ncol = inp.nlay, inp.ncol
    tau = _tau_gas(inp, tabs).clamp_(min=0.0)
    pfrac = compute_planck_fraction(lkp, inp.pt, inp.eta)
    band_last = lambda x, *shape: x.reshape(x.shape[0], *shape).movedim(0, -1)
    src = planck_sources_from_bands(
        lkp, band_last(plk_lay, nlay, ncol), band_last(plk_lev, nlay + 1, ncol),
        plk_sfc.T, pfrac,
    )
    del pfrac
    emis = sfc_emis.T[:, gpt2band(lkp)]
    up, dn = lw_noscat(
        tau, src.lay_source, src.lev_source, src.sfc_source, emis, ds, w_mu, inc_flux
    )
    return up.sum(-1), dn.sum(-1)


def lw_clear_mega(
    inp: MegaInputs, tabs: KernelTables,
    plk_lay: torch.Tensor,   # (nbnd, nlay*ncol) planck_band at t_lay
    plk_lev: torch.Tensor,   # (nbnd, nlev*ncol) planck_band at t_lev
    plk_sfc: torch.Tensor,   # (nbnd, ncol) planck_band at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    inc_flux: torch.Tensor | None,  # (ncol, ngpt) TOA incident flux
    ds: float, w_mu: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole clear-sky LW no-scattering solve for one angle (secant ``ds``,
    weight ``w_mu``); returns (flux_up, flux_dn), each (nlev, ncol)."""
    if inp.jtemp.device.type == "cpu":
        return lw_clear_mega_ref(inp, tabs, plk_lay, plk_lev, plk_sfc, sfc_emis, inc_flux, ds, w_mu)
    dev = _cuda_device(inp.jtemp, "lw_clear_mega")
    if not tabs.lkp.is_longwave:
        raise ValueError("lw_clear_mega: needs a longwave lookup")
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = _check_inputs(inp, tabs, dev, False)
    f32 = torch.float32
    _require(plk_lay, "plk_lay", (nbnd, nlay * ncol), f32, dev)
    _require(plk_lev, "plk_lev", (nbnd, (nlay + 1) * ncol), f32, dev)
    _require(plk_sfc, "plk_sfc", (nbnd, ncol), f32, dev)
    _require(sfc_emis, "sfc_emis", (nbnd, ncol), f32, dev)
    if inc_flux is not None:
        _require(inc_flux, "inc_flux", (ncol, ngpt), f32, dev)
    trans_s = torch.empty((nlay, ncol, ngpt), dtype=f32, device=dev)
    sup_s = torch.empty_like(trans_s)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_clear_mega(
            *_input_ptrs(inp), *_table_ptrs(tabs),
            *map(_ptr, (plk_lay, plk_lev, plk_sfc, sfc_emis, inc_flux, trans_s, sup_s, up, dn)),
            nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib,
            round_to(ds, f32), intensity_to_flux(w_mu, f32), _stream(dev),
        )
    _build.check(err, "lw_clear_mega")
    lw_clear_mega.launches += 1
    return up, dn


lw_clear_mega.launches = 0


# ---------------------------------------------------------------------------
# SW two-stream megakernel
# ---------------------------------------------------------------------------


def sw_clear_mega_ref(
    inp: MegaInputs, tabs: KernelTables, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse,
):
    """Plain twin of ``sw_clear_mega``: ``ops.gas_optics`` optics with
    Rayleigh, then ``ops.rte.sw_2stream`` (asymmetry 0), summed over
    g-points. Night columns are not zeroed."""
    lkp = tabs.lkp
    tau_ray = tau_rayleigh_from_factor(lkp, inp.ray_factor, inp.pt, inp.eta)
    optics = sw_tau_ssa(_tau_gas(inp, tabs), tau_ray)
    del tau_ray
    g2b = gpt2band(lkp)
    up, dn, dn_dir = sw_2stream(
        optics.tau, optics.ssa, 0.0, mu0[:, None], toa_gpt,
        alb_dir.T[:, g2b], alb_dif.T[:, g2b], inc_flux_diffuse,
    )
    return up.sum(-1), dn.sum(-1), dn_dir.sum(-1)


def sw_clear_mega(
    inp: MegaInputs, tabs: KernelTables,
    mu0: torch.Tensor,      # (ncol,) cosine of the solar zenith angle
    toa_gpt: torch.Tensor,  # (ncol, ngpt) TOA flux per g-point
    alb_dir: torch.Tensor,  # (nbnd, ncol)
    alb_dif: torch.Tensor,  # (nbnd, ncol)
    inc_flux_diffuse: torch.Tensor | None,  # (ncol, ngpt)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole clear-sky SW two-stream solve; returns (flux_up, flux_dn,
    flux_dn_dir), each (nlev, ncol). flux_dn includes the direct beam.
    Night columns are the caller's to zero."""
    if inp.jtemp.device.type == "cpu":
        return sw_clear_mega_ref(inp, tabs, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse)
    dev = _cuda_device(inp.jtemp, "sw_clear_mega")
    if tabs.lkp.is_longwave:
        raise ValueError("sw_clear_mega: needs a shortwave lookup")
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = _check_inputs(inp, tabs, dev, True)
    f32 = torch.float32
    _require(mu0, "mu0", (ncol,), f32, dev)
    _require(toa_gpt, "toa_gpt", (ncol, ngpt), f32, dev)
    _require(alb_dir, "alb_dir", (nbnd, ncol), f32, dev)
    _require(alb_dif, "alb_dif", (nbnd, ncol), f32, dev)
    if inc_flux_diffuse is not None:
        _require(inc_flux_diffuse, "inc_flux_diffuse", (ncol, ngpt), f32, dev)
    scratch = [torch.empty((nlay, ncol, ngpt), dtype=f32, device=dev) for _ in range(4)]
    fluxes = [torch.empty((nlay + 1, ncol), dtype=f32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_sw_clear_mega(
            *_input_ptrs(inp), _ptr(inp.ray_factor), *_table_ptrs(tabs),
            *map(_ptr, (mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse, *scratch, *fluxes)),
            nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, _stream(dev),
        )
    _build.check(err, "sw_clear_mega")
    sw_clear_mega.launches += 1
    return tuple(fluxes)


sw_clear_mega.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in (planck_band, lw_clear_mega, sw_clear_mega):
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in (planck_band, lw_clear_mega, sw_clear_mega)}
