"""RRTMGP radiation solves, clear sky and all-sky (counterpart of
``rrtmgp_tpu/models/rrtmgp.py``): LW no-scattering or two-stream, SW
two-stream or direct beam only, with McICA clouds and MERRA aerosols.

Four implementations of the same functions, chosen by ``impl``:

- ``"kernel"``: the megakernels, the hand-written CUDA kernels of
  ``ops.mega`` and ``ops.aerosol_bands`` (band Planck, then one kernel for
  the whole solve), fed by ``ops.mega_inputs``. CUDA tensors. In f32, LW
  no-scattering (K1, one launch per quadrature angle), LW two-stream (K4)
  and SW two-stream (K2) take clouds (a mask, or McICA drawn in the kernel
  from a seed) and aerosols. In f64, clear sky without aerosols: LW
  no-scattering (K1 built for native f64, 1-4 angles, with or without
  incident flux) and SW two-stream (K2 built for native f64).
- ``"two_kernel"``: the two-kernel path of the JAX package. An optics kernel
  writes tau and the Planck fraction (LW) or ssa (SW) per (layer, column,
  g-point) to memory (``ops.gas_optics_kernel``: K8, and K11 for the band
  Planck values), clouds and aerosols are composed on those tensors in plain
  torch as on the torch path (a seeded McICA mask comes from the export
  kernel K6, the aerosol band sums from K5), and a sweep kernel returns g-summed fluxes
  (``ops.rte_kernels``: K12 sweeping every angle in one launch on the same
  optics, K14, K15).
  CUDA tensors, f32. LW no-scattering with 1-4 angles, LW two-stream (the
  level sources materialized per g-point from the band Planck values and the
  Planck fraction in plain torch, then K14), SW two-stream, and SW direct
  beam only (the optics kernel, then the beam recurrence in plain torch,
  which the JAX package too computes outside any kernel).
- ``"sweep"``: the sweep kernels alone, the JAX package's ``pallas_rte=True``
  without ``pallas_tables``. Gas optics, Planck sources and the composition
  are the torch path's, in plain torch; then a sweep kernel returns g-summed
  fluxes: K13 sweeping every angle in one launch (LW no-scattering, 1-4
  angles), K14 (LW two-stream) or K15 (SW two-stream); the SW direct-beam
  solve is the torch path's. CUDA tensors, f32. Never chosen by ``impl=None``.
- ``"torch"``: plain torch, ``ops.gas_optics`` then the composition and
  ``ops.rte``; any device, f32 or f64. Every combination of the JAX
  package's XLA path.

``fused_optics=False`` is the port's counterpart of the JAX package's
``pallas_windowed="off"``: the two-kernel path with the unfused optics, the
table interpolation kernel K9 twice (kmajor with col_mix; the Planck fraction
or the Rayleigh table) and the minor-gas kernel K10 once per solve, in place
of the materialized-optics kernel K8 (``ops.interp.optics_unfused``; the same
optics bit for bit). It covers every two-kernel solve (LW no-scattering with
1-4 angles, LW two-stream, SW two-stream, the SW direct beam, clear or
all-sky); like ``"off"`` it gives up the megakernels, so ``impl=None`` takes
the two-kernel path for every f32 CUDA solve. f64 routing ignores it, as the
JAX package's f64 ignores ``pallas_windowed`` (its Pallas tier is f32 only):
an f64 solve with ``impl=None`` takes the route of the fused f64 solve, and
gives its fluxes bit for bit. ``"kernel"``, ``"sweep"`` and ``"torch"`` have
no materialized-optics kernel and raise ``ValueError`` with it; an explicit
``"two_kernel"`` in f64 raises ``NotImplementedError`` as without it.

``impl=None`` routes as the JAX package does. f32 CUDA tensors take the
megakernels for LW no-scattering with one angle, LW two-stream and SW
two-stream, and the two-kernel path for LW no-scattering with several angles
(the optics are computed once, not once per angle; it holds them in memory,
see ``solve_lw``) and for the SW direct-beam solve. f64 CUDA tensors, with
or without ``fused_optics``, take the kernel for the two f64 solves that
have one (clear sky without aerosols: LW no-scattering with 1-4 angles, SW
two-stream) and ``"torch"`` otherwise (with a warning); CPU tensors take
``"torch"``. An explicit ``impl`` that does not cover a solve raises
``NotImplementedError`` naming the ROADMAP item that will add it;
``impl=None`` never does for a solve the JAX package computes. (The kernels
run one thread per g-point; a lookup of more than 1024 g-points spreads a
column over several blocks, with the same fluxes as one block would give.)
On the kernel routes float boundary conditions of another dtype than the
state are cast to the state's dtype, as the JAX package casts them.
Fluxes are (nlay+1, ncol), level 0 = surface.

``solve_chunked`` runs a solve over column chunks in bounded memory; the
chunks' fluxes equal the unchunked ones bit for bit.

McICA: ``cld_mask_seed`` draws the mask from the JAX package's off-TPU
threefry stream keyed on (seed, ``col_offset`` + column), on both paths, so
a seeded solve equals the JAX package's CPU solve bit for bit in its mask
and is invariant to column splits.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..angular import angular_discretization
from ..data.lookups import AerosolLookup, CloudLookup, GasLookup
from ..ops import rte
from ..ops.aerosol_bands import aerosol_bands
from ..ops.aerosol_optics import aerosol_optics_bands
from ..ops.bounds import at_least
from ..ops.cloud_bands import cloud_bands
from ..ops.cloud_optics import (
    build_cloud_mask_mcica,
    cloud_cover_from_mask,
    cloud_optics_bands,
    compose_2stream,
    delta_scale,
)
from ..ops.gas_optics import gas_optics_lw, gas_optics_sw, gpt2band
from ..ops.gas_optics_kernel import gas_optics_lw as gas_optics_lw_kernel
from ..ops.gas_optics_kernel import gas_optics_lw_raw
from ..ops.gas_optics_kernel import gas_optics_sw as gas_optics_sw_kernel
from ..ops.mega import (
    F64_ALLSKY_ITEM,
    Composition,
    lw2_mega,
    lw_clear_mega,
    mcica_mask_export,
    planck_band_sets,
    sw_clear_mega,
)
from ..ops.mega_inputs import mega_lw_inputs, mega_sw_inputs
from ..ops.rte_kernels import (
    lw_2stream_reduced,
    lw_noscat_banded_angles,
    lw_noscat_reduced_angles,
    sw_2stream_reduced,
)
from ..states import AtmosphericState, LwBCs, SwBCs, slice_columns, tree_leaves, tree_unflatten
from ..utils.profiling import span


class FluxLW(NamedTuple):
    flux_up: torch.Tensor  # (nlev, ncol)
    flux_dn: torch.Tensor
    flux_net: torch.Tensor


class FluxSW(NamedTuple):
    flux_up: torch.Tensor
    flux_dn: torch.Tensor
    flux_dn_dir: torch.Tensor
    flux_net: torch.Tensor


class SolveDiagnostics(NamedTuple):
    cld_cover: torch.Tensor | None = None   # (ncol,) McICA cloud cover
    aod_sw_ext: torch.Tensor | None = None  # (ncol,) aerosol optical depth at 550 nm
    aod_sw_sca: torch.Tensor | None = None


IMPLS = ("kernel", "two_kernel", "sweep", "torch")
F64_WARNING = (
    "impl=None on float64 CUDA tensors: only the clear-sky LW no-scattering "
    "and SW two-stream solves without aerosols have an f64 CUDA kernel; this "
    "f64 solve dispatches the exact-precision torch path instead (slower, but "
    "true f64 — not an f32-faithful approximation)"
)


def _resolve_impl(impl: str | None, device: torch.device, dtype: torch.dtype,
                  has_f64_kernel: bool = False, mega: bool = True, fused_optics: bool = True) -> str:
    """``impl=None``: for f32 CUDA tensors the megakernels where they cover
    the solve (``mega``), else the two-kernel path; the kernel for an f64
    solve that has one (``has_f64_kernel``); the torch path otherwise (with
    a warning for the other f64 solves on CUDA tensors); never ``"sweep"``.
    ``"kernel"``, ``"two_kernel"`` and ``"sweep"`` need CUDA tensors;
    ``"kernel"`` raises for an f64 solve without a kernel, ``"two_kernel"``
    and ``"sweep"`` for any f64 solve. Without ``fused_optics`` only the
    two-kernel path runs in f32: ``impl=None`` takes it on f32 CUDA tensors
    (and ``"torch"`` on CPU tensors), any other ``impl`` than
    ``"two_kernel"`` raises ``ValueError``. f64 ignores ``fused_optics``
    with ``impl=None``, as the JAX package's f64 ignores
    ``pallas_windowed``: the same route as the fused solve, bit for bit."""
    f64 = dtype == torch.float64
    f64_without = f64 and not has_f64_kernel
    if not fused_optics:
        if impl not in (None, "two_kernel"):
            raise ValueError(f"fused_optics=False runs the two-kernel path; impl={impl!r} has no "
                             "materialized-optics kernel (use impl=None or 'two_kernel')")
        # impl=None takes it on f32 CUDA tensors; f64 routes below as a fused
        # solve, as the JAX package's f64 ignores pallas_windowed
        if impl is None and device.type == "cuda" and not f64:
            impl = "two_kernel"
    if impl is None:
        if device.type != "cuda":
            return "torch"
        if f64_without:
            warnings.warn(F64_WARNING, stacklevel=3)
            return "torch"
        return "kernel" if f64 or mega else "two_kernel"
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl != "torch" and device.type != "cuda":
        raise ValueError(
            f"impl={impl!r} runs the CUDA kernels and needs CUDA tensors, got {device}"
        )
    if impl == "kernel" and f64_without:
        _not_ported("an f64 CUDA kernel for this solve (f64 has one for clear-sky LW "
                    "no-scattering and SW two-stream without aerosols only)", F64_ALLSKY_ITEM)
    if impl == "two_kernel" and f64:
        _not_ported("the two-kernel path in f64 (its kernels are built for f32)", F64_ALLSKY_ITEM)
    if impl == "sweep" and f64:
        _not_ported("the sweep route in f64 (the sweep kernels are built for f32)", F64_ALLSKY_ITEM)
    return impl


def _spanned(name: str):
    """Run the decorated solve inside ``span(name)``, whatever its route."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, {item})")


def _kernel_ready(bcs, cld_mask, dtype):
    """Boundary conditions and cloud mask as the kernel wrappers take them:
    float fields in the state's ``dtype`` (the wrappers refuse another, the
    torch path promotes; the JAX package casts them likewise) and contiguous
    (the wrappers check and refuse, the torch path takes any strides). A
    tensor that already is both is returned as it is."""
    def ready(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_floating_point() and x.dtype != dtype:
            x = x.to(dtype)
        return x.contiguous()

    return tree_unflatten(bcs, [ready(x) for x in tree_leaves(bcs)]), ready(cld_mask)


def _apply_metric_scaling(flux, metric_scaling):
    """Deep-atmosphere metric scaling of every flux field."""
    if metric_scaling is None:
        return flux
    return type(flux)(*(f * metric_scaling for f in flux))


def solve_chunked(solve_fn, as_: AtmosphericState, bcs, chunk: int, *,
                  cld_mask: torch.Tensor | None = None, cld_mask_seed: int | None = None):
    """Run a solve over column chunks, one after the other, to bound memory:
    the (nlay, ncol, ngpt) spectral tensors of the torch path and the
    scratch of the kernels exist for ``chunk`` columns at a time.

    ``solve_fn(atm_chunk, bcs_chunk[, cld_mask_chunk | seed, col_offset])``
    returns a (flux namedtuple, diagnostics) pair or any nested tuple of
    tensors with a trailing column axis. ``cld_mask`` (nlay, ncol, ngpt),
    when given, is cut along with the columns. In seed mode ``solve_fn``
    receives the seed and the chunk's global column offset: forward both
    (``cld_mask_seed=seed, col_offset=off``), so that the McICA sample
    equals the unchunked one bit for bit. ``chunk`` need not divide the
    column count: the last chunk is short (every quantity is per column, so
    no padding is needed). Returns the same structure with the columns put
    together in preallocated outputs.
    """
    ncol = as_.ncol
    if chunk < 1:
        raise ValueError(f"chunk={chunk}: need at least one column per chunk")
    out = None
    for lo in range(0, ncol, chunk):
        hi = min(lo + chunk, ncol)
        atm_c, bcs_c = slice_columns(as_, lo, hi, ncol), slice_columns(bcs, lo, hi, ncol)
        if cld_mask is not None:
            part = solve_fn(atm_c, bcs_c, cld_mask[:, lo:hi].contiguous())
        elif cld_mask_seed is not None:
            part = solve_fn(atm_c, bcs_c, cld_mask_seed, lo)
        else:
            part = solve_fn(atm_c, bcs_c)
        if out is None:
            out = tree_unflatten(part, [t.new_empty((*t.shape[:-1], ncol)) for t in tree_leaves(part)])
        for whole, piece in zip(tree_leaves(out), tree_leaves(part)):
            whole[..., lo:hi] = piece
    return out


def _bands_to_gpt(lkp: GasLookup, x_bands: torch.Tensor) -> torch.Tensor:
    """Expand a per-band tensor (..., nbnd) to per-g-point (..., ngpt)."""
    return x_bands[..., gpt2band(lkp)]


def _mcica_mask(lkp, as_, lkp_cld, cld_mask, cld_mask_seed, col_offset, kernel=False):
    """The caller's mask, or the McICA mask of the seed when clouds are on:
    drawn in plain torch, or with ``kernel`` by the export kernel
    (``ops.mega.mcica_mask_export``, the same stream bit for bit; its twin
    on CPU tensors)."""
    if lkp_cld is not None and cld_mask is None and cld_mask_seed is None:
        raise ValueError("lkp_cld needs cld_mask or cld_mask_seed")
    if cld_mask is None and cld_mask_seed is not None and lkp_cld is not None:
        frac = as_.cloud_state.cld_frac
        if kernel:
            return mcica_mask_export(frac.contiguous(), int(cld_mask_seed), int(col_offset), lkp.n_gpt)[1] > 0.0
        return build_cloud_mask_mcica(frac, lkp.n_gpt, int(cld_mask_seed), int(col_offset))
    return cld_mask


def _add_cloud_all(lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, delta_scaling):
    """Cloud optics per band, expanded to g-points, added under the mask:
    absorption only for the 1-scalar path (ssa None; the absorbing part is
    formed per band and then expanded, which gives the same values as
    expanding first), else the two-stream increment."""
    bands = cloud_optics_bands(lkp_cld, as_.cloud_state)
    if ssa is None:
        tau_b, ssa_b, _ = bands
        return tau + torch.where(cld_mask, _bands_to_gpt(lkp, tau_b - ssa_b * tau_b), 0.0), None, None
    tau_c, ssa_c, g_c = (_bands_to_gpt(lkp, x) for x in bands)
    if delta_scaling:
        tau_c, ssa_c, g_c = delta_scale(tau_c, ssa_c, g_c)
    return compose_2stream(tau, ssa, g_asym, tau_c, ssa_c, g_c, cld_mask)


def _aerosol_raw(lkp_aero, as_, active_species, kernel: bool):
    """Raw band sums (tau, tau*ssa, tau*ssa*g): the aerosol_bands kernel's
    (nlay, nbnd, ncol) on the kernel path, the plain (nlay, ncol, nbnd)
    otherwise; and the (nlay, ncol) mask of layers carrying aerosol."""
    aero = as_.aerosol_state
    active = (aero.aero_mass > 0.0).any(dim=0)
    if kernel:
        return aerosol_bands(lkp_aero, aero, as_.rel_hum, active_species), active
    raw = aerosol_optics_bands(lkp_aero, aero, as_.rel_hum, active_species)
    return tuple(torch.where(active[..., None], x, 0.0) for x in raw), active


def _aod(lkp_aero, t_b, ts_b, collect_aod, band_axis):
    """Aerosol optical depth at 550 nm (extinction, scattering), or Nones."""
    if not collect_aod or lkp_aero.iband_550nm < 0:
        return None, None
    pick = lambda x: x.select(band_axis, lkp_aero.iband_550nm).sum(dim=0)
    return pick(t_b), pick(ts_b)


def _aerosol_props(t_b, ts_b, tsg_b, delta_scaling):
    """(tau, ssa, g) of the raw band sums, delta-scaled when asked."""
    eps = float(torch.finfo(t_b.dtype).eps)
    g_a = tsg_b / at_least(ts_b, eps)
    ssa_a = ts_b / at_least(t_b, eps)
    if delta_scaling:
        return delta_scale(t_b, ssa_a, g_a)
    return t_b, ssa_a, g_a


def _add_aerosol_all(lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling, collect_aod,
                     active_species=None, kernel=False):
    """Aerosol optics per band, expanded to g-points and added where a layer
    carries aerosol; returns (tau, ssa, g, aod_ext, aod_sca). With ``kernel``
    the raw band sums come from the aerosol_bands kernel (the two-kernel
    path; equal to the plain sums bit for bit), else from plain torch."""
    (t_b, ts_b, tsg_b), active = _aerosol_raw(lkp_aero, as_, active_species, kernel)
    if kernel:  # (nlay, nbnd, ncol) -> band axis last, as views
        t_b, ts_b, tsg_b = (x.transpose(1, 2) for x in (t_b, ts_b, tsg_b))
    aod_ext, aod_sca = _aod(lkp_aero, t_b, ts_b, collect_aod, band_axis=2)
    if ssa is None:
        # the absorbing part per band, then expanded: the same values as
        # expanding first
        return tau + _bands_to_gpt(lkp, t_b - ts_b), None, None, aod_ext, aod_sca
    t_a, ts_a, tsg_a = (_bands_to_gpt(lkp, x) for x in (t_b, ts_b, tsg_b))
    tau, ssa, g_asym = compose_2stream(
        tau, ssa, g_asym, *_aerosol_props(t_a, ts_a, tsg_a, delta_scaling), active[..., None]
    )
    return tau, ssa, g_asym, aod_ext, aod_sca


def _aerosol_bands_masked(lkp_aero, as_, delta_scaling, collect_aod, active_species=None):
    """Band-level aerosol (tau, ssa, g), each (nlay, nbnd, ncol), from the
    aerosol_bands kernel, with the active mask and the AOD: the megakernels'
    aerosol input. The ratios and delta scaling are pointwise in band
    values, so they commute with the band -> g-point expansion of the torch
    path."""
    raw, active = _aerosol_raw(lkp_aero, as_, active_species, kernel=True)
    aod_ext, aod_sca = _aod(lkp_aero, raw[0], raw[1], collect_aod, band_axis=1)
    props = tuple(x.contiguous() for x in _aerosol_props(*raw, delta_scaling))
    return props, active.contiguous(), aod_ext, aod_sca


def _kernel_composition(lkp, as_, lkp_cld, lkp_aero, cld_mask, cld_mask_seed, col_offset,
                        aero_species, delta_scaling, collect_aod, wave: str = "rrtmgp"):
    """The megakernels' Composition: cloud band properties from the
    cloud_bands kernel (delta-scaled for SW) with the caller's mask or, in
    seed mode, the cloud fraction and seed; aerosol band properties from the
    aerosol_bands kernel. ``wave`` (the solves pass ``"rrtmgp.lw"`` or
    ``"rrtmgp.sw"``) prefixes the spans of both parts. Returns
    (Composition, aod_ext, aod_sca)."""
    cld_bands = frac = seed = None
    if lkp_cld is not None:
        if cld_mask is None and cld_mask_seed is None:
            raise ValueError("lkp_cld needs cld_mask or cld_mask_seed")
        with span(wave + ".clouds"):
            cld_bands = cloud_bands(lkp_cld, as_.cloud_state, delta_scaling)
            if cld_mask is None:
                frac, seed = as_.cloud_state.cld_frac.contiguous(), int(cld_mask_seed)
    aero_bands = aero_mask = aod_ext = aod_sca = None
    if lkp_aero is not None:
        with span(wave + ".aerosols"):
            aero_bands, aero_mask, aod_ext, aod_sca = _aerosol_bands_masked(
                lkp_aero, as_, delta_scaling, collect_aod, aero_species
            )
    comp = Composition(
        cld_bands=cld_bands, cld_mask=cld_mask if cld_bands is not None and frac is None else None,
        cld_frac=frac, seed=seed, col_offset=int(col_offset),
        aero_bands=aero_bands, aero_mask=aero_mask,
    )
    return comp, aod_ext, aod_sca


def _cover(cover, cld_mask, dtype):
    if cover is None and cld_mask is not None:
        cover = cloud_cover_from_mask(cld_mask)
    return None if cover is None else cover.to(dtype)


@_spanned("rrtmgp.lw")
def solve_lw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: LwBCs,
    *,
    two_stream: bool = False,
    n_gauss_angles: int = 1,
    lkp_cld: CloudLookup | None = None,
    lkp_aero: AerosolLookup | None = None,
    cld_mask: torch.Tensor | None = None,   # (nlay, ncol, ngpt) bool McICA mask
    metric_scaling: torch.Tensor | None = None,
    aero_species: tuple | None = None,      # active MERRA species (None: all 15)
    cld_mask_seed: int | None = None,       # McICA from (seed, global column)
    col_offset: int = 0,                    # global index of column 0
    eta_node_mode: str = "continuous",
    impl: str | None = None,
    fused_optics: bool = True,
) -> tuple[FluxLW, SolveDiagnostics]:
    """Longwave flux solve over all g-points: no-scattering (one or more
    angles) or two-stream, clear or with clouds and aerosols.

    ``fused_optics=False`` (the JAX package's ``pallas_windowed="off"``)
    runs the two-kernel path with the unfused optics: the table
    interpolation kernel for tau and the Planck fraction and the minor-gas
    kernel in place of the materialized-optics kernel, the same optics bit
    for bit (see the module docstring). An f64 solve ignores it.

    Memory: with several angles the default ``impl`` on f32 CUDA tensors
    takes the two-kernel path, which holds tau and the Planck fraction as
    (nlay, ncol, ngpt) tensors, and the composition's temporaries of that
    size when there are clouds or aerosols; the megakernel route holds two
    scratch tensors of that size. All-sky with aerosols at 75748 x 60 x 256
    on an NVIDIA H100 80GB HBM3 the two-kernel route peaked at 26.8 GB
    against 14.6 GB (``scripts/port_measure.py angles``), and was the faster
    one from 2 angles on. ``impl="kernel"`` keeps the low-memory route (one
    megakernel launch per angle) for a solve that would not fit otherwise;
    f32 solves are not chunked by ``RRTMGPSolver``, ``solve_chunked`` bounds
    either route. LW two-stream through ``impl="two_kernel"`` holds tau,
    ssa, g, the level sources, two scratch tensors and the two-stream
    composition's temporaries: on the same card, all-sky at 75748 x 60 x 256,
    it peaked at 77.5 GB against the megakernel route's 24.7 GB (same
    script), so at that width it goes through ``solve_chunked``; the default
    ``impl`` keeps LW two-stream on the megakernel."""
    dtype = as_.p_lay.dtype
    # f64 has a kernel for clear sky, no scattering, no aerosols (sky type
    # and aerosols decide together: an aerosol-laden solve keeps its aerosols
    # on the torch path)
    has_f64_kernel = not two_stream and lkp_cld is None and lkp_aero is None
    # the megakernel bakes one angle into its sweep: like the JAX package,
    # several angles leave it for the two-kernel path, which computes the
    # optics once and sweeps every angle in one launch
    mega = two_stream or n_gauss_angles == 1
    impl = _resolve_impl(impl, as_.p_lay.device, dtype, has_f64_kernel, mega, fused_optics=fused_optics)
    if impl != "torch":
        bcs, cld_mask = _kernel_ready(bcs, cld_mask, dtype)
    Ds, wts = angular_discretization(n_gauss_angles)

    def noscat_angles(one_angle):
        """Sum one_angle(ds, w_mu, inc_flux) -> (flux_up, flux_dn, ...) over
        the quadrature angles. Gauss-Jacobi weights sum to 1, so the TOA
        incident flux splits by weight and every angle sees the same
        isotropic intensity. Returns the sums and the first angle's output."""
        first = None
        for k in range(n_gauss_angles):
            inc_k = None if bcs.inc_flux is None else bcs.inc_flux * float(wts[k])
            out = one_angle(float(Ds[k]), float(wts[k]), inc_k)
            if first is None:
                first, up, dn = out, out[0], out[1]
            else:
                up, dn = up + out[0], dn + out[1]
        return up, dn, first

    if impl == "kernel":
        tabs = lkp.kernel_tables
        with span("rrtmgp.lw.inputs"):
            inp = mega_lw_inputs(lkp, as_, eta_node_mode)

        def plk(*ts):
            # every temperature set of the solve in one launch
            with span("rrtmgp.lw.planck"):
                return planck_band_sets(
                    tuple(t.reshape(-1) for t in ts), lkp.totplnk, lkp.t_planck_min, lkp.t_planck_delta
                )

        comp, _, _ = _kernel_composition(
            lkp, as_, lkp_cld, lkp_aero, cld_mask, cld_mask_seed, col_offset, aero_species,
            delta_scaling=False, collect_aod=False, wave="rrtmgp.lw",
        )
        if two_stream:
            plk_lev, plk_sfc = plk(as_.t_lev, as_.t_sfc)
            with span("rrtmgp.lw.solve"):
                out = lw2_mega(inp, tabs, plk_lev, plk_sfc, bcs.sfc_emis, bcs.inc_flux, comp)
            flux_up, flux_dn = out[0], out[1]
        else:
            # one launch per angle; in seed mode every angle draws the same
            # mask (same seed and offset) and the cover is taken once
            plk_lay, plk_lev, plk_sfc = plk(as_.t_lay, as_.t_lev, as_.t_sfc)
            with span("rrtmgp.lw.solve"):
                flux_up, flux_dn, out = noscat_angles(lambda ds, w, inc_k: lw_clear_mega(
                    inp, tabs, plk_lay, plk_lev, plk_sfc, bcs.sfc_emis, inc_k, ds, w, comp))
        cover = out[2] if comp.seeded else None
        flux = FluxLW(flux_up, flux_dn, flux_up - flux_dn)
        diag = SolveDiagnostics(cld_cover=_cover(cover, cld_mask, dtype))
        return _apply_metric_scaling(flux, metric_scaling), diag

    two_kernel, sweep = impl == "two_kernel", impl == "sweep"
    cld_mask = _mcica_mask(lkp, as_, lkp_cld, cld_mask, cld_mask_seed, col_offset, two_kernel)
    raw = None
    if two_kernel and not two_stream:
        # the sources stay in banded form: the sweep builds them
        raw = gas_optics_lw_raw(lkp, as_, eta_node_mode=eta_node_mode, fused=fused_optics)
        tau = raw.tau
    else:
        if two_kernel:
            # the two-stream sweep reads level sources only
            optics = gas_optics_lw_kernel(lkp, as_, eta_node_mode=eta_node_mode, need_lay_source=False,
                                          fused=fused_optics)
        else:
            optics = gas_optics_lw(lkp, as_, eta_node_mode=eta_node_mode)
        src = optics.sources
        tau = optics.tau
    ssa = torch.zeros_like(tau) if two_stream else None
    g_asym = torch.zeros_like(tau) if two_stream else None
    if lkp_cld is not None:
        tau, ssa, g_asym = _add_cloud_all(lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, False)
    if lkp_aero is not None:
        tau, ssa, g_asym, _, _ = _add_aerosol_all(
            lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling=False, collect_aod=False,
            active_species=aero_species, kernel=two_kernel,
        )
    if two_kernel or sweep:
        # the sweep kernels: band-valued emissivity, expanded in the kernel
        g2b = lkp.kernel_tables.gpt2band
        if raw is not None:
            # every angle in one launch, summed in the angles' order
            flux_up, flux_dn = lw_noscat_banded_angles(
                tau, raw.pfrac, raw.plk_lay, raw.plk_lev, raw.plk_sfc, bcs.sfc_emis, g2b,
                [float(d) for d in Ds], [float(w) for w in wts], bcs.inc_flux)
        elif two_stream:
            flux_up, flux_dn = lw_2stream_reduced(
                tau, ssa, g_asym, src.lev_source, src.sfc_source, bcs.sfc_emis, g2b, bcs.inc_flux)
        else:
            # every angle in one launch, summed in the angles' order
            flux_up, flux_dn = lw_noscat_reduced_angles(
                tau, src.lay_source, src.lev_source, src.sfc_source, bcs.sfc_emis, g2b,
                [float(d) for d in Ds], [float(w) for w in wts], bcs.inc_flux)
    elif two_stream:
        sfc_emis = _bands_to_gpt(lkp, bcs.sfc_emis.T)  # (ncol, ngpt)
        up, dn = rte.lw_2stream(
            tau, ssa, g_asym, src.lev_source, src.sfc_source, sfc_emis, bcs.inc_flux
        )
        flux_up, flux_dn = up.sum(-1), dn.sum(-1)
    else:
        sfc_emis = _bands_to_gpt(lkp, bcs.sfc_emis.T)  # (ncol, ngpt)

        def one_angle(ds, w, inc_k):
            up, dn = rte.lw_noscat(
                tau, src.lay_source, src.lev_source, src.sfc_source, sfc_emis, ds, w, inc_k)
            return up.sum(-1), dn.sum(-1)

        flux_up, flux_dn, _ = noscat_angles(one_angle)
    flux = FluxLW(flux_up, flux_dn, flux_up - flux_dn)
    diag = SolveDiagnostics(cld_cover=_cover(None, cld_mask, dtype))
    return _apply_metric_scaling(flux, metric_scaling), diag


@_spanned("rrtmgp.sw")
def solve_sw(
    lkp: GasLookup,
    as_: AtmosphericState,
    bcs: SwBCs,
    *,
    two_stream: bool = True,
    lkp_cld: CloudLookup | None = None,
    lkp_aero: AerosolLookup | None = None,
    cld_mask: torch.Tensor | None = None,
    metric_scaling: torch.Tensor | None = None,
    aero_species: tuple | None = None,
    cld_mask_seed: int | None = None,
    col_offset: int = 0,
    eta_node_mode: str = "continuous",
    impl: str | None = None,
    fused_optics: bool = True,
) -> tuple[FluxSW, SolveDiagnostics]:
    """Shortwave flux solve over all g-points: two-stream or direct beam
    only, clear or with clouds and aerosols (delta-scaled). Night columns
    (cos_zenith <= 0) produce exactly zero fluxes. ``fused_optics=False``:
    the two-kernel path with the unfused optics, as in ``solve_lw``."""
    dtype = as_.p_lay.dtype
    # f64 has a kernel for the clear-sky two-stream solve without aerosols
    has_f64_kernel = two_stream and lkp_cld is None and lkp_aero is None
    # the SW megakernel is two-stream only: the direct-beam solve takes the
    # two-kernel path (the optics kernel, then the beam recurrence); under
    # "sweep" it is the torch path's, as in the JAX package
    impl = _resolve_impl(impl, as_.p_lay.device, dtype, has_f64_kernel, two_stream, fused_optics=fused_optics)
    if impl != "torch":
        bcs, cld_mask = _kernel_ready(bcs, cld_mask, dtype)
    mu0 = bcs.cos_zenith
    toa_gpt = bcs.toa_flux[:, None] * lkp.solar_src_scaled[None, :]  # (ncol, ngpt)
    aod_ext = aod_sca = cover = None

    if impl == "kernel":
        if not two_stream:
            raise ValueError("solve_sw(two_stream=False): the SW megakernel has no direct-beam route, and the "
                             "reference has none either; impl=None or 'two_kernel' run this solve (the "
                             "materialized-optics kernel, then the beam recurrence)")
        comp, aod_ext, aod_sca = _kernel_composition(
            lkp, as_, lkp_cld, lkp_aero, cld_mask, cld_mask_seed, col_offset, aero_species,
            delta_scaling=True, collect_aod=True, wave="rrtmgp.sw",
        )
        with span("rrtmgp.sw.inputs"):
            inp = mega_sw_inputs(lkp, as_, eta_node_mode)
        with span("rrtmgp.sw.solve"):
            out = sw_clear_mega(
                inp, lkp.kernel_tables, mu0, toa_gpt,
                bcs.sfc_alb_direct, bcs.sfc_alb_diffuse, bcs.inc_flux_diffuse, comp,
            )
        flux_up, flux_dn, flux_dn_dir = out[:3]
        if comp.seeded:
            cover = out[3]
    else:
        two_kernel, sweep = impl == "two_kernel", impl == "sweep"
        cld_mask = _mcica_mask(lkp, as_, lkp_cld, cld_mask, cld_mask_seed, col_offset, two_kernel)
        if two_kernel:
            optics = gas_optics_sw_kernel(lkp, as_, eta_node_mode=eta_node_mode, fused=fused_optics)
        else:
            optics = gas_optics_sw(lkp, as_, eta_node_mode=eta_node_mode)
        tau = optics.tau
        ssa = optics.ssa if two_stream else None
        # clear-sky gas optics has zero asymmetry (Rayleigh g = 0): kept as
        # None, so the sweep kernel reads one tensor less
        need_g = two_stream and (lkp_cld is not None or lkp_aero is not None)
        g_asym = torch.zeros_like(tau) if need_g else None
        if lkp_cld is not None:
            tau, ssa, g_asym = _add_cloud_all(lkp, lkp_cld, as_, tau, ssa, g_asym, cld_mask, True)
        if lkp_aero is not None:
            tau, ssa, g_asym, aod_ext, aod_sca = _add_aerosol_all(
                lkp, lkp_aero, as_, tau, ssa, g_asym, delta_scaling=True, collect_aod=True,
                active_species=aero_species, kernel=two_kernel,
            )
        if two_stream and (two_kernel or sweep):
            flux_up, flux_dn, flux_dn_dir = sw_2stream_reduced(
                tau, ssa, g_asym, mu0, toa_gpt, bcs.sfc_alb_direct, bcs.sfc_alb_diffuse,
                lkp.kernel_tables.gpt2band, bcs.inc_flux_diffuse,
            )
        elif two_stream:
            g2b = gpt2band(lkp)
            up, dn, dn_dir = rte.sw_2stream(
                tau, ssa, 0.0 if g_asym is None else g_asym, mu0[:, None], toa_gpt,
                bcs.sfc_alb_direct.T[:, g2b], bcs.sfc_alb_diffuse.T[:, g2b],
                bcs.inc_flux_diffuse,
            )
            flux_up, flux_dn, flux_dn_dir = up.sum(-1), dn.sum(-1), dn_dir.sum(-1)
        else:
            # direct beam only: up and diffuse down stay zero
            flux_dn_dir = rte.sw_noscat(tau, mu0[:, None], toa_gpt).sum(-1)
            flux_up = torch.zeros_like(flux_dn_dir)
            flux_dn = torch.zeros_like(flux_dn_dir)

    day = (mu0 > 0)[None, :]
    flux_up, flux_dn, flux_dn_dir = (
        torch.where(day, f, 0.0) for f in (flux_up, flux_dn, flux_dn_dir)
    )
    flux = FluxSW(flux_up, flux_dn, flux_dn_dir, flux_up - flux_dn)
    diag = SolveDiagnostics(
        cld_cover=_cover(cover, cld_mask, dtype), aod_sw_ext=aod_ext, aod_sw_sca=aod_sca
    )
    return _apply_metric_scaling(flux, metric_scaling), diag


# ---------------------------------------------------------------------------
# Gradients: kernel forward, plain-torch backward
# ---------------------------------------------------------------------------

#: What the torch path's backward holds at its peak per column and (layer,
#: g-point), in elements of the state's dtype, above what was allocated
#: before it: measured 32.6 (LW no-scattering), 47.8 (LW two-stream) and
#: 84.0 (SW) on clear sky, 69.7 and 96.9 (LW two-stream, SW) with aerosols,
#: at 60 layers on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py,
#: PERF.md); the largest, rounded up. Each quadrature angle of LW
#: no-scattering adds ~14.3 (1 to 4 angles: 32.8, 47.2, 61.5, 75.8, same
#: card), so up to 4 angles stay under it and the chunk ignores the angles.
GRAD_ELEMENTS_PER_POINT = 100
#: share of the card's free memory a backward chunk may fill
GRAD_MEMORY_SHARE = 0.8


def grad_chunk(lkp: GasLookup, as_: AtmosphericState) -> int:
    """Columns per chunk of the torch-path backward: the whole width on the
    CPU; on the card as many as ``GRAD_ELEMENTS_PER_POINT`` per (layer,
    g-point) element fit in ``GRAD_MEMORY_SHARE`` of its free memory, a
    power of two below the width when they do not all fit."""
    ncol, dev = as_.ncol, as_.p_lay.device
    if dev.type != "cuda":
        return ncol
    free = torch.cuda.mem_get_info(dev)[0]
    per_col = as_.nlay * lkp.n_gpt * GRAD_ELEMENTS_PER_POINT * as_.p_lay.element_size()
    fit = max(int(GRAD_MEMORY_SHARE * free // per_col), 1)
    return ncol if fit >= ncol else 1 << (fit.bit_length() - 1)


class _KernelForward(torch.autograd.Function):
    """Fluxes of ``owner``'s solve on the caller's route; their gradient
    from the torch path at the same primals, over column chunks."""

    @staticmethod
    def forward(ctx, owner, tree, *leaves):
        ctx.owner, ctx.tree = owner, tree
        ctx.save_for_backward(*leaves)
        as_, bcs = tree_unflatten(tree, leaves)
        return tuple(owner.solve(owner.lkp, as_, bcs, **owner.kwargs)[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        owner, leaves = ctx.owner, ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        grads = [None] * len(leaves)
        with torch.enable_grad():
            prim = [x.detach().requires_grad_(i in want) for i, x in enumerate(leaves)]
            as_, bcs = tree_unflatten(ctx.tree, prim)
            ncol = as_.ncol
            chunk = grad_chunk(owner.lkp, as_)
            scaling = owner.plain_kwargs.get("metric_scaling")
            for lo in range(0, ncol, chunk):
                hi = min(lo + chunk, ncol)
                # the slices are part of the graph: a column tensor's
                # gradient lands in its columns, a tensor without a column
                # axis (VmrGM.vmr) sums over the chunks
                atm_c, bcs_c = slice_columns(as_, lo, hi, ncol), slice_columns(bcs, lo, hi, ncol)
                kw = dict(owner.plain_kwargs)
                if scaling is not None:
                    # cut like a state tensor: only a trailing column axis
                    kw["metric_scaling"] = slice_columns(scaling, lo, hi, ncol)
                flux = owner.solve(owner.lkp, atm_c, bcs_c, impl="torch", **kw)[0]
                part = torch.autograd.grad(
                    tuple(flux), [prim[i] for i in want], [ct[..., lo:hi] for ct in cts],
                    allow_unused=True,
                )
                for i, g in zip(want, part):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
        # a tensor the solve does not read (p_lev) gets zeros, as in JAX
        for i in want:
            if grads[i] is None:
                grads[i] = torch.zeros_like(leaves[i])
        return (None, None, *grads)


class DifferentiableSolve:
    """``f(as_, bcs) -> FluxLW / FluxSW`` whose forward runs the solve on the
    route ``kwargs`` select and whose backward differentiates the torch path
    at the same primals (see ``differentiable_solve_lw``)."""

    def __init__(self, solve, flux_type, lkp: GasLookup, kwargs: dict):
        if "cld_mask" in kwargs or "cld_mask_seed" in kwargs:
            raise ValueError(
                "cld_mask / cld_mask_seed: McICA cloud solves are not differentiable through "
                "the kernel route; differentiate solve_lw / solve_sw(impl='torch') with an "
                "explicit cld_mask")
        self.solve, self.flux_type, self.lkp = solve, flux_type, lkp
        self.kwargs = kwargs
        # the torch path's arguments: the route's own are dropped, as the
        # JAX package drops its pallas_* kwargs
        self.plain_kwargs = {k: v for k, v in kwargs.items() if k not in ("impl", "fused_optics")}

    def __call__(self, as_: AtmosphericState, bcs):
        tree = (as_, bcs)
        return self.flux_type(*_KernelForward.apply(self, tree, *tree_leaves(tree)))


def differentiable_solve_lw(lkp: GasLookup, **kwargs) -> DifferentiableSolve:
    """``f(as_, bcs) -> FluxLW`` that autograd differentiates: the forward is
    ``solve_lw(lkp, as_, bcs, **kwargs)`` on the route ``impl`` and
    ``fused_optics`` select (on f32 CUDA tensors with ``impl=None`` the
    kernels), the backward ``torch.autograd.grad`` through
    ``solve_lw(impl="torch")`` at the same primals with every other kwarg.
    The kernels have no adjoints; the two routes agree to f32 rounding, so
    the gradient is the torch path's exactly and the kernel forward's to f32
    accuracy.

    Gradients reach every floating tensor of ``as_`` and ``bcs`` that
    requires grad, never a lookup. The backward runs over column chunks
    of ``grad_chunk`` columns (the whole width on the CPU, what fits the
    card's free memory on CUDA tensors): a column tensor's gradient
    is written into its columns, a tensor without a column axis (the
    ``VmrGM.vmr`` global means) gets the sum over the chunks.

    McICA is refused: ``cld_mask`` or ``cld_mask_seed`` in ``kwargs`` raise
    ``ValueError`` (the JAX package asserts, which ``python -O`` strips);
    differentiate ``solve_lw(impl="torch")`` with an explicit ``cld_mask``
    for cloudy gradients."""
    return DifferentiableSolve(solve_lw, FluxLW, lkp, kwargs)


def differentiable_solve_sw(lkp: GasLookup, **kwargs) -> DifferentiableSolve:
    """``f(as_, bcs) -> FluxSW``: kernel-route forward, torch-path backward
    (see ``differentiable_solve_lw``)."""
    return DifferentiableSolve(solve_sw, FluxSW, lkp, kwargs)
