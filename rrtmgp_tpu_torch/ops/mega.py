"""Kernels of the main paths and their plain torch twins (counterpart of
``rrtmgp_tpu/ops/pallas_mega.py``).

Each wrapper launches its hand-written CUDA kernel (``csrc/*.cu``) for CUDA
tensors and raises on anything the kernel does not take; for CPU tensors it
returns its plain twin ``*_ref``. Each counts its launches in a plain integer
attribute, ``<wrapper>.launches``, incremented only where the kernel is
launched. Past the most threads a block of the kernel may have (1024, or
fewer where its registers do not fit them: ``_launch.max_threads``) a
column spans several blocks (``_launch.gpoint_plan``), and so do its level
sums where they would not fit a block's shared memory (very deep columns):
a call of a kernel with level
sums is then two launches, the kernel and ``finish_level_sums``
(``csrc/common.cuh``), which adds the warps' partials in the in-block
order; the count takes one for the call.

- ``planck_band``: band Planck emission, f32 or f64 (replaces
  ``planck_band_pallas_t`` and ``planck_band_windowed``);
  ``planck_band_sets`` the same for up to three temperature sets in one
  launch, as a solve calls it;
- ``lw_clear_mega``: whole LW no-scattering solve for one angle: f32 clear
  or all-sky (replaces ``lw_clear_mega``), f64 clear sky (replaces the
  double-f32 ``lw_noscat_mega_df`` / ``solve_lw_df64`` of
  ``rrtmgp_tpu/ops/pallas_mega_df.py`` by the same kernel built for native
  f64);
- ``lw2_mega``: whole LW two-stream solve, clear or all-sky (replaces
  ``lw2_mega``);
- ``sw_clear_mega``: whole SW two-stream solve: f32 clear or all-sky
  (replaces ``sw_clear_mega``), f64 clear sky (the same kernel built for
  native f64; the JAX package leaves the f64 SW solve to XLA);
- ``mcica_mask_export``: the McICA uniforms and mask the all-sky kernels
  draw in seed mode (replaces ``mcica_mask_export``).

The composition's own kernels live beside their plain versions:
``ops.aerosol_bands`` (the MERRA band sums) and ``ops.cloud_bands`` (the
cloud band optics, new code: the JAX package has them in XLA).

The all-sky inputs of the megakernels travel in a ``Composition``. Its McICA
seed mode draws the JAX package's off-TPU threefry stream
(``ops.cloud_optics``), so kernel and twin use the same mask.

The twins take their gas optics from ``ops.interp.optics_fused_ref``, the
twin of the materialized-optics kernel, so the megakernels and the
two-kernel path have one plain definition of the gas optics.
``KERNEL_WRAPPERS`` lists every kernel wrapper of the port, those of
``ops.interp`` and ``ops.rte_kernels`` included, for ``launch_counts`` and
``reset_launch_counts``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ._launch import check_optics_inputs as _check_inputs
from ._launch import LAST_PLANS, cover_counts, in_block_bytes, kernel_plan, level_partials
from ._launch import cuda_device as _cuda_device
from ._launch import kernel_dtype as _kernel_dtype
from ._launch import optics_input_ptrs as _input_ptrs
from ._launch import ptr as _ptr
from ._launch import require as _require
from ._launch import stream as _stream
from ._launch import table_ptrs as _table_ptrs
from .aerosol_bands import aerosol_bands
from .cloud_bands import cloud_bands
from .cloud_optics import cloud_cover_from_mask, compose_2stream, mcica_sample
from .gas_optics import gpt2band, planck_bands, planck_sources_from_bands
from .interp import (
    interp_minor,
    interp_pt_eta,
    on_cpu,
    optics_fused,
    optics_fused_ref,
    planck_band_rows,
    planck_sets_launch,
    temperature_sets,
)
from .mega_inputs import KernelTables, MegaInputs
from .rte import intensity_to_flux, lw_2stream, lw_noscat, round_to, sw_2stream
from .rte_kernels import (
    lw_2stream_reduced,
    lw_noscat_banded_reduced,
    lw_noscat_gpt,
    lw_noscat_reduced,
    sw_2stream_gpt,
    sw_2stream_reduced,
)
from .threefry import seed_key

# ---------------------------------------------------------------------------
# Band Planck emission
# ---------------------------------------------------------------------------


def planck_band_ref(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """Plain twin of ``planck_band``: (nbnd, N) band Planck values at the
    temperatures ``t`` (N,)."""
    return planck_bands(totplnk, t, t_min, t_delta).T.contiguous()


def planck_band_sets(ts, totplnk: torch.Tensor, t_min: float, t_delta: float) -> tuple:
    """Band Planck emission (nbnd, N_k) at each temperature set ``ts[k]``
    (N_k,), 1 to 3 sets, f32 or f64, in one launch: linear interpolation of
    ``totplnk`` (n_t, nbnd) on the uniform grid (t_min, t_delta). Counts on
    ``planck_band.launches``."""
    ts = temperature_sets("planck_band", ts)
    if on_cpu(ts):
        return tuple(planck_band_ref(t, totplnk, t_min, t_delta) for t in ts)
    outs = planck_sets_launch("planck_band", ts, totplnk, t_min, t_delta, rows=False)
    planck_band.launches += 1
    return outs


def planck_band(t: torch.Tensor, totplnk: torch.Tensor, t_min: float, t_delta: float):
    """``planck_band_sets`` of the one set ``t``."""
    return planck_band_sets((t,), totplnk, t_min, t_delta)[0]


planck_band.launches = 0


# ---------------------------------------------------------------------------
# All-sky composition of the megakernels
# ---------------------------------------------------------------------------


class Composition(NamedTuple):
    """What the megakernels add to the gas optics. Clouds come with either a
    mask or, for McICA in the kernel, the cloud fraction and a seed; aerosols
    with their per-layer active mask. ``lw_clear_mega`` (no scattering) adds
    the absorbing part tau - ssa * tau of each and does not read g."""

    cld_bands: tuple | None = None     # (tau, ssa, g), each (nlay, ncol, nbnd)
    cld_mask: torch.Tensor | None = None  # (nlay, ncol, ngpt) bool
    cld_frac: torch.Tensor | None = None  # (nlay, ncol): McICA mask from the seed
    seed: int | None = None
    col_offset: int = 0                # global index of column 0 (seed mode)
    aero_bands: tuple | None = None    # (tau, ssa, g), each (nlay, nbnd, ncol)
    aero_mask: torch.Tensor | None = None  # (nlay, ncol) bool

    @property
    def seeded(self) -> bool:
        return self.cld_bands is not None and self.cld_mask is None

    @property
    def clear(self) -> bool:
        return self.cld_bands is None and self.aero_bands is None


CLEAR = Composition()
MASK_NONE, MASK_GIVEN, MASK_SEED = 0, 1, 2
#: shared memory of the McICA cover count of a block (csrc/mcica.cuh
#: block_count, one int per warp), beside the level sums in seed mode
BLOCK_COUNT_BYTES = 32 * 4
#: ROADMAP queue 1 item that adds f64 builds of the all-sky kernels
F64_ALLSKY_ITEM = "item 20"


def _f64_clear_only(name: str, comp: Composition) -> None:
    """Raise for an f64 call of a megakernel with a composition: its f64
    build is clear sky only."""
    if not comp.clear:
        raise NotImplementedError(
            f"{name}: the f64 kernel is clear sky only; cloud/aerosol composition in f64 "
            f"is not ported yet (ROADMAP queue 1, {F64_ALLSKY_ITEM})"
        )


def _cloud_mask_ref(comp: Composition, lkp):
    """The cloud mask of a composition with clouds: the caller's, or the
    McICA mask of the seed with its cloud cover. Returns (mask, cover or
    None)."""
    if not comp.seeded:
        return comp.cld_mask, None
    mask = mcica_sample(comp.cld_frac, lkp.n_gpt, comp.seed, comp.col_offset)[1]
    return mask, cloud_cover_from_mask(mask)


def _compose_ref(comp: Composition, lkp, tau, ssa, g):
    """Twin side of the two-stream composition: the McICA mask (drawn from
    the seed in seed mode) and the cloud / aerosol increments at g-point
    resolution. Returns (tau, ssa, g, cloud cover or None)."""
    g2b = gpt2band(lkp)
    cover = None
    if comp.cld_bands is not None:
        mask, cover = _cloud_mask_ref(comp, lkp)
        tau, ssa, g = compose_2stream(tau, ssa, g, *(x[..., g2b] for x in comp.cld_bands), mask)
    if comp.aero_bands is not None:
        bands = (x.transpose(1, 2)[..., g2b] for x in comp.aero_bands)
        tau, ssa, g = compose_2stream(tau, ssa, g, *bands, comp.aero_mask[..., None])
    return tau, ssa, g, cover


def _compose_absorption_ref(comp: Composition, lkp, tau):
    """Twin side of the no-scattering composition: tau grows by
    tau_x - ssa_x * tau_x of the clouds under their mask and of the aerosols
    where a layer carries them. Returns (tau, cloud cover or None)."""
    g2b = gpt2band(lkp)
    cover = None
    if comp.cld_bands is not None:
        mask, cover = _cloud_mask_ref(comp, lkp)
        t, s = (x[..., g2b] for x in comp.cld_bands[:2])
        tau = tau + torch.where(mask, t - s * t, 0.0)
    if comp.aero_bands is not None:
        t, s = (x.transpose(1, 2)[..., g2b] for x in comp.aero_bands[:2])
        tau = tau + torch.where(comp.aero_mask[..., None], t - s * t, 0.0)
    return tau, cover


def _composition_args(comp: Composition, dev, nlay, ncol, ngpt, nbnd) -> tuple[list, list]:
    """Check a Composition against the kernel's shapes; returns the pointer
    arguments (ctau, cssa, cg, cmask, cld_frac, atau, assa, ag, amask) and
    the trailing scalars (cloud, aero, mask_mode, seed_hi, seed_lo,
    col_offset)."""
    f32 = torch.float32
    cloud, aero = comp.cld_bands is not None, comp.aero_bands is not None
    mode = MASK_NONE
    cb = [None] * 3
    if cloud:
        cb = list(comp.cld_bands)
        for name, x in zip(("cld_tau", "cld_ssa", "cld_g"), cb):
            _require(x, name, (nlay, ncol, nbnd), f32, dev)
        if (comp.cld_mask is None) == (comp.cld_frac is None):
            raise ValueError("clouds need exactly one of cld_mask and cld_frac (with seed)")
        if comp.cld_mask is not None:
            _require(comp.cld_mask, "cld_mask", (nlay, ncol, ngpt), torch.bool, dev)
            mode = MASK_GIVEN
        else:
            _require(comp.cld_frac, "cld_frac", (nlay, ncol), f32, dev)
            if comp.seed is None:
                raise ValueError("cld_frac needs a McICA seed")
            mode = MASK_SEED
    elif comp.cld_mask is not None or comp.cld_frac is not None:
        raise ValueError("a cloud mask or cloud fraction needs cld_bands")
    ab = [None] * 3
    if aero:
        ab = list(comp.aero_bands)
        for name, x in zip(("aero_tau", "aero_ssa", "aero_g"), ab):
            _require(x, name, (nlay, nbnd, ncol), f32, dev)
        _require(comp.aero_mask, "aero_mask", (nlay, ncol), torch.bool, dev)
    hi, lo = seed_key(comp.seed) if mode == MASK_SEED else (0, 0)
    ptrs = [*cb, comp.cld_mask if mode == MASK_GIVEN else None,
            comp.cld_frac if mode == MASK_SEED else None, *ab, comp.aero_mask if aero else None]
    return list(map(_ptr, ptrs)), [int(cloud), int(aero), mode, hi, lo, int(comp.col_offset)]


def _variant(composition) -> int:
    """The megakernels' template instance of (cloud, aero, mask_mode), as
    their block limits (``_launch.max_threads``) take it."""
    cloud, aero, mode = composition[:3]
    return cloud | aero << 1 | mode << 2


# ---------------------------------------------------------------------------
# LW no-scattering megakernel
# ---------------------------------------------------------------------------


def lw_clear_mega_ref(
    inp: MegaInputs, tabs: KernelTables, plk_lay, plk_lev, plk_sfc, sfc_emis,
    inc_flux, ds: float, w_mu: float, comp: Composition = CLEAR,
):
    """Plain twin of ``lw_clear_mega``: ``ops.interp.optics_fused_ref``
    optics, the Planck sources, the absorption-only composition at g-point
    resolution, then ``ops.rte.lw_noscat``, summed over g-points. Any float
    dtype."""
    lkp = tabs.lkp
    nlay, ncol = inp.nlay, inp.ncol
    tau, pfrac = optics_fused_ref(inp, tabs)
    band_last = lambda x, *shape: x.reshape(x.shape[0], *shape).movedim(0, -1)
    src = planck_sources_from_bands(
        gpt2band(lkp), band_last(plk_lay, nlay, ncol), band_last(plk_lev, nlay + 1, ncol),
        plk_sfc.T, pfrac,
    )
    del pfrac
    tau, cover = _compose_absorption_ref(comp, lkp, tau)
    emis = sfc_emis.T[:, gpt2band(lkp)]
    up, dn = lw_noscat(
        tau, src.lay_source, src.lev_source, src.sfc_source, emis, ds, w_mu, inc_flux
    )
    out = (up.sum(-1), dn.sum(-1))
    return out + (cover,) if comp.seeded else out


def lw_clear_mega(
    inp: MegaInputs, tabs: KernelTables,
    plk_lay: torch.Tensor,   # (nbnd, nlay*ncol) planck_band at t_lay
    plk_lev: torch.Tensor,   # (nbnd, nlev*ncol) planck_band at t_lev
    plk_sfc: torch.Tensor,   # (nbnd, ncol) planck_band at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    inc_flux: torch.Tensor | None,  # (ncol, ngpt) TOA incident flux
    ds: float, w_mu: float,
    comp: Composition = CLEAR,
):
    """Whole LW no-scattering solve for one angle (secant ``ds``, weight
    ``w_mu``), clear or composed with ``comp`` (absorption only: the optical
    depth grows by tau_x - ssa_x * tau_x of clouds under their mask and of
    aerosols in the layers that carry them). Returns (flux_up, flux_dn), each
    (nlev, ncol), plus the McICA cloud cover (ncol,) in seed mode. f32 or
    f64 by the inputs' dtype; the f64 kernel is clear sky only."""
    if inp.jtemp.device.type == "cpu":
        return lw_clear_mega_ref(inp, tabs, plk_lay, plk_lev, plk_sfc, sfc_emis, inc_flux, ds, w_mu, comp)
    dev = _cuda_device(inp.jtemp, "lw_clear_mega")
    if not tabs.lkp.is_longwave:
        raise ValueError("lw_clear_mega: needs a longwave lookup")
    real = _kernel_dtype(inp.ftemp, "lw_clear_mega")
    f64 = real == torch.float64
    if f64:
        _f64_clear_only("lw_clear_mega", comp)
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = _check_inputs(inp, tabs, dev, False, real)
    _require(plk_lay, "plk_lay", (nbnd, nlay * ncol), real, dev)
    _require(plk_lev, "plk_lev", (nbnd, (nlay + 1) * ncol), real, dev)
    _require(plk_sfc, "plk_sfc", (nbnd, ncol), real, dev)
    _require(sfc_emis, "sfc_emis", (nbnd, ncol), real, dev)
    if inc_flux is not None:
        _require(inc_flux, "inc_flux", (ncol, ngpt), real, dev)
    comp_ptrs, comp_scalars = _composition_args(comp, dev, nlay, ncol, ngpt, nbnd)
    seeded = comp_scalars[2] == MASK_SEED
    plan, _ = _lw_clear_mega_plan(tabs, nlay, real, comp_scalars[:3], dev)
    trans_s = torch.empty((nlay, ncol, ngpt), dtype=real, device=dev)
    sup_s = torch.empty_like(trans_s)
    up = torch.empty((nlay + 1, ncol), dtype=real, device=dev)
    dn = torch.empty_like(up)
    cover = torch.empty((ncol,), dtype=torch.float32, device=dev) if seeded else None
    partials = level_partials(plan, 2, nlay + 1, ncol, real, dev)
    head = (*_input_ptrs(inp), *_table_ptrs(tabs),
            *map(_ptr, (plk_lay, plk_lev, plk_sfc, sfc_emis, inc_flux)))
    dims = (nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, tabs.n_minor)
    scalars = (*plan, round_to(ds, real), intensity_to_flux(w_mu, real), _stream(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        if f64:
            err = lib.rrtmgp_lw_clear_mega_f64(
                *head, *map(_ptr, (trans_s, sup_s, up, dn, partials)), *dims, *scalars)
        else:
            err = lib.rrtmgp_lw_clear_mega(
                *head, *comp_ptrs,
                *map(_ptr, (trans_s, sup_s, up, dn, cover, partials, cover_counts(plan, ncol, seeded, dev))),
                *dims, *comp_scalars, *scalars)
    _build.check(err, "lw_clear_mega", up, dn)
    lw_clear_mega.launches += 1
    return (up, dn, cover) if seeded else (up, dn)


lw_clear_mega.launches = 0

#: layers of one chunk that lw_clear_mega stages in shared memory
#: (csrc/lw_clear_mega.cu LW_CHUNK)
LW_CHUNK = 8


def _lw_clear_mega_plan(tabs: KernelTables, nlay: int, real: torch.dtype, composition: list, dev):
    """lw_clear_mega's launch plan and the shared memory it stages besides
    its level sums (chunks of layers: it does not grow with nlay);
    ``composition`` is (cloud, aero, mask_mode)."""
    f64 = int(real == torch.float64)
    staged = _build.library().rrtmgp_lw_clear_mega_staged(tabs.lkp.n_bnd, tabs.n_minor, *composition, f64)
    plan = kernel_plan("lw_clear_mega", dev, tabs.lkp.n_gpt, nlay, 2, real.itemsize, staged,
                       _variant(composition) | f64 << 4)
    return plan, staged


def lw_clear_mega_design(inp: MegaInputs, tabs: KernelTables, comp: Composition = CLEAR) -> dict:
    """How ``lw_clear_mega`` launches for these inputs (on the card): one
    block of ``group`` threads per column (``n_groups`` past the block limit
    ``max_threads``), the staging chunk, the dynamic shared memory and where
    the level sums are added."""
    dev = inp.jtemp.device
    real = inp.ftemp.dtype
    scalars = _composition_args(comp, dev, inp.nlay, inp.ncol, tabs.lkp.n_gpt, tabs.lkp.n_bnd)[1]
    plan, staged = _lw_clear_mega_plan(tabs, inp.nlay, real, scalars[:3], dev)
    sums = in_block_bytes(plan.group, inp.nlay, 2, real.itemsize) if plan.in_block else 0
    return dict(group=plan.group, n_groups=plan.n_groups, chunk=LW_CHUNK, smem=staged + sums,
                in_block=plan.in_block, max_threads=LAST_PLANS["lw_clear_mega"][1])


def _mega_scratch_tensors(plan, nf, nlay, ncol, ngpt, seeded, dev, real=torch.float32):
    """The four state arrays and the level partials of a megakernel call in
    ``real``, and its cover counts (the last two None unless a column spans
    blocks)."""
    state = [torch.empty((nlay, ncol, ngpt), dtype=real, device=dev) for _ in range(4)]
    return (*state, level_partials(plan, nf, nlay + 1, ncol, real, dev), cover_counts(plan, ncol, seeded, dev))


# ---------------------------------------------------------------------------
# LW two-stream megakernel
# ---------------------------------------------------------------------------


def lw2_mega_ref(
    inp: MegaInputs, tabs: KernelTables, plk_lev, plk_sfc, sfc_emis, inc_flux,
    comp: Composition = CLEAR,
):
    """Plain twin of ``lw2_mega``: ``ops.interp.optics_fused_ref`` optics, the
    level sources, the composition at g-point resolution, then
    ``ops.rte.lw_2stream``, summed over g-points."""
    lkp = tabs.lkp
    nlay, ncol = inp.nlay, inp.ncol
    tau, pfrac = optics_fused_ref(inp, tabs)
    src = planck_sources_from_bands(
        gpt2band(lkp), None, plk_lev.reshape(lkp.n_bnd, nlay + 1, ncol).movedim(0, -1), plk_sfc.T, pfrac
    )
    del pfrac
    tau, ssa, g, cover = _compose_ref(comp, lkp, tau, torch.zeros_like(tau), torch.zeros_like(tau))
    emis = sfc_emis.T[:, gpt2band(lkp)]
    up, dn = lw_2stream(tau, ssa, g, src.lev_source, src.sfc_source, emis, inc_flux)
    out = (up.sum(-1), dn.sum(-1))
    return out + (cover,) if comp.seeded else out


def lw2_mega(
    inp: MegaInputs, tabs: KernelTables,
    plk_lev: torch.Tensor,   # (nbnd, nlev*ncol) planck_band at t_lev
    plk_sfc: torch.Tensor,   # (nbnd, ncol) planck_band at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    inc_flux: torch.Tensor | None,  # (ncol, ngpt) TOA incident flux
    comp: Composition = CLEAR,
):
    """Whole LW two-stream solve, clear or composed with ``comp``; returns
    (flux_up, flux_dn), each (nlev, ncol), plus the McICA cloud cover (ncol,)
    in seed mode."""
    if inp.jtemp.device.type == "cpu":
        return lw2_mega_ref(inp, tabs, plk_lev, plk_sfc, sfc_emis, inc_flux, comp)
    dev = _cuda_device(inp.jtemp, "lw2_mega")
    if not tabs.lkp.is_longwave:
        raise ValueError("lw2_mega: needs a longwave lookup")
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = _check_inputs(inp, tabs, dev, False)
    f32 = torch.float32
    _require(plk_lev, "plk_lev", (nbnd, (nlay + 1) * ncol), f32, dev)
    _require(plk_sfc, "plk_sfc", (nbnd, ncol), f32, dev)
    _require(sfc_emis, "sfc_emis", (nbnd, ncol), f32, dev)
    if inc_flux is not None:
        _require(inc_flux, "inc_flux", (ncol, ngpt), f32, dev)
    comp_ptrs, comp_scalars = _composition_args(comp, dev, nlay, ncol, ngpt, nbnd)
    seeded = comp_scalars[2] == MASK_SEED
    plan = kernel_plan("lw2_mega", dev, ngpt, nlay, 2, 4, BLOCK_COUNT_BYTES, _variant(comp_scalars))
    mask_s = torch.empty((nlay, ncol, ngpt), dtype=torch.uint8, device=dev) if seeded else None
    scratch = _mega_scratch_tensors(plan, 2, nlay, ncol, ngpt, seeded, dev)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    cover = torch.empty((ncol,), dtype=f32, device=dev) if seeded else None
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw2_mega(
            *_input_ptrs(inp), *_table_ptrs(tabs),
            *map(_ptr, (plk_lev, plk_sfc, sfc_emis, inc_flux)), *comp_ptrs,
            *map(_ptr, (mask_s, *scratch, up, dn, cover)),
            nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, *comp_scalars, *plan, _stream(dev),
        )
    _build.check(err, "lw2_mega", up, dn)
    lw2_mega.launches += 1
    return (up, dn, cover) if seeded else (up, dn)


lw2_mega.launches = 0


def lw2_mega_design(inp: MegaInputs, tabs: KernelTables, comp: Composition = CLEAR) -> dict:
    """How ``lw2_mega`` launches for these inputs (on the card): ``n_groups``
    blocks of ``group`` threads per column, the block limit ``max_threads``
    of the instance, and whether the level sums stay in the block."""
    scalars = _composition_args(comp, inp.jtemp.device, inp.nlay, inp.ncol, tabs.lkp.n_gpt, tabs.lkp.n_bnd)[1]
    plan = kernel_plan("lw2_mega", inp.jtemp.device, tabs.lkp.n_gpt, inp.nlay, 2, 4, BLOCK_COUNT_BYTES,
                       _variant(scalars))
    return dict(group=plan.group, n_groups=plan.n_groups, in_block=plan.in_block,
                max_threads=LAST_PLANS["lw2_mega"][1])


# ---------------------------------------------------------------------------
# SW two-stream megakernel
# ---------------------------------------------------------------------------


def sw_clear_mega_ref(
    inp: MegaInputs, tabs: KernelTables, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse,
    comp: Composition = CLEAR,
):
    """Plain twin of ``sw_clear_mega``: ``ops.interp.optics_fused_ref`` optics
    with Rayleigh, the composition at g-point resolution (asymmetry 0 for clear
    sky), then ``ops.rte.sw_2stream``, summed over g-points. Night columns
    are not zeroed."""
    lkp = tabs.lkp
    tau, ssa = optics_fused_ref(inp, tabs)
    g, cover = 0.0, None
    if comp.cld_bands is not None or comp.aero_bands is not None:
        tau, ssa, g, cover = _compose_ref(comp, lkp, tau, ssa, torch.zeros_like(tau))
    g2b = gpt2band(lkp)
    up, dn, dn_dir = sw_2stream(
        tau, ssa, g, mu0[:, None], toa_gpt,
        alb_dir.T[:, g2b], alb_dif.T[:, g2b], inc_flux_diffuse,
    )
    out = (up.sum(-1), dn.sum(-1), dn_dir.sum(-1))
    return out + (cover,) if comp.seeded else out


def sw_clear_mega(
    inp: MegaInputs, tabs: KernelTables,
    mu0: torch.Tensor,      # (ncol,) cosine of the solar zenith angle
    toa_gpt: torch.Tensor,  # (ncol, ngpt) TOA flux per g-point
    alb_dir: torch.Tensor,  # (nbnd, ncol)
    alb_dif: torch.Tensor,  # (nbnd, ncol)
    inc_flux_diffuse: torch.Tensor | None,  # (ncol, ngpt)
    comp: Composition = CLEAR,
):
    """Whole SW two-stream solve, clear or composed with ``comp`` (cloud and
    aerosol band properties already delta-scaled); returns (flux_up,
    flux_dn, flux_dn_dir), each (nlev, ncol), plus the McICA cloud cover
    (ncol,) in seed mode. flux_dn includes the direct beam. Night columns
    are the caller's to zero. f32 or f64 by the inputs' dtype; the f64
    kernel is clear sky only."""
    if inp.jtemp.device.type == "cpu":
        return sw_clear_mega_ref(inp, tabs, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse, comp)
    dev = _cuda_device(inp.jtemp, "sw_clear_mega")
    if tabs.lkp.is_longwave:
        raise ValueError("sw_clear_mega: needs a shortwave lookup")
    real = _kernel_dtype(inp.ftemp, "sw_clear_mega")
    f64 = real == torch.float64
    if f64:
        _f64_clear_only("sw_clear_mega", comp)
    nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib = _check_inputs(inp, tabs, dev, True, real)
    _require(mu0, "mu0", (ncol,), real, dev)
    _require(toa_gpt, "toa_gpt", (ncol, ngpt), real, dev)
    _require(alb_dir, "alb_dir", (nbnd, ncol), real, dev)
    _require(alb_dif, "alb_dif", (nbnd, ncol), real, dev)
    if inc_flux_diffuse is not None:
        _require(inc_flux_diffuse, "inc_flux_diffuse", (ncol, ngpt), real, dev)
    comp_ptrs, comp_scalars = _composition_args(comp, dev, nlay, ncol, ngpt, nbnd)
    seeded = comp_scalars[2] == MASK_SEED
    plan, _ = _sw_clear_mega_plan(tabs, nlay, real, comp_scalars[:3], dev)
    scratch = _mega_scratch_tensors(plan, 3, nlay, ncol, ngpt, seeded, dev, real)
    fluxes = [torch.empty((nlay + 1, ncol), dtype=real, device=dev) for _ in range(3)]
    cover = torch.empty((ncol,), dtype=torch.float32, device=dev) if seeded else None
    head = (*_input_ptrs(inp), _ptr(inp.ray_factor), *_table_ptrs(tabs),
            *map(_ptr, (mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse)))
    dims = (nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib, tabs.n_minor)
    lib = _build.library()
    with torch.cuda.device(dev):
        if f64:
            err = lib.rrtmgp_sw_clear_mega_f64(*head, *map(_ptr, (*scratch[:5], *fluxes)), *dims, *plan,
                                               _stream(dev))
        else:
            err = lib.rrtmgp_sw_clear_mega(*head, *comp_ptrs, *map(_ptr, (*scratch, *fluxes, cover)), *dims,
                                           *comp_scalars, *plan, _stream(dev))
    _build.check(err, "sw_clear_mega", *fluxes)
    sw_clear_mega.launches += 1
    return (*fluxes, cover) if seeded else tuple(fluxes)


sw_clear_mega.launches = 0

#: layers of one chunk that sw_clear_mega stages in shared memory
#: (csrc/sw_clear_mega.cu SW_CHUNK)
SW_CHUNK = 8


def _sw_clear_mega_plan(tabs: KernelTables, nlay: int, real: torch.dtype, composition: list, dev):
    """sw_clear_mega's launch plan and the shared memory it stages besides
    its level sums (chunks of layers: it does not grow with nlay);
    ``composition`` is (cloud, aero, mask_mode)."""
    f64 = int(real == torch.float64)
    staged = _build.library().rrtmgp_sw_clear_mega_staged(tabs.lkp.n_bnd, tabs.n_minor, *composition, f64)
    plan = kernel_plan("sw_clear_mega", dev, tabs.lkp.n_gpt, nlay, 3, real.itemsize, staged,
                       _variant(composition) | f64 << 4)
    return plan, staged


def sw_clear_mega_design(inp: MegaInputs, tabs: KernelTables, comp: Composition = CLEAR) -> dict:
    """How ``sw_clear_mega`` launches for these inputs (on the card), as
    ``lw_clear_mega_design`` reports it, with ``staged`` the shared memory
    of the staging area alone and ``state`` what its four state arrays hold
    (csrc/sw_clear_mega.cu: clear sky recomputes the coefficients in the
    adding and flux passes)."""
    dev = inp.jtemp.device
    real = inp.ftemp.dtype
    scalars = _composition_args(comp, dev, inp.nlay, inp.ncol, tabs.lkp.n_gpt, tabs.lkp.n_bnd)[1]
    plan, staged = _sw_clear_mega_plan(tabs, inp.nlay, real, scalars[:3], dev)
    sums = in_block_bytes(plan.group, inp.nlay, 3, real.itemsize) if plan.in_block else 0
    state = ("tau, ssa, the beam (then the albedo), the source; coefficients recomputed" if comp.clear else
             "Rdir * beam, Tdir * beam, Rdif, Tdif, rewritten by the adding pass")
    return dict(group=plan.group, n_groups=plan.n_groups, chunk=SW_CHUNK, smem=staged + sums, staged=staged,
                in_block=plan.in_block, state=state, max_threads=LAST_PLANS["sw_clear_mega"][1])


# ---------------------------------------------------------------------------
# McICA export
# ---------------------------------------------------------------------------


def mcica_mask_export_ref(cld_frac: torch.Tensor, seed: int, col_offset: int, n_gpt: int):
    """Plain twin of ``mcica_mask_export``: ``ops.cloud_optics.mcica_sample``
    with the mask as 0/1 floats."""
    u, mask = mcica_sample(cld_frac, n_gpt, seed, col_offset)
    return u, mask.to(u.dtype)


def mcica_mask_export(cld_frac: torch.Tensor, seed: int, col_offset: int, n_gpt: int):
    """The McICA uniforms and mask, each (nlay, ncol, n_gpt) f32, that the
    all-sky kernels draw for (seed, global column col_offset + c)."""
    if cld_frac.device.type == "cpu":
        return mcica_mask_export_ref(cld_frac, seed, col_offset, n_gpt)
    dev = _cuda_device(cld_frac, "mcica_mask_export")
    if cld_frac.dim() != 2 or n_gpt < 1:
        raise ValueError(f"mcica_mask_export: cld_frac {tuple(cld_frac.shape)}, n_gpt {n_gpt}")
    plan = kernel_plan("mcica_mask_export", dev, n_gpt)
    nlay, ncol = cld_frac.shape
    _require(cld_frac, "cld_frac", (nlay, ncol), torch.float32, dev)
    hi, lo = seed_key(seed)
    u = torch.empty((nlay, ncol, n_gpt), dtype=torch.float32, device=dev)
    m = torch.empty_like(u)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_mcica_export(
            _ptr(cld_frac), _ptr(u), _ptr(m), nlay, ncol, n_gpt, plan.group, plan.n_groups, hi, lo,
            int(col_offset), _stream(dev)
        )
    _build.check(err, "mcica_mask_export", u)
    mcica_mask_export.launches += 1
    return u, m


mcica_mask_export.launches = 0

#: every kernel wrapper of the port: the megakernels' path (with the
#: composition's ``aerosol_bands`` and ``cloud_bands``), the optics kernels
#: (``ops.interp``) and the sweeps (``ops.rte_kernels``)
KERNEL_WRAPPERS = (planck_band, lw_clear_mega, lw2_mega, sw_clear_mega, aerosol_bands, cloud_bands,
                   mcica_mask_export, optics_fused, planck_band_rows, lw_noscat_banded_reduced,
                   sw_2stream_reduced, lw_noscat_reduced, lw_2stream_reduced, sw_2stream_gpt,
                   lw_noscat_gpt, interp_pt_eta, interp_minor)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
