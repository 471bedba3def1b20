"""The sweep kernels and their plain torch twins (counterpart of
``rrtmgp_tpu/ops/pallas_rte.py``): from optics materialized per (layer,
column, g-point) to fluxes.

Summed over g-points, (nlay+1, ncol), as the solves use them:

- ``lw_noscat_banded_reduced``: LW no-scattering sweep for one angle, the
  Planck sources built in the kernel from band Planck values and the Planck
  fraction (replaces ``lw_noscat_banded_reduced``);
  ``lw_noscat_banded_angles``: the same summed over 1 to 4 quadrature
  angles in one launch of the same kernel, the bits of the one-angle
  wrapper called per angle (what the solves call; the JAX package calls
  ``lw_noscat_banded_reduced`` per angle and sums);
- ``lw_noscat_reduced``: the same sweep from materialized layer, level and
  surface sources (replaces ``lw_noscat_pallas_reduced``);
  ``lw_noscat_reduced_angles``: the same over 1 to 4 angles in one launch
  of the same kernel, the bits of the one-angle wrapper called per angle
  (what the sweep route's solves call);
- ``lw_2stream_reduced``: LW two-stream sweep from materialized level and
  surface sources (replaces ``lw_2stream_pallas_reduced``);
- ``sw_2stream_reduced``: SW two-stream sweep, the asymmetry optional
  (replaces ``sw_2stream_pallas_reduced``, blocked and streamed).

Per g-point, (nlay+1, ncol, ngpt), entry points of their own that no solve
calls (spectral diagnostics):

- ``sw_2stream_gpt``: SW two-stream sweep (replaces ``sw_2stream_pallas``),
  its state in its outputs, the bottom levels' in shared memory
  (``sw_2stream_gpt_design``);
- ``lw_noscat_gpt``: LW no-scattering sweep for one angle (replaces
  ``lw_noscat_pallas``), the bottom layers' upward sources kept from the
  downward pass in shared memory (``lw_noscat_gpt_design``).

Each wrapper launches its CUDA kernel (``csrc/lw_noscat_banded.cu``,
``csrc/lw_noscat_sources.cu``, ``csrc/lw_2stream_reduced.cu``,
``csrc/sw_2stream_reduced.cu``) for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it returns its twin ``*_ref``.
``<wrapper>.launches`` counts the launches (the two wrappers of
``csrc/lw_noscat_banded.cu`` on ``lw_noscat_banded_reduced.launches``, the
two of the summed sweep of ``csrc/lw_noscat_sources.cu`` on
``lw_noscat_reduced.launches``).
The kernels are f32 and run one thread per g-point: up to the kernel's
block limit (``_launch.max_threads``: 1024, or fewer where its registers
do not fit them) one block per column, beyond that a column over several
blocks (``_launch.gpoint_plan``), its level sums completed in the same order, as
they are for a column too deep for its sums to fit a block, so any g-point
count and depth gives the same bits as one block would. A g-summed call
over several blocks is the sweep and ``finish_level_sums``
(``csrc/common.cuh``, one launch per angle for the multi-angle sweeps); the
count takes one for the call.

Boundary fields: the g-summed sweeps take band-valued emissivity and albedos
as the solves hold them, (nbnd, ncol), with ``gpt2band``, the (ngpt,) int32
band of each g-point (``KernelTables.gpt2band``), which spares the solves an
expansion to g-points; the surface source, the TOA flux and the incident
fluxes are per g-point, (ncol, ngpt), as they exist. The per-g-point sweeps
take every boundary field per g-point, (ncol, ngpt), ``mu0`` included, in the
argument order of the JAX functions they replace.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _launch
from ._launch import LAST_PLANS, LaunchPlan, cuda_device, kernel_plan, level_partials, ptr, require, stream
from .gas_optics import planck_sources_from_bands
from .rte import intensity_to_flux, lw_2stream, lw_noscat, round_to, sw_2stream


def _dims(tau: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(nlay, ncol, ngpt) of a sweep's tau; raises unless it is 3-D with at
    least one g-point."""
    if tau.dim() != 3:
        raise ValueError(f"{name}: tau {tuple(tau.shape)}, expected (nlay, ncol, ngpt)")
    if tau.shape[2] < 1:
        raise ValueError(f"n_gpt={tau.shape[2]}: the kernels take 1 g-point or more")
    return tuple(tau.shape)


def sweep_plan(kernel: str, nf: int, nlay: int, ngpt: int, dev, variant: int = 0, per_thread: int = 0) -> LaunchPlan:
    """The launch plan of the g-summed f32 sweep ``kernel`` (instance
    ``variant``, see ``_launch.max_threads``) with nf fields on ``dev``;
    ``per_thread`` bytes of shared memory of its own a thread."""
    return kernel_plan(kernel, dev, ngpt, nlay, nf, 4, 0, variant, per_thread)


def _plan(kernel: str, nf: int, nlay: int, ncol: int, ngpt: int, dev, variant: int = 0, per_thread: int = 0):
    """(group, n_groups, in_block) of the launch plan of a g-summed sweep
    with nf fields and its level partials (None when the sums stay in the
    block)."""
    plan = sweep_plan(kernel, nf, nlay, ngpt, dev, variant, per_thread)
    return (plan.group, plan.n_groups, int(plan.in_block)), level_partials(plan, nf, nlay + 1, ncol, torch.float32,
                                                                            dev)


def angles_plan(kernel: str, nang: int, nlay: int, ncol: int, ngpt: int, dev):
    """(group, n_groups, in_block) of the launch plan of the multi-angle LW
    sweep ``kernel`` (lw_noscat_banded, the summed lw_noscat_sources, whose
    instance is the number of angles) over nang angles and its level
    partials (None when the sums stay in the block): 2 x nang level-sum
    fields, each angle's up and down."""
    return _plan(kernel, 2 * nang, nlay, ncol, ngpt, dev, nang)


def lw_noscat_banded_reduced_ref(
    tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds: float, w_mu: float, inc_flux=None,
):
    """Plain twin of ``lw_noscat_banded_reduced``: the Planck sources of
    ``ops.gas_optics.planck_sources_from_bands``, then ``ops.rte.lw_noscat``,
    summed over g-points. Any float dtype."""
    g2b = gpt2band.long()
    src = planck_sources_from_bands(g2b, plk_lay, plk_lev, plk_sfc, pfrac)
    up, dn = lw_noscat(
        tau, src.lay_source, src.lev_source, src.sfc_source, sfc_emis.T[:, g2b], ds, w_mu, inc_flux
    )
    return up.sum(-1), dn.sum(-1)


def _angles_sum(one_angle, args, ds, w_mu, inc_flux):
    """one_angle(*args, ds_k, w_k, inc_flux * w_k) -> (flux_up, flux_dn)
    summed in the angles' order: the sum a solve made of one launch per
    angle."""
    up = dn = None
    for d, w in zip(ds, w_mu):
        u, v = one_angle(*args, d, w, None if inc_flux is None else inc_flux * float(w))
        up, dn = (u, v) if up is None else (up + u, dn + v)
    return up, dn


def lw_noscat_banded_angles_ref(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds, w_mu,
                                inc_flux=None):
    """Plain twin of ``lw_noscat_banded_angles``: the one-angle twin per
    angle with the incident flux ``inc_flux * w_k``, summed in the angles'
    order. Any float dtype."""
    return _angles_sum(lw_noscat_banded_reduced_ref, (tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band),
                       ds, w_mu, inc_flux)


#: the most quadrature angles one launch of lw_noscat_banded or
#: lw_noscat_reduced sweeps (csrc/common.cuh MAX_ANGLES;
#: angular_discretization's too)
MAX_ANGLES = 4


def _angle_arrays(ds, w_mu, name: str):
    """The secants and pi x weights of a multi-angle launch as ctypes float
    arrays (what the C entries read); raises unless there are 1 to
    MAX_ANGLES of each."""
    nang = len(ds)
    if not 1 <= nang <= MAX_ANGLES or len(w_mu) != nang:
        raise ValueError(f"{name}: {nang} secants and {len(w_mu)} weights; the kernel takes 1 to {MAX_ANGLES} "
                         "angles")
    f32 = torch.float32
    floats = lambda xs: (ctypes.c_float * nang)(*xs)
    return floats([round_to(d, f32) for d in ds]), floats([intensity_to_flux(w, f32) for w in w_mu])


def _lw_noscat_banded_launch(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds, w_mu, inc,
                             name: str):
    """One launch of csrc/lw_noscat_banded.cu for the angles of secants
    ``ds`` and weights ``w_mu`` (1 to 4), ``inc`` each angle's incident flux
    (nang, ncol, ngpt) or None. Returns each angle's fluxes, (nang, nlay+1,
    ncol) up and down. Counted on ``lw_noscat_banded_reduced.launches``,
    which both wrappers of the kernel share."""
    dev = cuda_device(tau, name)
    nang = len(ds)
    angles = _angle_arrays(ds, w_mu, name)
    if plk_sfc.dim() != 2:
        raise ValueError(f"{name}: plk_sfc {tuple(plk_sfc.shape)}")
    nlay, ncol, ngpt = _dims(tau, name)
    nbnd = plk_sfc.shape[1]
    f32 = torch.float32
    for arg, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("pfrac", pfrac, (nlay, ncol, ngpt)),
        ("plk_lay", plk_lay, (nlay, ncol, nbnd)), ("plk_lev", plk_lev, (nlay + 1, ncol, nbnd)),
        ("plk_sfc", plk_sfc, (ncol, nbnd)), ("sfc_emis", sfc_emis, (nbnd, ncol)),
    ):
        require(x, arg, shape, f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc is not None:
        require(inc, "inc_flux", (nang, ncol, ngpt), f32, dev)
    up = torch.empty((nang, nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    groups, partials = angles_plan("lw_noscat_banded", nang, nlay, ncol, ngpt, dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_noscat_banded(
            *map(ptr, (tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, inc, up, dn, partials)),
            nlay, ncol, ngpt, nbnd, *groups, nang, *angles, stream(dev),
        )
    _build.check(err, name, up, dn)
    lw_noscat_banded_reduced.launches += 1
    return up, dn


def lw_noscat_banded_reduced(
    tau: torch.Tensor,       # (nlay, ncol, ngpt) optical depth
    pfrac: torch.Tensor,     # (nlay, ncol, ngpt) Planck fraction
    plk_lay: torch.Tensor,   # (nlay, ncol, nbnd) band Planck at t_lay
    plk_lev: torch.Tensor,   # (nlay+1, ncol, nbnd) band Planck at t_lev
    plk_sfc: torch.Tensor,   # (ncol, nbnd) band Planck at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    gpt2band: torch.Tensor,  # (ngpt,) int32
    ds: float, w_mu: float,
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """LW no-scattering transport for one angle (secant ``ds``, weight
    ``w_mu``) with the sources built from band Planck values times the Planck
    fraction (level values: the geometric mean of the adjacent layers'
    fractions, the boundary levels their layer's own). Returns (flux_up,
    flux_dn), each (nlay+1, ncol), summed over g-points."""
    if tau.device.type == "cpu":
        return lw_noscat_banded_reduced_ref(
            tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds, w_mu, inc_flux)
    inc = None if inc_flux is None else inc_flux[None]
    up, dn = _lw_noscat_banded_launch(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, [ds], [w_mu], inc,
                                      "lw_noscat_banded_reduced")
    return up[0], dn[0]


def lw_noscat_banded_angles(
    tau: torch.Tensor,       # (nlay, ncol, ngpt) optical depth
    pfrac: torch.Tensor,     # (nlay, ncol, ngpt) Planck fraction
    plk_lay: torch.Tensor,   # (nlay, ncol, nbnd) band Planck at t_lay
    plk_lev: torch.Tensor,   # (nlay+1, ncol, nbnd) band Planck at t_lev
    plk_sfc: torch.Tensor,   # (ncol, nbnd) band Planck at t_sfc
    sfc_emis: torch.Tensor,  # (nbnd, ncol)
    gpt2band: torch.Tensor,  # (ngpt,) int32
    ds, w_mu,                # the angles' secants and weights, 1 to 4 of each
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """``lw_noscat_banded_reduced`` summed over the quadrature angles
    (secants ``ds``, weights ``w_mu``) in one launch: angle k sees the
    incident flux ``inc_flux * w_k`` (the Gauss-Jacobi weights sum to 1,
    so every angle sees the same isotropic intensity). Returns (flux_up,
    flux_dn), each (nlay+1, ncol), added in the angles' order: the bits of
    the one-angle wrapper called per angle and summed."""
    if tau.device.type == "cpu":
        return lw_noscat_banded_angles_ref(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, ds, w_mu,
                                           inc_flux)
    inc = None if inc_flux is None else torch.stack([inc_flux * float(w) for w in w_mu])
    up, dn = _lw_noscat_banded_launch(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, list(ds),
                                      list(w_mu), inc, "lw_noscat_banded_angles")
    return _sum_angles(up), _sum_angles(dn)


def _sum_angles(per_angle: torch.Tensor) -> torch.Tensor:
    """The angles' fluxes added in their order, (nlay+1, ncol)."""
    total = per_angle[0]
    for k in range(1, per_angle.shape[0]):
        total = total + per_angle[k]
    return total


lw_noscat_banded_reduced.launches = 0


def sw_sweep_scratch(nlay: int, ncol: int, ngpt: int, device) -> tuple:
    """The scratch of one sw_2stream_reduced call, two (nlay, ncol, ngpt)
    f32 arrays: the beam at each layer's top, whose slot the kernel reads
    before it writes the albedo at the layer's bottom there, and the
    source."""
    return tuple(torch.empty((nlay, ncol, ngpt), dtype=torch.float32, device=device) for _ in range(2))


def sw_2stream_reduced_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse=None):
    """Plain twin of ``sw_2stream_reduced``: ``ops.rte.sw_2stream`` (g None
    is asymmetry 0), summed over g-points. Night columns are not zeroed. Any
    float dtype."""
    g2b = gpt2band.long()
    up, dn, dn_dir = sw_2stream(
        tau, ssa, 0.0 if g is None else g, mu0[:, None], toa_gpt,
        alb_dir.T[:, g2b], alb_dif.T[:, g2b], inc_flux_diffuse,
    )
    return up.sum(-1), dn.sum(-1), dn_dir.sum(-1)


def sw_2stream_reduced(
    tau: torch.Tensor,        # (nlay, ncol, ngpt) optical depth
    ssa: torch.Tensor,        # (nlay, ncol, ngpt) single-scattering albedo
    g: torch.Tensor | None,   # (nlay, ncol, ngpt) asymmetry; None: 0 (clear sky)
    mu0: torch.Tensor,        # (ncol,) cosine of the solar zenith angle
    toa_gpt: torch.Tensor,    # (ncol, ngpt) TOA flux per g-point
    alb_dir: torch.Tensor,    # (nbnd, ncol)
    alb_dif: torch.Tensor,    # (nbnd, ncol)
    gpt2band: torch.Tensor,   # (ngpt,) int32
    inc_flux_diffuse: torch.Tensor | None = None,  # (ncol, ngpt)
):
    """SW two-stream transport: direct beam, layer coefficients, adding and
    diffuse flux. Returns (flux_up, flux_dn, flux_dn_dir), each (nlay+1,
    ncol), summed over g-points; flux_dn includes the direct beam. Night
    columns are the caller's to zero. The kernel holds the scratch of
    ``sw_sweep_scratch`` while it runs."""
    if tau.device.type == "cpu":
        return sw_2stream_reduced_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse)
    dev = cuda_device(tau, "sw_2stream_reduced")
    if alb_dir.dim() != 2:
        raise ValueError(f"sw_2stream_reduced: alb_dir {tuple(alb_dir.shape)}")
    nlay, ncol, ngpt = _dims(tau, "sw_2stream_reduced")
    nbnd = alb_dir.shape[0]
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("ssa", ssa, (nlay, ncol, ngpt)), ("mu0", mu0, (ncol,)),
        ("toa_gpt", toa_gpt, (ncol, ngpt)), ("alb_dir", alb_dir, (nbnd, ncol)),
        ("alb_dif", alb_dif, (nbnd, ncol)),
    ):
        require(x, name, shape, f32, dev)
    if g is not None:
        require(g, "g", (nlay, ncol, ngpt), f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc_flux_diffuse is not None:
        require(inc_flux_diffuse, "inc_flux_diffuse", (ncol, ngpt), f32, dev)
    scratch = sw_sweep_scratch(nlay, ncol, ngpt, dev)
    fluxes = [torch.empty((nlay + 1, ncol), dtype=f32, device=dev) for _ in range(3)]
    groups, partials = _plan("sw_2stream_reduced", 3, nlay, ncol, ngpt, dev, int(g is not None))
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_sw_2stream_reduced(
            *map(ptr, (tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_flux_diffuse,
                       *scratch, *fluxes, partials)),
            nlay, ncol, ngpt, nbnd, *groups, stream(dev),
        )
    _build.check(err, "sw_2stream_reduced", *fluxes)
    sw_2stream_reduced.launches += 1
    return tuple(fluxes)


sw_2stream_reduced.launches = 0


def _emis_gpt(sfc_emis, gpt2band):
    """Band-valued (nbnd, ncol) boundary field per g-point, (ncol, ngpt)."""
    return sfc_emis.T[:, gpt2band.long()]


def lw_noscat_reduced_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, ds: float, w_mu: float,
                          inc_flux=None):
    """Plain twin of ``lw_noscat_reduced``: ``ops.rte.lw_noscat`` summed
    over g-points. Any float dtype."""
    up, dn = lw_noscat(tau, lay_source, lev_source, sfc_source, _emis_gpt(sfc_emis, gpt2band), ds, w_mu, inc_flux)
    return up.sum(-1), dn.sum(-1)


def lw_noscat_reduced_angles_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, ds, w_mu,
                                 inc_flux=None):
    """Plain twin of ``lw_noscat_reduced_angles``: the one-angle twin per
    angle with the incident flux ``inc_flux * w_k``, summed in the angles'
    order. Any float dtype."""
    return _angles_sum(lw_noscat_reduced_ref, (tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band), ds,
                       w_mu, inc_flux)


def _lw_noscat_reduced_launch(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, ds, w_mu, inc,
                              name: str):
    """One launch of csrc/lw_noscat_sources.cu's summed sweep for the angles
    of secants ``ds`` and weights ``w_mu`` (1 to 4), ``inc`` each angle's
    incident flux (nang, ncol, ngpt) or None. Returns each angle's fluxes,
    (nang, nlay+1, ncol) up and down. Counted on
    ``lw_noscat_reduced.launches``, which both wrappers of the sweep share."""
    dev = cuda_device(tau, name)
    nang = len(ds)
    angles = _angle_arrays(ds, w_mu, name)
    nlay, ncol, ngpt = _dims(tau, name)
    if sfc_emis.dim() != 2:
        raise ValueError(f"{name}: sfc_emis {tuple(sfc_emis.shape)}")
    f32 = torch.float32
    for arg, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("lay_source", lay_source, (nlay, ncol, ngpt)),
        ("lev_source", lev_source, (nlay + 1, ncol, ngpt)), ("sfc_source", sfc_source, (ncol, ngpt)),
        ("sfc_emis", sfc_emis, (sfc_emis.shape[0], ncol)),
    ):
        require(x, arg, shape, f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc is not None:
        require(inc, "inc_flux", (nang, ncol, ngpt), f32, dev)
    up = torch.empty((nang, nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    groups, partials = angles_plan("lw_noscat_reduced", nang, nlay, ncol, ngpt, dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_noscat_reduced(
            *map(ptr, (tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, inc, up, dn, partials)),
            nlay, ncol, ngpt, *groups, nang, *angles, stream(dev),
        )
    _build.check(err, name, up, dn)
    lw_noscat_reduced.launches += 1
    return up, dn


def lw_noscat_reduced(
    tau: torch.Tensor,         # (nlay, ncol, ngpt) optical depth
    lay_source: torch.Tensor,  # (nlay, ncol, ngpt) layer Planck source
    lev_source: torch.Tensor,  # (nlay+1, ncol, ngpt) level Planck source
    sfc_source: torch.Tensor,  # (ncol, ngpt) surface Planck source
    sfc_emis: torch.Tensor,    # (nbnd, ncol)
    gpt2band: torch.Tensor,    # (ngpt,) int32
    ds: float, w_mu: float,
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """LW no-scattering transport for one angle (secant ``ds``, weight
    ``w_mu``) from materialized Planck sources. Returns (flux_up, flux_dn),
    each (nlay+1, ncol), summed over g-points."""
    if tau.device.type == "cpu":
        return lw_noscat_reduced_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, ds, w_mu, inc_flux)
    inc = None if inc_flux is None else inc_flux[None]
    up, dn = _lw_noscat_reduced_launch(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, [ds], [w_mu],
                                       inc, "lw_noscat_reduced")
    return up[0], dn[0]


def lw_noscat_reduced_angles(
    tau: torch.Tensor,         # (nlay, ncol, ngpt) optical depth
    lay_source: torch.Tensor,  # (nlay, ncol, ngpt) layer Planck source
    lev_source: torch.Tensor,  # (nlay+1, ncol, ngpt) level Planck source
    sfc_source: torch.Tensor,  # (ncol, ngpt) surface Planck source
    sfc_emis: torch.Tensor,    # (nbnd, ncol)
    gpt2band: torch.Tensor,    # (ngpt,) int32
    ds, w_mu,                  # the angles' secants and weights, 1 to 4 of each
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """``lw_noscat_reduced`` summed over the quadrature angles (secants
    ``ds``, weights ``w_mu``) in one launch: angle k sees the incident flux
    ``inc_flux * w_k``. Returns (flux_up, flux_dn), each (nlay+1, ncol),
    added in the angles' order: the bits of the one-angle wrapper called
    per angle and summed."""
    if tau.device.type == "cpu":
        return lw_noscat_reduced_angles_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, ds, w_mu,
                                            inc_flux)
    inc = None if inc_flux is None else torch.stack([inc_flux * float(w) for w in w_mu])
    up, dn = _lw_noscat_reduced_launch(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, list(ds),
                                       list(w_mu), inc, "lw_noscat_reduced_angles")
    return _sum_angles(up), _sum_angles(dn)


lw_noscat_reduced.launches = 0


#: bytes a per-g-point sweep keeps in shared memory for each bottom level or
#: layer it holds there, a thread: two f32 (csrc/common.cuh bottom_state_bytes)
BOTTOM_STATE_BYTES = 8
#: bottom layers whose transmittance and upward source lw_noscat_gpt keeps
#: in shared memory from its downward pass, at most (csrc/lw_noscat_sources.cu;
#: the fastest of 0-60 at 32768 x 60 x 256 on an H100, PERF.md)
LW_GPT_LAYERS = 12


def _bottom_state_plan(kernel: str, most: int, nlay: int, ngpt: int, device: torch.device, variant: int = 0) -> dict:
    """How a per-g-point sweep ``kernel`` (instance ``variant``) launches
    that keeps up to ``most`` bottom levels or layers of its state in
    shared memory (``BOTTOM_STATE_BYTES`` each, a thread): the number it
    keeps (a column of fewer whole, fewer where a block of the kernel's
    plan would not hold them), that memory a block, the launch plan and the
    block limit of the kernel."""
    group = kernel_plan(kernel, device, ngpt, variant=variant).group
    kept = min(most, nlay)
    if kept:
        kept = min(kept, _launch.smem_limit(device) // (BOTTOM_STATE_BYTES * group))
    plan = sweep_plan(kernel, 0, nlay, ngpt, device, variant, per_thread=BOTTOM_STATE_BYTES * kept)
    return dict(kept=kept, smem=BOTTOM_STATE_BYTES * kept * plan.group, group=plan.group, n_groups=plan.n_groups,
                max_threads=LAST_PLANS[kernel][1])


def lw_noscat_gpt_design(nlay: int, ngpt: int, device: torch.device) -> dict:
    """How ``lw_noscat_gpt`` launches for ``nlay`` layers and ``ngpt``
    g-points on ``device``: the bottom layers it keeps in shared memory (at
    most ``LW_GPT_LAYERS``), see ``_bottom_state_plan``."""
    return _bottom_state_plan("lw_noscat_gpt", LW_GPT_LAYERS, nlay, ngpt, device)


def lw_noscat_gpt_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, ds: float, w_mu: float, inc_flux=None):
    """Plain twin of ``lw_noscat_gpt``: ``ops.rte.lw_noscat``. Any float
    dtype."""
    return lw_noscat(tau, lay_source, lev_source, sfc_source, sfc_emis, ds, w_mu, inc_flux)


def lw_noscat_gpt(
    tau: torch.Tensor,         # (nlay, ncol, ngpt) optical depth
    lay_source: torch.Tensor,  # (nlay, ncol, ngpt) layer Planck source
    lev_source: torch.Tensor,  # (nlay+1, ncol, ngpt) level Planck source
    sfc_source: torch.Tensor,  # (ncol, ngpt) surface Planck source
    sfc_emis: torch.Tensor,    # (ncol, ngpt)
    ds: float, w_mu: float,
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """LW no-scattering transport for one angle with the fluxes kept per
    g-point (the JAX package's ``lw_noscat_pallas``, same argument order).
    Returns (flux_up, flux_dn), each (nlay+1, ncol, ngpt). The kernel keeps
    the bottom layers of ``lw_noscat_gpt_design`` in shared memory."""
    if tau.device.type == "cpu":
        return lw_noscat_gpt_ref(tau, lay_source, lev_source, sfc_source, sfc_emis, ds, w_mu, inc_flux)
    dev = cuda_device(tau, "lw_noscat_gpt")
    nlay, ncol, ngpt = _dims(tau, "lw_noscat_gpt")
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("lay_source", lay_source, (nlay, ncol, ngpt)),
        ("lev_source", lev_source, (nlay + 1, ncol, ngpt)), ("sfc_source", sfc_source, (ncol, ngpt)),
        ("sfc_emis", sfc_emis, (ncol, ngpt)),
    ):
        require(x, name, shape, f32, dev)
    if inc_flux is not None:
        require(inc_flux, "inc_flux", (ncol, ngpt), f32, dev)
    up = torch.empty((nlay + 1, ncol, ngpt), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    design = lw_noscat_gpt_design(nlay, ngpt, dev)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_noscat_gpt(
            *map(ptr, (tau, lay_source, lev_source, sfc_source, sfc_emis, inc_flux, up, dn)),
            nlay, ncol, ngpt, design["kept"], design["group"], design["n_groups"], round_to(ds, f32),
            intensity_to_flux(w_mu, f32), stream(dev),
        )
    _build.check(err, "lw_noscat_gpt", up, dn)
    lw_noscat_gpt.launches += 1
    return up, dn


lw_noscat_gpt.launches = 0


#: layers of one chunk of lw_2stream_reduced: its checkpoint spacing
#: (csrc/lw_2stream_reduced.cu LW2_CHUNK; the entry point refuses fewer
#: checkpoint levels than it needs)
LW2_CHUNK = 8
#: its chunk state in shared memory, bytes a thread: 4 f32 a layer of the
#: chunk (csrc/lw_2stream_reduced.cu lw2_chunk_bytes)
LW2_STATE_BYTES = 4 * 4 * LW2_CHUNK


def lw2_sweep_scratch(nlay: int, ncol: int, ngpt: int, device) -> tuple:
    """The scratch of one lw_2stream_reduced call: the (alb, src)
    checkpoints, two (ceil(nlay / LW2_CHUNK), ncol, ngpt) f32 arrays, the
    albedo and the source at the bottom level of each chunk of layers."""
    levels = -(-nlay // LW2_CHUNK)
    return tuple(torch.empty((levels, ncol, ngpt), dtype=torch.float32, device=device) for _ in range(2))


def lw_2stream_reduced_design(nlay: int, ngpt: int, device: torch.device) -> dict:
    """How ``lw_2stream_reduced`` launches for ``nlay`` layers and ``ngpt``
    g-points on ``device`` (the card): the chunk, the checkpoint levels (in
    device memory), the chunk state's shared memory a block, the launch
    plan and the block limit of the kernel."""
    plan = sweep_plan("lw_2stream_reduced", 2, nlay, ngpt, device, per_thread=LW2_STATE_BYTES)
    return dict(chunk=LW2_CHUNK, checkpoints=-(-nlay // LW2_CHUNK), chunk_smem=LW2_STATE_BYTES * plan.group,
                group=plan.group, n_groups=plan.n_groups, in_block=plan.in_block,
                max_threads=LAST_PLANS["lw_2stream_reduced"][1])


def lw_2stream_reduced_ref(tau, ssa, g, lev_source, sfc_source, sfc_emis, gpt2band, inc_flux=None):
    """Plain twin of ``lw_2stream_reduced``: ``ops.rte.lw_2stream`` summed
    over g-points. Any float dtype."""
    up, dn = lw_2stream(tau, ssa, g, lev_source, sfc_source, _emis_gpt(sfc_emis, gpt2band), inc_flux)
    return up.sum(-1), dn.sum(-1)


def lw_2stream_reduced(
    tau: torch.Tensor,         # (nlay, ncol, ngpt) optical depth
    ssa: torch.Tensor,         # (nlay, ncol, ngpt) single-scattering albedo
    g: torch.Tensor,           # (nlay, ncol, ngpt) asymmetry
    lev_source: torch.Tensor,  # (nlay+1, ncol, ngpt) level Planck source
    sfc_source: torch.Tensor,  # (ncol, ngpt) surface Planck source
    sfc_emis: torch.Tensor,    # (nbnd, ncol)
    gpt2band: torch.Tensor,    # (ngpt,) int32
    inc_flux: torch.Tensor | None = None,  # (ncol, ngpt) TOA incident flux
):
    """LW two-stream transport from materialized optics and level sources:
    layer coefficients, adding and diffuse flux. Returns (flux_up, flux_dn),
    each (nlay+1, ncol), summed over g-points. The kernel holds the
    checkpoints of ``lw2_sweep_scratch`` while it runs."""
    if tau.device.type == "cpu":
        return lw_2stream_reduced_ref(tau, ssa, g, lev_source, sfc_source, sfc_emis, gpt2band, inc_flux)
    dev = cuda_device(tau, "lw_2stream_reduced")
    nlay, ncol, ngpt = _dims(tau, "lw_2stream_reduced")
    if sfc_emis.dim() != 2:
        raise ValueError(f"lw_2stream_reduced: sfc_emis {tuple(sfc_emis.shape)}")
    nbnd = sfc_emis.shape[0]
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("ssa", ssa, (nlay, ncol, ngpt)), ("g", g, (nlay, ncol, ngpt)),
        ("lev_source", lev_source, (nlay + 1, ncol, ngpt)), ("sfc_source", sfc_source, (ncol, ngpt)),
        ("sfc_emis", sfc_emis, (nbnd, ncol)),
    ):
        require(x, name, shape, f32, dev)
    require(gpt2band, "gpt2band", (ngpt,), torch.int32, dev)
    if inc_flux is not None:
        require(inc_flux, "inc_flux", (ncol, ngpt), f32, dev)
    scratch = lw2_sweep_scratch(nlay, ncol, ngpt, dev)
    up = torch.empty((nlay + 1, ncol), dtype=f32, device=dev)
    dn = torch.empty_like(up)
    groups, partials = _plan("lw_2stream_reduced", 2, nlay, ncol, ngpt, dev, per_thread=LW2_STATE_BYTES)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_lw_2stream_reduced(
            *map(ptr, (tau, ssa, g, lev_source, sfc_source, sfc_emis, gpt2band, inc_flux, *scratch, up, dn,
                       partials)),
            nlay, ncol, ngpt, nbnd, scratch[0].shape[0], *groups, stream(dev),
        )
    _build.check(err, "lw_2stream_reduced", up, dn)
    lw_2stream_reduced.launches += 1
    return up, dn


lw_2stream_reduced.launches = 0


#: bottom levels whose albedo and source sw_2stream_gpt keeps in shared
#: memory between its adding and its flux pass, at most
#: (csrc/sw_2stream_reduced.cu; the fastest of 0-60 at 32768 x 60 x 224 on
#: an H100, PERF.md)
SW_GPT_LEVELS = 24


def sw_2stream_gpt_design(nlay: int, ngpt: int, device: torch.device, has_g: bool = False) -> dict:
    """How ``sw_2stream_gpt`` launches for ``nlay`` layers and ``ngpt``
    g-points on ``device`` (with or without an asymmetry): the bottom
    levels it keeps in shared memory (at most ``SW_GPT_LEVELS``), see
    ``_bottom_state_plan``."""
    return _bottom_state_plan("sw_2stream_gpt", SW_GPT_LEVELS, nlay, ngpt, device, int(has_g))


def sw_2stream_gpt_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse=None):
    """Plain twin of ``sw_2stream_gpt``: ``ops.rte.sw_2stream`` (g None is
    asymmetry 0). Night columns are not zeroed. Any float dtype."""
    return sw_2stream(tau, ssa, 0.0 if g is None else g, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse)


def sw_2stream_gpt(
    tau: torch.Tensor,        # (nlay, ncol, ngpt) optical depth
    ssa: torch.Tensor,        # (nlay, ncol, ngpt) single-scattering albedo
    g: torch.Tensor | None,   # (nlay, ncol, ngpt) asymmetry; None: 0
    mu0: torch.Tensor,        # (ncol, ngpt) cosine of the solar zenith angle
    toa_gpt: torch.Tensor,    # (ncol, ngpt) TOA flux per g-point
    alb_dir: torch.Tensor,    # (ncol, ngpt)
    alb_dif: torch.Tensor,    # (ncol, ngpt)
    inc_flux_diffuse: torch.Tensor | None = None,  # (ncol, ngpt)
):
    """SW two-stream transport with the fluxes kept per g-point (the JAX
    package's ``sw_2stream_pallas``, same argument order; the asymmetry may
    be None here). Returns (flux_up, flux_dn, flux_dn_dir), each (nlay+1,
    ncol, ngpt); flux_dn includes the direct beam. Night columns are the
    caller's to zero. The kernel keeps its state in the outputs, no
    scratch, and the bottom levels of ``sw_2stream_gpt_design`` in shared
    memory."""
    if tau.device.type == "cpu":
        return sw_2stream_gpt_ref(tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse)
    dev = cuda_device(tau, "sw_2stream_gpt")
    nlay, ncol, ngpt = _dims(tau, "sw_2stream_gpt")
    f32 = torch.float32
    for name, x, shape in (
        ("tau", tau, (nlay, ncol, ngpt)), ("ssa", ssa, (nlay, ncol, ngpt)), ("mu0", mu0, (ncol, ngpt)),
        ("toa_gpt", toa_gpt, (ncol, ngpt)), ("alb_dir", alb_dir, (ncol, ngpt)), ("alb_dif", alb_dif, (ncol, ngpt)),
    ):
        require(x, name, shape, f32, dev)
    if g is not None:
        require(g, "g", (nlay, ncol, ngpt), f32, dev)
    if inc_flux_diffuse is not None:
        require(inc_flux_diffuse, "inc_flux_diffuse", (ncol, ngpt), f32, dev)
    fluxes = [torch.empty((nlay + 1, ncol, ngpt), dtype=f32, device=dev) for _ in range(3)]
    design = sw_2stream_gpt_design(nlay, ngpt, dev, g is not None)
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_sw_2stream_gpt(
            *map(ptr, (tau, ssa, g, mu0, toa_gpt, alb_dir, alb_dif, inc_flux_diffuse, *fluxes)),
            nlay, ncol, ngpt, design["kept"], design["group"], design["n_groups"], stream(dev),
        )
    _build.check(err, "sw_2stream_gpt", *fluxes)
    sw_2stream_gpt.launches += 1
    return tuple(fluxes)


sw_2stream_gpt.launches = 0
