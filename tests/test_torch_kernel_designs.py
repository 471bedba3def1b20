"""CPU rehearsals of the arithmetic of the kernel designs, with no card:

- ``sw_2stream_reduced`` (csrc/sw_2stream_reduced.cu): three passes, the beam
  stored top-down, the layer coefficients computed again from the optics in
  the bottom-up adding pass and in the top-down flux pass, the flux folded
  as the SW megakernel folds it. Modelled here in plain torch, op for op,
  beside a model of the four-array passes the SW megakernel keeps
  (csrc/sw_twostream.cuh ``sw_adding_and_fluxes``): the two give the same
  bits per g-point in f32 and f64, night columns included; summed over
  g-points they hold the kernel's twin (``sw_2stream_reduced_ref``) and the
  JAX package's ``sw_2stream``.
- ``interp_pt_eta`` (csrc/interp_pt_eta.cu): 32-bit table corner offsets
  formed once per (layer, column, band), the other corners fixed strides,
  the node above the table's last pressure slab not read. Modelled here,
  it equals the twin ``interp_pt_eta_ref`` bit for bit on kmajor (with
  col_mix), the Planck fraction and a 2-slab Rayleigh table read at side 1.
- ``interp_minor`` (csrc/interp_minor.cu): optics_fused's staged minor
  gather, kminor rows in int32 per (layer, column, band), only the cell's
  troposphere side's intervals. Modelled here, it equals the twin
  ``interp_minor_ref`` bit for bit, f32 and f64, LW and SW.
- ``lw_noscat_banded`` (csrc/lw_noscat_banded.cu) over several angles in
  one launch: the multi-angle wrapper is the one-angle twin summed in the
  angles' order (bit for bit on CPU tensors) and holds the JAX
  ``lw_noscat_banded_reduced`` run per angle and summed (rtol 2e-5 / atol
  1e-3, tests/test_torch_two_kernel.py's LW sweep tolerances); a level's
  angles reduced over the warp together (``add_fields``) have the bits of
  the per-field shuffle tree; the launch plan counts 2 x nang fields.

- ``sw_clear_mega`` (csrc/sw_clear_mega.cu) on the staged gather (and, on
  clear sky, the three passes above from its stored tau, ssa and beam):
  chunks
  of layers top-down, per (layer, column, band) the int32 kmajor and
  Rayleigh (troposphere side) corners, kminor rows and eta weights, per
  (layer, column) the weights, col_dry and the Rayleigh amount, tau =
  max(major + minor + ray, 0), ssa = ray / tau, then the cloud and aerosol
  increments from the staged band properties. Modelled here at 13 layers
  (a short last chunk), it equals ``optics_fused_ref`` bit for bit and, with
  a cloud mask and aerosols, the twins' composition.
- ``lw_noscat_reduced`` (csrc/lw_noscat_sources.cu) over several angles in
  one launch, as ``lw_noscat_banded`` above: the multi-angle wrapper is the
  one-angle twin summed in the angles' order and holds the JAX
  ``lw_noscat_pallas_reduced`` run per angle and summed (rtol 2e-5 / atol
  1e-3, tests/test_torch_sweeps.py's tolerance); it has K12's launch plan.

- ``planck_band`` / ``planck_band_rows`` (csrc/planck_band.cu): the blocks
  of the sets plan, each over its points, a point's node and weights formed
  once, the table read as (nbnd, n_t) as it is staged, the bands looped.
  Modelled here, it equals the twin ``planck_bands`` bit for bit in f32
  and f64, both layouts, temperatures below the table, on its nodes, in
  its last interval, on its last node and above it included; the staged
  bytes are the kernel's.

- ``sw_2stream_gpt`` (csrc/sw_2stream_reduced.cu): K15's three passes per
  g-point with the state in the three outputs, in place: the beam of every
  level in ``direct``, each level's albedo and source in ``up`` / ``dn``
  until the flux pass reads them and overwrites them with the fluxes, the
  beam recomputed there. Modelled here, it equals the four-array passes
  bit for bit, f32 and f64, with and without g and incident flux, night
  columns included, and holds the JAX ``sw_2stream_pallas`` (rtol 2e-4 /
  atol 2e-4, tests/test_torch_sweeps.py's gate).
- ``lw_noscat_gpt`` (csrc/lw_noscat_sources.cu): the bottom C layers'
  transmittance and upward source formed in the downward pass, the level
  source of a layer's top held from the iteration before. Modelled here,
  it equals the twin ``lw_noscat_gpt_ref`` bit for bit for every C, f32
  and f64, and holds the JAX ``lw_noscat_pallas`` (rtol 2e-5 / atol 1e-5).

And the wrappers' checks that the designs add: a table of 2^31 elements or
more is refused, sw_2stream_reduced's scratch is two arrays, and each C
entry point takes as many arguments as its ctypes signature lists.

Tolerances, relative to the largest reference value: the models against
the twin 1e-5 in f32 and 1e-12 in f64 (the twin forms the beam from the
summed optical depth and folds the flux in another order, a few ulp apart);
against the JAX ``sw_2stream`` rtol 2e-4 / atol 1e-3, as
tests/test_torch_two_kernel.py holds the SW sweep.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.ops import rte as jrte
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu_torch.ops import _build, _launch, interp, rte_kernels
from rrtmgp_tpu_torch.ops.gas_optics import planck_bands
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs
from rrtmgp_tpu_torch.ops.rte import intensity_to_flux as rte_intensity_to_flux
from rrtmgp_tpu_torch.ops.rte import lw_2stream_coeffs, round_to, sw_2stream_coeffs

# ---------------------------------------------------------------------------
# sw_2stream_reduced: the three-pass design against the four-array passes
# ---------------------------------------------------------------------------


def _sw_inputs(dtype, ncol=24, nlay=7, ngpt=20, nbnd=4, seed=0, night=True):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)
    mu0 = u(0.05, 1.0, ncol)
    if night:
        mu0[::5] = -0.2
        mu0[1::7] = 0.0
    return dict(tau=u(0.0, 3.0, nlay, ncol, ngpt), ssa=u(0.0, 1.0, nlay, ncol, ngpt), g=u(0.0, 0.85, nlay, ncol, ngpt),
                mu0=mu0, toa_gpt=u(1.0, 10.0, ncol, ngpt), alb_dir=u(0.05, 0.5, nbnd, ncol),
                alb_dif=u(0.05, 0.5, nbnd, ncol), gpt2band=torch.from_numpy((np.arange(ngpt) * nbnd // ngpt)
                                                                            .astype(np.int32)),
                inc=u(0.0, 5.0, ncol, ngpt))


def _surface(x):
    """The (ncol, ngpt) surface fields and the per-layer mu0 of the models."""
    g2b = x["gpt2band"].long()
    return x["alb_dir"].T[:, g2b], x["alb_dif"].T[:, g2b], x["mu0"][:, None]


def _coeffs(x, l, g):
    """sw_coeffs of layer l: (Rdir, Tdir, Rdif, Tdif, T0); the expression
    order of csrc/sw_twostream.cuh."""
    mu0 = x["mu0"][:, None]
    Rdir, Tdir, T0, Rdif, Tdif = sw_2stream_coeffs(x["tau"][l], x["ssa"][l], 0.0 if g is None else g[l], mu0)
    return Rdir, Tdir, Rdif, Tdif, T0


def _sw_four_arrays(x, g, inc):
    """The SW megakernel's passes (the design sw_2stream_reduced had before):
    top-down the beam in a register and Rdir * beam, Tdir * beam, Rdif, Tdif
    stored; bottom-up adding, rewriting the four arrays; top-down flux.
    Per g-point (up, diffuse down, direct), (nlev, ncol, ngpt)."""
    nlay = x["tau"].shape[0]
    adir, adif, _ = _surface(x)
    beam = x["toa_gpt"] * x["mu0"][:, None]
    direct = [None] * (nlay + 1)
    direct[nlay] = beam
    rdir, tdir, rdif, tdif = ([None] * nlay for _ in range(4))
    for l in range(nlay - 1, -1, -1):
        Rdir, Tdir, Rdif, Tdif, T0 = _coeffs(x, l, g)
        rdir[l], tdir[l], rdif[l], tdif[l] = Rdir * beam, Tdir * beam, Rdif, Tdif
        beam = beam * T0
        direct[l] = beam
    alb0, src0 = adif, beam * adir
    alb, src = alb0, src0
    for l in range(nlay):
        Rdif, Tdif, tdird = rdif[l], tdif[l], tdir[l]
        denom = 1.0 / (1.0 - Rdif * alb)
        alb_n = Rdif + Tdif * Tdif * alb * denom
        src_n = rdir[l] + Tdif * denom * (src + alb * tdird)
        rdif[l] = denom * (Rdif * src + tdird)
        tdif[l] = Tdif * denom
        rdir[l], tdir[l] = alb_n, src_n
        alb, src = alb_n, src_n
    fd = torch.zeros_like(beam) if inc is None else inc
    up, dn = [None] * (nlay + 1), [None] * (nlay + 1)
    up[nlay], dn[nlay] = fd * alb + src, fd
    for l in range(nlay - 1, -1, -1):
        fd = tdif[l] * fd + rdif[l]
        alb_l, src_l = (alb0, src0) if l == 0 else (rdir[l - 1], tdir[l - 1])
        up[l], dn[l] = fd * alb_l + src_l, fd
    return torch.stack(up), torch.stack(dn), torch.stack(direct)


def _sw_three_passes(x, g, inc):
    """sw_2stream_reduced's design: 1. top-down the beam at each layer's top
    to scratch; 2. bottom-up adding with each layer's coefficients computed
    from tau, ssa, g and its stored beam, the albedo and the source at its
    bottom level to scratch; 3. top-down flux with the coefficients, the
    beam and the denominator computed again, folded as the megakernel folds
    it. Same result layout as ``_sw_four_arrays``."""
    nlay = x["tau"].shape[0]
    adir, adif, mu0 = _surface(x)
    mu0_safe = torch.clamp(mu0, min=torch.finfo(x["tau"].dtype).eps)
    beam_toa = x["toa_gpt"] * x["mu0"][:, None]
    s_beam, s_alb, s_src = ([None] * nlay for _ in range(3))
    direct = [None] * (nlay + 1)
    beam = direct[nlay] = beam_toa
    for l in range(nlay - 1, -1, -1):                      # 1.
        s_beam[l] = beam
        beam = beam * torch.exp(-x["tau"][l] / mu0_safe)
        direct[l] = beam
    alb, src = adif, beam * adir
    for l in range(nlay):                                  # 2.
        bt = s_beam[l]
        Rdir, Tdir, Rdif, Tdif, _ = _coeffs(x, l, g)
        s_alb[l], s_src[l] = alb, src
        denom = 1.0 / (1.0 - Rdif * alb)
        alb_n = Rdif + Tdif * Tdif * alb * denom
        src_n = Rdir * bt + Tdif * denom * (src + alb * (Tdir * bt))
        alb, src = alb_n, src_n
    fd = torch.zeros_like(beam) if inc is None else inc
    up, dn = [None] * (nlay + 1), [None] * (nlay + 1)
    up[nlay], dn[nlay] = fd * alb + src, fd
    beam = beam_toa
    for l in range(nlay - 1, -1, -1):                      # 3.
        Rdir, Tdir, Rdif, Tdif, T0 = _coeffs(x, l, g)
        alb_l, src_l = s_alb[l], s_src[l]
        denom = 1.0 / (1.0 - Rdif * alb_l)
        fd = (Tdif * denom) * fd + denom * (Rdif * src_l + Tdir * beam)
        up[l], dn[l] = fd * alb_l + src_l, fd
        beam = beam * T0
    return torch.stack(up), torch.stack(dn), torch.stack(direct)


def _summed(per_gpt):
    up, dn_dif, direct = (f.sum(-1) for f in per_gpt)
    return up, dn_dif + direct, direct


def _rel(out, ref):
    err = max((a.double() - b.double()).abs().max().item() for a, b in zip(out, ref))
    return err / max(b.double().abs().max().item() for b in ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("with_inc", [True, False])
def test_sw_three_passes_equal_the_four_array_passes_bit_for_bit(dtype, with_g, with_inc):
    """Recomputing the coefficients in the adding and flux passes, and the
    beam in the flux pass, gives the four-array passes' bits per g-point
    (night columns too, whatever they hold), so the two-kernel SW route
    keeps the megakernel route's bits."""
    x = _sw_inputs(dtype)
    g, inc = (x["g"] if with_g else None), (x["inc"] if with_inc else None)
    for a, b in zip(_sw_three_passes(x, g, inc), _sw_four_arrays(x, g, inc)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_sw_three_passes_hold_the_twin(dtype, tol):
    """Summed over g-points, the three-pass model agrees with
    sw_2stream_reduced_ref (what chip_smoke.py holds the kernel against) on
    day columns, with and without g and incident flux."""
    x = _sw_inputs(dtype, night=False, seed=3)
    for g in (x["g"], None):
        for inc in (x["inc"], None):
            out = _summed(_sw_three_passes(x, g, inc))
            ref = rte_kernels.sw_2stream_reduced_ref(x["tau"], x["ssa"], g, x["mu0"], x["toa_gpt"], x["alb_dir"],
                                                     x["alb_dif"], x["gpt2band"], inc)
            assert _rel(out, ref) <= tol


@pytest.mark.parametrize("with_g", [True, False])
def test_sw_three_passes_hold_jax_sw_2stream(with_g):
    """The three-pass model per g-point against the JAX package's
    sw_2stream, rtol 2e-4 / atol 1e-3."""
    x = _sw_inputs(torch.float32, night=False, seed=4)
    g = x["g"] if with_g else None
    up, dn_dif, direct = _sw_three_passes(x, g, x["inc"])
    adir, adif, _ = _surface(x)
    J = lambda t: jnp.asarray(t.numpy())
    ref = jrte.sw_2stream(J(x["tau"]), J(x["ssa"]), J(x["g"]) if with_g else jnp.zeros(x["tau"].shape, jnp.float32),
                          J(x["mu0"])[:, None], J(x["toa_gpt"]), J(adir), J(adif), J(x["inc"]))
    for o, r in zip((up, dn_dif + direct, direct), ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4, atol=1e-3)


def test_sw_sweep_scratch_is_two_arrays():
    """sw_2stream_reduced's scratch: two distinct (nlay, ncol, ngpt) f32
    arrays, the beam (then the albedo in its slots) and the source."""
    scratch = rte_kernels.sw_sweep_scratch(5, 7, 9, "cpu")
    assert len(scratch) == 2 and scratch[0].data_ptr() != scratch[1].data_ptr()
    for t in scratch:
        assert t.shape == (5, 7, 9) and t.dtype == torch.float32


# ---------------------------------------------------------------------------
# sw_2stream_gpt: the three passes with the state in the outputs
# ---------------------------------------------------------------------------


def _sw_gpt_in_outputs(x, g, inc, kept=0):
    """sw_2stream_gpt's design, per g-point and in place: mu0 and the
    albedos per g-point, (ncol, ngpt); three preallocated (nlev, ncol, ngpt)
    outputs, NaN until written, hold the state. 1. top-down the beam of
    every level to ``direct``; 2. bottom-up adding, each layer's
    coefficients from tau, ssa, g and the beam at its top read back from
    ``direct[l + 1]``, the albedo and the source at level l written into
    ``up[l]`` and ``dn[l]`` (the bottom ``kept`` levels' into a store of
    their own, the kernel's shared memory); 3. top-down flux with the
    coefficients and the beam computed again (the beam *= T0 of pass 1),
    level l's albedo and source read back, then up = fd * alb + src and dn
    = fd + beam written. Returns (up, dn, direct); dn includes the direct
    beam."""
    tau, ssa = x["tau"], x["ssa"]
    nlay, ncol, ngpt = tau.shape
    adir, adif, _ = _surface(x)
    mu0 = x["mu0"][:, None].expand(ncol, ngpt)
    mu0_safe = torch.clamp(mu0, min=torch.finfo(tau.dtype).eps)
    up, dn, direct = (torch.full((nlay + 1, ncol, ngpt), torch.nan, dtype=tau.dtype) for _ in range(3))
    shared = {}
    coeffs = lambda l: sw_2stream_coeffs(tau[l], ssa[l], 0.0 if g is None else g[l], mu0)
    beam_toa = x["toa_gpt"] * mu0
    beam = beam_toa
    direct[nlay] = beam
    for l in range(nlay - 1, -1, -1):                      # 1.
        beam = beam * torch.exp(-tau[l] / mu0_safe)
        direct[l] = beam
    alb, src = adif, beam * adir
    for l in range(nlay):                                  # 2.
        bt = direct[l + 1]
        Rdir, Tdir, _, Rdif, Tdif = coeffs(l)
        if l < kept:
            shared[l] = (alb, src)
        else:
            up[l], dn[l] = alb, src
        denom = 1.0 / (1.0 - Rdif * alb)
        alb_n = Rdif + Tdif * Tdif * alb * denom
        src_n = Rdir * bt + Tdif * denom * (src + alb * (Tdir * bt))
        alb, src = alb_n, src_n
    fd = torch.zeros_like(beam) if inc is None else inc
    up[nlay], dn[nlay] = fd * alb + src, fd + beam_toa
    beam = beam_toa
    for l in range(nlay - 1, -1, -1):                      # 3.
        Rdir, Tdir, T0, Rdif, Tdif = coeffs(l)
        alb_l, src_l = shared[l] if l < kept else (up[l].clone(), dn[l].clone())
        denom = 1.0 / (1.0 - Rdif * alb_l)
        fd = (Tdif * denom) * fd + denom * (Rdif * src_l + Tdir * beam)
        beam = beam * T0
        up[l], dn[l] = fd * alb_l + src_l, fd + beam
    return up, dn, direct


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("with_inc", [True, False])
@pytest.mark.parametrize("kept", [0, 3, 8])
def test_sw_gpt_state_in_outputs_equals_the_four_array_passes_bit_for_bit(dtype, with_g, with_inc, kept):
    """The per-g-point sweep's three passes with its state in its outputs
    (none, 3 or all 8 bottom levels kept apart) give the four-array passes'
    bits (up; diffuse + direct down, the sum the four-array kernel formed;
    direct), night columns too."""
    x = _sw_inputs(dtype)
    g, inc = (x["g"] if with_g else None), (x["inc"] if with_inc else None)
    up, dn, direct = _sw_gpt_in_outputs(x, g, inc, kept)
    ref_up, ref_dn, ref_dir = _sw_four_arrays(x, g, inc)
    for a, b in ((up, ref_up), (dn, ref_dn + ref_dir), (direct, ref_dir)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("with_g", [True, False])
@pytest.mark.parametrize("with_inc", [True, False])
def test_sw_gpt_state_in_outputs_holds_jax_sw_2stream_pallas(with_g, with_inc):
    """The model against the JAX package's sw_2stream_pallas (interpret mode
    on the CPU, 24 columns in blocks of 8; its asymmetry is not optional, so
    g = None is held against zeros), rtol 2e-4 / atol 2e-4, the gate of
    tests/test_torch_sweeps.py for the same kernel."""
    from rrtmgp_tpu.ops import pallas_rte as jprte

    x = _sw_inputs(torch.float32, night=False, seed=6)
    g, inc = (x["g"] if with_g else None), (x["inc"] if with_inc else None)
    adir, adif, _ = _surface(x)
    ncol, ngpt = x["toa_gpt"].shape
    J = lambda t: jnp.asarray(t.contiguous().numpy())
    ref = jprte.sw_2stream_pallas(J(x["tau"]), J(x["ssa"]), J(x["g"] if with_g else torch.zeros_like(x["tau"])),
                                  J(x["mu0"][:, None].expand(ncol, ngpt)), J(x["toa_gpt"]), J(adir), J(adif),
                                  None if inc is None else J(inc), block_cols=8)
    for o, r in zip(_sw_gpt_in_outputs(x, g, inc, 3), ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# lw_noscat_gpt: the bottom layers' upward sources kept from the downward pass
# ---------------------------------------------------------------------------


def _lw_gpt_inputs(dtype, ncol=16, nlay=6, ngpt=12, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.5, hi=1.5: torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)
    tau = torch.from_numpy(np.abs(rng.normal(0.4, 0.2, (nlay, ncol, ngpt)))).to(dtype)
    tau[0, :, :3] = 1e-7  # below the Clough threshold: the series branch
    return dict(tau=tau, lay=f(nlay, ncol, ngpt), lev=f(nlay + 1, ncol, ngpt), sfc=f(ncol, ngpt),
                emis=f(ncol, ngpt, lo=0.9, hi=1.0), inc=f(ncol, ngpt, lo=0.0, hi=0.3))


def _lw_gpt_cached(x, ds, w_mu, inc, cache):
    """lw_noscat_gpt's design with ``cache`` layers kept (a column of fewer
    whole): the downward pass forms each layer's transmittance and Clough
    factor and, for the bottom C layers, also the upward source from the
    level source of the layer's top, held from the iteration before (read
    before the loop for the top layer when the column is held whole); the
    upward pass takes those C layers from the cache and recomputes the
    rest from tau and the sources. Expressions of ops.rte.lw_noscat."""
    tau, lay, lev = x["tau"], x["lay"], x["lev"]
    dtype, nlay = tau.dtype, tau.shape[0]
    c = min(cache, nlay)
    tau_thresh = 100.0 * torch.finfo(dtype).eps
    i2f, ds = rte_intensity_to_flux(w_mu, dtype), round_to(ds, dtype)

    def trans_fact(l):
        tau_loc = tau[l] * ds
        trans = torch.exp(-tau_loc)
        big = tau_loc > tau_thresh
        fact = torch.where(big, (1.0 - trans) / torch.where(big, tau_loc, 1.0) - trans,
                           tau_loc * (0.5 + tau_loc * (-1.0 / 3.0 + tau_loc * 0.125)))
        return trans, fact

    emission = lambda trans, fact, lay_val, lev_val: (1.0 - trans) * lev_val + 2.0 * fact * (lay_val - lev_val)
    i_dn = [None] * (nlay + 1)
    i_dn[nlay] = torch.zeros_like(lev[0]) if inc is None else inc / i2f
    cached = {}
    lev_top = lev[nlay] if nlay <= c else None
    for l in range(nlay - 1, -1, -1):
        trans, fact = trans_fact(l)
        i_dn[l] = trans * i_dn[l + 1] + emission(trans, fact, lay[l], lev[l])
        if l < c:
            cached[l] = (trans, emission(trans, fact, lay[l], lev_top))
        lev_top = lev[l]
    i_up = [i_dn[0] * (1.0 - x["emis"]) + x["emis"] * x["sfc"]]
    for l in range(nlay):
        if l < c:
            trans, s_up = cached[l]
        else:
            trans, fact = trans_fact(l)
            s_up = emission(trans, fact, lay[l], lev[l + 1])
        i_up.append(trans * i_up[l] + s_up)
    assert len(cached) == c
    return torch.stack(i_up) * i2f, torch.stack(i_dn) * i2f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_inc", [True, False])
@pytest.mark.parametrize("cache", ["0", "1", "half", "all", "more"])
def test_lw_gpt_cached_layers_equal_the_twin_bit_for_bit(dtype, with_inc, cache):
    """Taking the bottom C layers' transmittance and upward source from the
    downward pass gives the twin's bits (C = 0, 1, nlay // 2, nlay and
    nlay + 3, which holds the column whole)."""
    x = _lw_gpt_inputs(dtype)
    nlay = x["tau"].shape[0]
    c = {"0": 0, "1": 1, "half": nlay // 2, "all": nlay, "more": nlay + 3}[cache]
    inc = x["inc"] if with_inc else None
    out = _lw_gpt_cached(x, 1.66, 0.5, inc, c)
    ref = rte_kernels.lw_noscat_gpt_ref(x["tau"], x["lay"], x["lev"], x["sfc"], x["emis"], 1.66, 0.5, inc)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("with_inc", [True, False])
def test_lw_gpt_cached_layers_hold_jax_lw_noscat_pallas(with_inc):
    """The model (half the column cached) against the JAX package's
    lw_noscat_pallas (interpret mode, 16 columns in blocks of 8), rtol 2e-5
    / atol 1e-5, tests/test_torch_sweeps.py's gate for the same kernel."""
    from rrtmgp_tpu.ops import pallas_rte as jprte

    x = _lw_gpt_inputs(torch.float32)
    inc = x["inc"] if with_inc else None
    J = lambda t: jnp.asarray(t.numpy())
    ref = jprte.lw_noscat_pallas(J(x["tau"]), J(x["lay"]), J(x["lev"]), J(x["sfc"]), J(x["emis"]), 1.66, 0.5,
                                 None if inc is None else J(inc), block_cols=8)
    for o, r in zip(_lw_gpt_cached(x, 1.66, 0.5, inc, x["tau"].shape[0] // 2), ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# interp_pt_eta: staged 32-bit corner offsets with the last-slab guard
# ---------------------------------------------------------------------------


def _staged_interp(table, jtemp, ftemp, jpress, fpress, jeta1, feta1, jeta2, feta2, gpt2band,
                   col_mix1=None, col_mix2=None):
    """interp_pt_eta's design: per (layer, column, band) the corner offsets
    b1 = ((jp*ntemp + jt)*neta + je1)*ngpt and b2 (jt+1, je2) in int32, the
    weights' complements formed once; per point the eight gathers at b +
    g, + ngpt (eta) and + ntemp*neta*ngpt (pressure), the upper node only
    where the table has a slab above, then the kernel's operation order."""
    n_p, ntemp, neta, ngpt = table.shape
    flat = table.reshape(-1)
    sp, se = ntemp * neta * ngpt, ngpt
    i32 = torch.int32
    jp, jt = jpress[..., None].to(i32), jtemp[..., None].to(i32)
    b1 = ((jp * ntemp + jt) * neta + jeta1.to(i32)) * ngpt                 # (nlay, ncol, nbnd)
    b2 = ((jp * ntemp + jt + 1) * neta + jeta2.to(i32)) * ngpt
    wide = ((jpress[..., None].long() * ntemp + jtemp[..., None].long()) * neta + jeta1.long()) * ngpt
    assert torch.equal(b1.long(), wide)  # the table's < 2^31 elements keep every offset in 32 bits
    above = (jpress + 1 < n_p)[..., None]                                   # staged per (layer, column)
    omft, omfp = 1.0 - ftemp, 1.0 - fpress
    omfe1, omfe2 = 1.0 - feta1, 1.0 - feta2
    one = torch.ones_like(feta1)
    cm1, cm2 = (one, one) if col_mix1 is None else (col_mix1, col_mix2)
    band = gpt2band.long()
    g = torch.arange(ngpt, dtype=i32)
    per_point = lambda t: t[..., band]                                      # a thread's band
    fp, op = fpress[..., None], omfp[..., None]

    def p_blend(base):
        lo = flat[base.long()]
        hi = torch.where(above, flat[torch.where(above, base + sp, base).long()], 0.0)
        return op * lo + fp * hi

    def node(b, fe, omfe):
        base = per_point(b) + g
        return p_blend(base) * per_point(omfe) + p_blend(base + se) * per_point(fe)

    v0 = node(b1, feta1, omfe1)
    v1 = node(b2, feta2, omfe2)
    return omft[..., None] * (v0 * per_point(cm1)) + ftemp[..., None] * (v1 * per_point(cm2))


def _interp_cases(ngpt, nbnd, ncol=19, nlay=6):
    """(label, interp_pt_eta arguments) of the four tables of the unfused
    optics (LW kmajor with col_mix, LW Planck fraction, SW kmajor with
    col_mix, SW Rayleigh at the troposphere side with fpress = 0)."""
    cases = []
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device="cpu")
    for wave, seed, inputs in (("LW", 0, mega_lw_inputs), ("SW", 1, mega_sw_inputs)):
        lkp = synthetic_gas_lookup(longwave=wave == "LW", n_gpt=ngpt, n_bnd=nbnd, seed=seed, dtype=np.float32,
                                   device="cpu")
        inp, tabs = inputs(lkp, atm), lkp.kernel_tables
        eta = (inp.jeta1, inp.feta1, inp.jeta2, inp.feta2, tabs.gpt2band)
        cases.append((f"{wave} kmajor", (tabs.kmajor, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress, *eta,
                                         inp.col_mix1, inp.col_mix2)))
        if wave == "LW":
            cases.append(("LW Planck fraction", (tabs.second, inp.jtemp, inp.ftemp, inp.jpress_base, inp.fpress,
                                                 *eta)))
        else:
            side = (~inp.tropo_lower).to(torch.int32)
            assert int(side.min()) == 0 and int(side.max()) == 1  # both sides of the 2-slab table
            cases.append(("SW Rayleigh", (tabs.second, inp.jtemp, inp.ftemp, side, torch.zeros_like(inp.fpress),
                                          *eta)))
    return cases


@pytest.mark.parametrize("ngpt,nbnd", [(36, 4), (256, 16), (1100, 4)])
def test_staged_interp_equals_the_twin_bit_for_bit(ngpt, nbnd):
    """The staged-offset model equals interp_pt_eta_ref on each table the
    unfused optics read, the Rayleigh table at side 1 of its two slabs
    included (no slab above: the upper node enters as 0)."""
    for label, args in _interp_cases(ngpt, nbnd):
        assert torch.equal(_staged_interp(*args), interp.interp_pt_eta_ref(*args)), label


def test_staged_interp_guard_on_the_last_slab_with_weight():
    """Cells on a table's last pressure slab with a nonzero pressure weight:
    the node above is not read (the model indexes nothing past the table)
    and contributes fpress * 0, as in the twin; with col_mix and without."""
    rng = np.random.default_rng(11)
    n_p, ntemp, neta, ngpt, nbnd, nlay, ncol = 3, 5, 6, 12, 3, 4, 9
    T = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    table = T(rng.uniform(0.1, 2.0, (n_p, ntemp, neta, ngpt)))
    jpress = T(rng.integers(0, n_p, (nlay, ncol)), torch.int32)
    jpress[0] = n_p - 1
    args = (table, T(rng.integers(0, ntemp - 1, (nlay, ncol)), torch.int32), T(rng.uniform(0, 1, (nlay, ncol))),
            jpress, T(rng.uniform(0.1, 1, (nlay, ncol))),
            T(rng.integers(0, neta - 1, (nlay, ncol, nbnd)), torch.int32), T(rng.uniform(0, 1, (nlay, ncol, nbnd))),
            T(rng.integers(0, neta - 1, (nlay, ncol, nbnd)), torch.int32), T(rng.uniform(0, 1, (nlay, ncol, nbnd))),
            T(np.arange(ngpt) * nbnd // ngpt, torch.int32))
    mix = (T(rng.uniform(0.5, 2, (nlay, ncol, nbnd))), T(rng.uniform(0.5, 2, (nlay, ncol, nbnd))))
    for extra in ((), mix):
        out = _staged_interp(*args, *extra)
        assert torch.equal(out, interp.interp_pt_eta_ref(*args, *extra))
        assert torch.isfinite(out).all()


def test_tables_of_2_31_elements_are_refused():
    """The staged kernels index a table with 32-bit offsets: the check
    refuses 2^31 elements (a broadcast tensor, no memory behind it) and
    takes one fewer; interp_pt_eta makes it before any other."""
    _launch.check_table_size("t", torch.zeros(1).expand(2**31 - 1))
    big = torch.zeros(1, 1, 1, 1).expand(2, 2**14, 2**8, 2**8)
    with pytest.raises(ValueError, match="32-bit"):
        _launch.check_table_size("kmajor", big)
    args = _interp_cases(36, 4)[0][1]
    assert interp.interp_pt_eta_dims(torch.device("cpu"), *args) == (6, 19, 36, 4, *args[0].shape[:3])
    with pytest.raises(ValueError, match="32-bit"):
        interp.interp_pt_eta_dims(torch.device("cpu"), big, *args[1:])


def test_entry_points_take_what_their_signatures_list():
    """Each C entry point of csrc/ takes as many parameters as its ctypes
    signature in ops/_build.py lists (several of them changed with the
    designs above: interp_minor's launch plan and tile, lw_noscat_banded's
    angles), and each shared-memory query as many int parameters as
    ``SIZE_QUERIES`` lists (interp_minor's is new)."""
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", sources)
        assert m, entry
        assert len(m.group(1).split(",")) == len(argtypes), entry
    assert "rrtmgp_interp_minor_smem" in _build.SIZE_QUERIES
    for entry, n_args in _build.SIZE_QUERIES.items():
        m = re.search(r'extern "C" long long ' + entry + r"\(([^)]*)\)", sources)
        assert m, entry
        params = m.group(1).split(",")
        assert len(params) == n_args and all(p.split()[0] == "int" for p in params), entry
    banded = re.search(r'extern "C" int rrtmgp_lw_noscat_banded\(([^)]*)\)', sources).group(1)
    assert "int nang, const void* ds, const void* i2f" in " ".join(banded.split())


# ---------------------------------------------------------------------------
# interp_minor: the staged minor-gas layout of optics_fused
# ---------------------------------------------------------------------------


def _staged_minor(inp, tabs):
    """interp_minor's design: per (layer, column, band) the two kminor rows
    m1 = jt*neta + je1 and m2 = (jt+1)*neta + je2 in int32 and the eta
    weights' complements, per (layer, column) the temperature weight's and
    the troposphere side, per interval its band and kminor base; a thread
    per g-point reads its ranges of minor_list once and, per cell, adds the
    intervals of the cell's side in their order from 0, in the operation
    order of gather.cuh's staged_tau_minor."""
    kminor = tabs.kminor.reshape(-1)
    ntemp, neta, ncontrib = tabs.kminor.shape
    i32 = torch.int32
    jt = inp.jtemp[..., None].to(i32)
    m1 = jt * neta + inp.jeta1.to(i32)                                       # (nlay, ncol, nbnd)
    m2 = (jt + 1) * neta + inp.jeta2.to(i32)
    omfe1, omfe2 = 1.0 - inp.feta1, 1.0 - inp.feta2
    ft, omft, lower = inp.ftemp, 1.0 - inp.ftemp, inp.tropo_lower
    start, entries = tabs.minor_start.tolist(), tabs.minor_list.tolist()
    mband, mkbase = tabs.minor_band.tolist(), tabs.minor_kbase.tolist()
    ngpt = tabs.minor_start.shape[1] - 1
    out = torch.empty(inp.jtemp.shape + (ngpt,), dtype=inp.ftemp.dtype)
    for g in range(ngpt):
        per_side = []
        for side in (0, 1):
            tau = torch.zeros_like(ft)
            for i in entries[start[side][g]:start[side][g + 1]]:
                b, base = mband[i], mkbase[i] + g
                row = lambda m: kminor[(base + m[..., b].long() * ncontrib)]
                v1 = omfe1[..., b] * row(m1) + inp.feta1[..., b] * row(m1 + 1)
                v2 = omfe2[..., b] * row(m2) + inp.feta2[..., b] * row(m2 + 1)
                tau = tau + (omft * v1 + ft * v2) * inp.minor_scaling[i]
            per_side.append(tau)
        out[..., g] = torch.where(lower, per_side[0], per_side[1])
    return out


def _rich_minor_lookup(longwave, ngpt, nbnd, n_per_side, seed, dtype):
    """A synthetic lookup with n_per_side minor intervals a side, each over
    a whole band of uneven width, so that several cover a g-point."""
    import dataclasses

    from rrtmgp_tpu_torch.data.lookups import MinorInterval

    lkp = synthetic_gas_lookup(longwave=longwave, n_gpt=ngpt, n_bnd=nbnd, seed=seed, dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed + 40)
    edges = [0, *np.sort(rng.choice(np.arange(1, ngpt), nbnd - 1, replace=False)).tolist(), ngpt]
    lims = tuple(zip(edges[:-1], edges[1:]))

    def side():
        intervals, rows, k0 = [], [], 0
        for _ in range(n_per_side):
            g0, g1 = lims[int(rng.integers(nbnd))]
            intervals.append(MinorInterval(int(rng.choice([2, 3, 4, 5, 6])), int(rng.integers(2)),
                                           bool(rng.integers(2)), bool(rng.integers(2)), g0, g1, k0))
            rows.append(rng.uniform(1e-25, 5e-24, (g1 - g0, lkp.n_temp, lkp.n_eta)))
            k0 += g1 - g0
        return tuple(intervals), torch.from_numpy(np.concatenate(rows).astype(dtype))

    (lower, k_lower), (upper, k_upper) = side(), side()
    return dataclasses.replace(lkp, bnd_lims_gpt=lims, minor_lower=lower, kminor_lower=k_lower,
                               minor_upper=upper, kminor_upper=k_upper)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ngpt,nbnd", [(32, 4), (36, 3)])
@pytest.mark.parametrize("rich", [False, True])
def test_staged_minor_equals_the_twin_bit_for_bit(dtype, ngpt, nbnd, rich):
    """The staged minor-gas model equals interp_minor_ref bit for bit, LW
    and SW, with cells on both troposphere sides, on the synthetic lookup
    (three intervals a side) and on one where six intervals a side cover
    whole bands of uneven width: the twin adds every interval with its
    scaling zeroed off its side, the kernel only the cell's side's, in the
    same order."""
    atm = synthetic_atmosphere(ncol=19, nlay=6, dtype=dtype, device="cpu")
    for longwave, inputs in ((True, mega_lw_inputs), (False, mega_sw_inputs)):
        seed = 0 if longwave else 1
        lkp = (_rich_minor_lookup(longwave, ngpt, nbnd, 6, seed, dtype) if rich else
               synthetic_gas_lookup(longwave=longwave, n_gpt=ngpt, n_bnd=nbnd, seed=seed, dtype=dtype,
                                    device="cpu"))
        inp, tabs = inputs(lkp, atm), lkp.kernel_tables
        assert 0 < int(inp.tropo_lower.sum()) < inp.tropo_lower.numel()  # both sides present
        if rich:
            covers = tabs.minor_start[:, 1:] - tabs.minor_start[:, :-1]
            assert int(covers.max()) >= 2  # several intervals cover a g-point
        out = _staged_minor(inp, tabs)
        assert out.dtype == inp.ftemp.dtype and bool((out > 0).any())
        assert torch.equal(out, interp.interp_minor_ref(inp, tabs)), (longwave, ngpt)


# ---------------------------------------------------------------------------
# lw_noscat_banded: every quadrature angle in one launch
# ---------------------------------------------------------------------------


def _banded_inputs(seed=11, nlay=6, ncol=12, ngpt=32, nbnd=4):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.5, hi=1.5: rng.uniform(lo, hi, shape).astype(np.float32)
    tau = np.abs(rng.normal(0.4, 0.2, (nlay, ncol, ngpt))).astype(np.float32)
    tau[0, :, :3] = 1e-7  # below the Clough threshold: the series branch
    x = dict(tau=tau, pfrac=f(nlay, ncol, ngpt, lo=0.01, hi=0.2), plk_lay=f(nlay, ncol, nbnd),
             plk_lev=f(nlay + 1, ncol, nbnd), plk_sfc=f(ncol, nbnd), emis=f(nbnd, ncol, lo=0.9, hi=1.0),
             inc=f(ncol, ngpt, lo=0.0, hi=0.3))
    g2b = (np.arange(ngpt) * nbnd // ngpt).astype(np.int32)
    return x, g2b


def _angles(n):
    from rrtmgp_tpu_torch.angular import angular_discretization

    Ds, wts = angular_discretization(n)
    return [float(d) for d in Ds], [float(w) for w in wts]


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
@pytest.mark.parametrize("with_inc", [False, True])
def test_banded_angles_equal_the_per_angle_twin_sum_bit_for_bit(n_angles, with_inc):
    """On CPU tensors the multi-angle wrapper is the one-angle twin per
    angle, angle k with the incident flux inc * w_k, added in the angles'
    order (the sum the solves made before): bit for bit, with no launch."""
    x, g2b = _banded_inputs()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["tau"], t["pfrac"], t["plk_lay"], t["plk_lev"], t["plk_sfc"], t["emis"], torch.from_numpy(g2b))
    inc = t["inc"] if with_inc else None
    ds, w = _angles(n_angles)
    rte_kernels.lw_noscat_banded_reduced.launches = 0
    out = rte_kernels.lw_noscat_banded_angles(*args, ds, w, inc)
    up = dn = None
    for d, wk in zip(ds, w):
        u, v = rte_kernels.lw_noscat_banded_reduced_ref(*args, d, wk, None if inc is None else inc * wk)
        up, dn = (u, v) if up is None else (up + u, dn + v)
    assert torch.equal(out[0], up) and torch.equal(out[1], dn)
    assert torch.equal(out[0], rte_kernels.lw_noscat_banded_angles_ref(*args, ds, w, inc)[0])
    assert rte_kernels.lw_noscat_banded_reduced.launches == 0
    if not with_inc:
        assert torch.all(out[1][-1] == 0.0)


@pytest.mark.parametrize("n_angles", [1, 3, 4])
@pytest.mark.parametrize("with_inc", [False, True])
def test_banded_angles_hold_jax_per_angle_sum(n_angles, with_inc):
    """The multi-angle wrapper against the JAX lw_noscat_banded_reduced (its
    Pallas kernel in interpret mode) called per angle with the incident flux
    split by weight and summed, as the JAX solve does: rtol 2e-5 / atol
    1e-3, the LW sweep's tolerances against the JAX Pallas sweep."""
    from rrtmgp_tpu.ops import pallas_rte as jprte

    x, g2b = _banded_inputs(seed=12)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    lims = tuple((int(np.argmax(g2b == b)), int(np.argmax(g2b == b)) + int((g2b == b).sum())) for b in range(4))
    ds, w = _angles(n_angles)
    ref_up = ref_dn = 0.0
    for d, wk in zip(ds, w):
        inc_k = j["inc"] * np.float32(wk) if with_inc else None
        u, v = jprte.lw_noscat_banded_reduced(j["tau"], j["pfrac"], j["plk_lay"], j["plk_lev"], j["plk_sfc"],
                                              j["emis"].T, d, wk, lims, inc_k, block_cols=8)
        ref_up, ref_dn = ref_up + np.asarray(u), ref_dn + np.asarray(v)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = rte_kernels.lw_noscat_banded_angles(t["tau"], t["pfrac"], t["plk_lay"], t["plk_lev"], t["plk_sfc"],
                                              t["emis"], torch.from_numpy(g2b), ds, w,
                                              t["inc"] if with_inc else None)
    for o, r in zip(out, (ref_up, ref_dn)):
        assert o.shape == (7, 12)
        np.testing.assert_allclose(o.numpy(), r, rtol=2e-5, atol=1e-3)


H100_OPTIN = 232448  # an H100's opt-in shared memory per block, as the wrappers read it there


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
def test_banded_plan_counts_two_fields_per_angle(monkeypatch, n_angles):
    """The launch plan of a K12 or K13 launch (``angles_plan``, one plan)
    counts 2 x nang level-sum fields for the shared memory, the in-block
    decision and the device partials: at 60
    layers every angle count keeps its sums in the block; at 2000 layers x
    256 g-points one angle's sums (2 x 2001 x 8 floats, 128 KB) still fit
    the block, two angles' or more do not and go to device memory, one (2
    x nang, nlev, ncol, warps) buffer; at 3700 layers every angle count
    does. The plan asks for the kernel's block limit of its angle count
    (1024 here, as both kernels have on an H100)."""
    monkeypatch.setattr(_launch, "smem_limit", lambda dev: H100_OPTIN)
    monkeypatch.setattr(_launch, "max_threads", lambda kernel, dev, variant=0: 1024)
    cpu = torch.device("cpu")
    for kernel in ("lw_noscat_banded", "lw_noscat_reduced"):
        assert rte_kernels.angles_plan(kernel, n_angles, 60, 5, 256, cpu) == ((256, 1, 1), None)
    for nlay, in_block in ((2000, n_angles == 1), (3700, False)):
        assert (2 * n_angles * (nlay + 1) * 8 * 4 <= H100_OPTIN) == in_block
        groups, partials = rte_kernels.angles_plan("lw_noscat_banded", n_angles, nlay, 3, 256, cpu)
        assert groups == (256, 1, int(in_block)), (nlay, n_angles)
        if in_block:
            assert partials is None
        else:
            assert partials.shape == (2 * n_angles, nlay + 1, 3, 8)


def _warp_add(v):
    """common.cuh LevelSumsT::add over one warp, lane 0's total: v +=
    shfl_down(v, o) for o = 16, 8, 4, 2, 1. v: (32,) per lane."""
    v = v.clone()
    for o in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[o:], torch.zeros_like(v[:o])])
    return v[0]


def _warp_add_fields(vals):
    """common.cuh add_fields over one warp: vals (K, 32), field k of lane i.
    Returns each field's total as the lane that stores it holds it."""
    K = vals.shape[0]
    P = 2 if K <= 2 else 4
    a = torch.cat([vals, torch.zeros((P - K, 32), dtype=vals.dtype)])     # (P, lane)
    lane = torch.arange(32)
    xor = lambda x, bit: x[lane ^ bit]
    upper = (lane & 16) != 0
    send = [torch.where(upper, a[j], a[j + P // 2]) for j in range(P // 2)]
    keep = [torch.where(upper, a[j + P // 2], a[j]) for j in range(P // 2)]
    a = [k + xor(s, 16) for k, s in zip(keep, send)]
    if P == 4:
        upper = (lane & 8) != 0
        a = [torch.where(upper, a[1], a[0]) + xor(torch.where(upper, a[0], a[1]), 8)]
    x = a[0]
    bit = 16 // P
    while bit:
        x = x + xor(x, bit)
        bit //= 2
    k = lane >> 4 if P == 2 else ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1)
    leaders = [(int(i), int(k[i])) for i in range(32) if i % (32 // P) == 0 and k[i] < K]
    assert sorted(f for _, f in leaders) == list(range(K))  # one store per field
    return {f: x[i] for i, f in leaders}


@pytest.mark.parametrize("n_fields", [2, 3, 4])
@pytest.mark.parametrize("idle", [0, 7])
def test_transposed_warp_sums_have_the_shuffle_tree_bits(n_fields, idle):
    """lw_noscat_banded reduces a level's angles together (add_fields: over
    lane bit 4, and bit 3 for 3-4 fields, the lanes swap the fields they do
    not keep, then a butterfly): each field's total equals add()'s
    shuffle-down tree bit for bit, in f32 and f64, with idle lanes adding
    zeros. (One field is add() itself.) Another tree, the butterfly's bits
    taken 1, 2, 4, gives other bits on these values."""
    rng = np.random.default_rng(n_fields + idle)
    for dtype in (torch.float32, torch.float64):
        vals = torch.from_numpy(rng.lognormal(0.0, 3.0, (n_fields, 32))).to(dtype)
        if idle:
            vals[:, -idle:] = 0.0
        got = _warp_add_fields(vals)
        for f in range(n_fields):
            assert torch.equal(got[f], _warp_add(vals[f])), (f, dtype)
    # the check has power: another tree differs on some of a few draws
    lane = torch.arange(32)
    other = lambda v: functools.reduce(lambda x, bit: x + x[lane ^ bit], (1, 2, 4, 8, 16), v)[0]
    draws = [torch.from_numpy(rng.lognormal(0.0, 3.0, (n_fields, 32))).float() for _ in range(8)]
    assert any(not torch.equal(other(v[f]), _warp_add_fields(v)[f]) for v in draws for f in range(n_fields))


# ---------------------------------------------------------------------------
# sw_clear_mega: the staged SW chunks
# ---------------------------------------------------------------------------


def _staged_sw_chunks(inp, tabs, chunk, comp=None):
    """sw_clear_mega's optics loop: chunks of ``chunk`` layers from the top,
    slot j of a chunk holding layer top - j (the last chunk short); per
    (layer, column, band) set_band<R, true>'s int32 kmajor corners b1, b2,
    Rayleigh corners r1, r2 of the troposphere side, the eta weights and
    their complements; per (layer, column) the temperature and pressure
    weights, col_dry and the Rayleigh amount; a g-point reads its band's
    record and adds the other corners as fixed strides, in the operation
    order of gather.cuh (staged_tau_major + staged_tau_minor +
    staged_tau_rayleigh, then max 0 and ssa = ray / tau). With ``comp`` (a
    cloud mask given, aerosols) the increments of allsky.cuh follow in
    their order, from the staged band properties: clouds (nlay, ncol,
    nbnd), aerosols (nlay, nbnd, ncol) read ncol apart. Returns (tau, ssa,
    g, the layers in the order visited)."""
    from rrtmgp_tpu_torch.ops.cloud_optics import increment_2stream

    lkp = tabs.lkp
    ngpt, ntemp, neta = lkp.n_gpt, lkp.n_temp, lkp.n_eta
    nlay = inp.nlay
    i32 = torch.int32
    kmajor, rayl = tabs.kmajor.reshape(-1), tabs.second.reshape(-1)
    sp, se = ntemp * neta * ngpt, ngpt
    assert tabs.kmajor.numel() < 2**31 and tabs.second.numel() < 2**31
    g2b, gidx = tabs.gpt2band.long(), torch.arange(ngpt, dtype=i32)
    minor = _staged_minor(inp, tabs)  # gather.cuh staged_tau_minor, per (layer, column, g-point)
    tau, ssa = torch.empty_like(minor), torch.empty_like(minor)
    gg = torch.zeros_like(minor)
    order = []
    for k in range(-(-nlay // chunk)):
        top = nlay - 1 - k * chunk
        for j in range(min(chunk, top + 1)):
            l = top - j
            order.append(l)
            jt, jp = inp.jtemp[l].to(i32)[:, None], inp.jpress_base[l].to(i32)[:, None]
            side = torch.where(inp.tropo_lower[l], 0, 1).to(i32)[:, None]
            je1, je2 = inp.jeta1[l].to(i32), inp.jeta2[l].to(i32)  # (ncol, nbnd)
            b1, b2 = ((jp * ntemp + jt) * neta + je1) * ngpt, ((jp * ntemp + jt + 1) * neta + je2) * ngpt
            r1, r2 = ((side * ntemp + jt) * neta + je1) * ngpt, ((side * ntemp + jt + 1) * neta + je2) * ngpt
            band = lambda x: x[:, g2b]  # the thread's band's staged value, (ncol, ngpt)
            at = lambda t, off: t[(band(off) + gidx).long()]
            fe1, fe2 = band(inp.feta1[l]), band(inp.feta2[l])
            omfe1, omfe2 = band(1.0 - inp.feta1[l]), band(1.0 - inp.feta2[l])
            ft, fp = inp.ftemp[l][:, None], inp.fpress[l][:, None]
            omft, omfp = 1.0 - ft, 1.0 - fp

            def p_eta(t, o, om, f):
                a = omfp * at(t, o) + fp * at(t, o + sp)
                bb = omfp * at(t, o + se) + fp * at(t, o + se + sp)
                return a * om + bb * f

            v0, v1 = p_eta(kmajor, b1, omfe1, fe1), p_eta(kmajor, b2, omfe2, fe2)
            major = (omft * (v0 * band(inp.col_mix1[l])) + ft * (v1 * band(inp.col_mix2[l]))) * inp.col_dry[l][:, None]
            ray0 = at(rayl, r1) * omfe1 + at(rayl, r1 + se) * fe1
            ray1 = at(rayl, r2) * omfe2 + at(rayl, r2 + se) * fe2
            ray = (omft * ray0 + ft * ray1) * inp.ray_factor[l][:, None]
            t = torch.clamp(major + minor[l] + ray, min=0.0)
            w = torch.where(t > 0.0, ray / torch.where(t > 0.0, t, 1.0), 0.0)
            g = torch.zeros_like(t)
            if comp is not None:
                ct, cw, cg = (band(x[l]) for x in comp.cld_bands)
                m = comp.cld_mask[l]
                nt, nw, ng = increment_2stream(t, w, g, ct, cw, cg)
                t, w, g = torch.where(m, nt, t), torch.where(m, nw, w), torch.where(m, ng, g)
                at_, aw, ag = (x[l].T[:, g2b] for x in comp.aero_bands)  # (nbnd, ncol): a column's ncol apart
                m = comp.aero_mask[l][:, None]
                nt, nw, ng = increment_2stream(t, w, g, at_, aw, ag)
                t, w, g = torch.where(m, nt, t), torch.where(m, nw, w), torch.where(m, ng, g)
            tau[l], ssa[l], gg[l] = t, w, g
    return tau, ssa, gg, order


def _sw_allsky(ngpt, nbnd, ncol=7, nlay=13):
    """A SW lookup, an atmosphere with fractional clouds and aerosols in
    every layer, and the all-sky Composition (cloud mask given, aerosols) as
    solve_sw builds it for sw_clear_mega, all numpy-seeded on the CPU."""
    import dataclasses

    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup
    from rrtmgp_tpu_torch.models.rrtmgp import _kernel_composition
    from rrtmgp_tpu_torch.ops.cloud_optics import build_cloud_mask_mcica

    sw = synthetic_gas_lookup(longwave=False, n_gpt=ngpt, n_bnd=nbnd, seed=1, dtype=np.float32, device="cpu")
    atm = synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float32, device="cpu", with_clouds=True,
                               with_aerosols=True)
    rng = np.random.default_rng(31)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))
    cs = atm.cloud_state
    atm = dataclasses.replace(
        atm, cloud_state=dataclasses.replace(cs, cld_frac=(cs.cld_frac * u(0.2, 1.0, nlay, ncol)).contiguous()),
        aerosol_state=dataclasses.replace(atm.aerosol_state, aero_mass=u(0.0, 2e-5, 15, nlay, ncol)))
    kw = dict(n_bnd=nbnd, dtype=np.float32, device="cpu")
    mask = build_cloud_mask_mcica(atm.cloud_state.cld_frac, ngpt, 9, 100)
    comp = _kernel_composition(sw, atm, synthetic_cloud_lookup(seed=5, **kw), synthetic_aerosol_lookup(seed=6, **kw),
                               mask, None, 100, None, True, False)[0]
    return sw, atm, comp


@pytest.mark.parametrize("ngpt,nbnd", [(36, 4), (224, 14)])
def test_staged_sw_chunks_equal_the_twin_bit_for_bit(ngpt, nbnd):
    """The staged SW chunks at 13 layers (a chunk of 8, then a short one of
    5) visit every layer once, top-down, as the McICA recurrence needs; their
    tau and ssa equal optics_fused_ref bit for bit, clear; composed with a
    cloud mask and aerosols in every layer they equal the twin's
    composition (ops.mega._compose_ref) bit for bit."""
    from rrtmgp_tpu_torch.ops import mega

    sw, atm, comp = _sw_allsky(ngpt, nbnd)
    inp, tabs = mega_sw_inputs(sw, atm), sw.kernel_tables
    assert inp.nlay % mega.SW_CHUNK and 0 < int(inp.tropo_lower.sum()) < inp.tropo_lower.numel()
    assert comp.cld_mask.any() and comp.aero_mask.all()
    tau, ssa, g, order = _staged_sw_chunks(inp, tabs, mega.SW_CHUNK)
    assert order == list(range(inp.nlay - 1, -1, -1))
    ref_tau, ref_ssa = interp.optics_fused_ref(inp, tabs)
    assert torch.equal(tau, ref_tau) and torch.equal(ssa, ref_ssa) and not bool(g.any())
    assert bool((ssa > 0).any())
    tau_c, ssa_c, g_c, _ = _staged_sw_chunks(inp, tabs, mega.SW_CHUNK, comp)
    want = mega._compose_ref(comp, sw, ref_tau, ref_ssa, torch.zeros_like(ref_tau))
    for out, ref in zip((tau_c, ssa_c, g_c), want[:3]):
        assert torch.equal(out, ref)
    assert not torch.equal(tau_c, tau) and bool((g_c > 0).any())


@pytest.mark.parametrize("with_inc", [False, True])
def test_sw_mega_clear_recomputed_passes_equal_the_four_array_passes(with_inc):
    """sw_clear_mega's clear-sky state: the staged optics pass stores tau,
    ssa and the beam, and the adding and flux passes recompute the
    coefficients (sw_2stream_reduced's passes); per g-point that gives the
    bits of the four-array passes that the all-sky variants keep, night
    columns included, and summed over g-points it holds the kernel's twin
    sw_clear_mega_ref (1e-5, the three-pass model's tolerance above)."""
    from rrtmgp_tpu_torch.ops import mega

    sw, atm, _ = _sw_allsky(36, 4, ncol=12)
    inp, tabs = mega_sw_inputs(sw, atm), sw.kernel_tables
    tau, ssa, _, _ = _staged_sw_chunks(inp, tabs, mega.SW_CHUNK)
    x = _sw_inputs(torch.float32, ncol=12, nlay=inp.nlay, ngpt=36, nbnd=4, seed=5)
    x.update(tau=tau, ssa=ssa, gpt2band=tabs.gpt2band, toa_gpt=x["toa_gpt"] * sw.solar_src_scaled[None, :])
    inc = x["inc"] if with_inc else None
    for a, b in zip(_sw_three_passes(x, None, inc), _sw_four_arrays(x, None, inc)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    day = x["mu0"] > 0
    out = _summed(_sw_three_passes(x, None, inc))
    ref = mega.sw_clear_mega_ref(inp, tabs, x["mu0"], x["toa_gpt"], x["alb_dir"], x["alb_dif"], inc)
    assert _rel([o[:, day] for o in out], [r[:, day] for r in ref]) <= 1e-5


# ---------------------------------------------------------------------------
# lw_noscat_reduced: every quadrature angle in one launch
# ---------------------------------------------------------------------------


def _sources_inputs(seed=13, nlay=6, ncol=12, ngpt=32, nbnd=4):
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.5, hi=1.5: rng.uniform(lo, hi, shape).astype(np.float32)
    tau = np.abs(rng.normal(0.4, 0.2, (nlay, ncol, ngpt))).astype(np.float32)
    tau[0, :, :3] = 1e-7  # below the Clough threshold: the series branch
    g2b = (np.arange(ngpt) * nbnd // ngpt).astype(np.int32)
    emis = f(nbnd, ncol, lo=0.9, hi=1.0)
    return dict(tau=tau, lay=f(nlay, ncol, ngpt), lev=f(nlay + 1, ncol, ngpt), sfc=f(ncol, ngpt), emis=emis,
                emis_gpt=np.ascontiguousarray(emis.T[:, g2b]), inc=f(ncol, ngpt, lo=0.0, hi=0.3)), g2b


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
@pytest.mark.parametrize("with_inc", [False, True])
def test_sources_angles_equal_the_per_angle_twin_sum_bit_for_bit(n_angles, with_inc):
    """On CPU tensors lw_noscat_reduced_angles is the one-angle twin per
    angle, angle k with the incident flux inc * w_k, added in the angles'
    order (the sum the sweep route made before): bit for bit, with no
    launch."""
    x, g2b = _sources_inputs()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["tau"], t["lay"], t["lev"], t["sfc"], t["emis"], torch.from_numpy(g2b))
    inc = t["inc"] if with_inc else None
    ds, w = _angles(n_angles)
    rte_kernels.lw_noscat_reduced.launches = 0
    out = rte_kernels.lw_noscat_reduced_angles(*args, ds, w, inc)
    up = dn = None
    for d, wk in zip(ds, w):
        u, v = rte_kernels.lw_noscat_reduced_ref(*args, d, wk, None if inc is None else inc * wk)
        up, dn = (u, v) if up is None else (up + u, dn + v)
    assert torch.equal(out[0], up) and torch.equal(out[1], dn)
    ref = rte_kernels.lw_noscat_reduced_angles_ref(*args, ds, w, inc)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert rte_kernels.lw_noscat_reduced.launches == 0
    if not with_inc:
        assert torch.all(out[1][-1] == 0.0)


@pytest.mark.parametrize("n_angles", [1, 2, 3, 4])
@pytest.mark.parametrize("with_inc", [False, True])
def test_sources_angles_hold_jax_per_angle_sum(n_angles, with_inc):
    """lw_noscat_reduced_angles against the JAX lw_noscat_pallas_reduced
    (its Pallas kernel in interpret mode, emissivity per g-point, 12 columns
    in blocks of 8) called per angle with the incident flux split by weight
    and summed, as the JAX sweep route does: rtol 2e-5 / atol 1e-3, as
    tests/test_torch_sweeps.py holds K13's twin."""
    from rrtmgp_tpu.ops import pallas_rte as jprte

    x, g2b = _sources_inputs(seed=14)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ds, w = _angles(n_angles)
    ref_up = ref_dn = 0.0
    for d, wk in zip(ds, w):
        inc_k = j["inc"] * np.float32(wk) if with_inc else None
        u, v = jprte.lw_noscat_pallas_reduced(j["tau"], j["lay"], j["lev"], j["sfc"], j["emis_gpt"], d, wk, inc_k,
                                              block_cols=8)
        ref_up, ref_dn = ref_up + np.asarray(u), ref_dn + np.asarray(v)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = rte_kernels.lw_noscat_reduced_angles(t["tau"], t["lay"], t["lev"], t["sfc"], t["emis"],
                                               torch.from_numpy(g2b), ds, w, t["inc"] if with_inc else None)
    for o, r in zip(out, (ref_up, ref_dn)):
        assert o.shape == (7, 12)
        np.testing.assert_allclose(o.numpy(), r, rtol=2e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# lw_2stream_reduced: the adding state checkpointed and replayed by chunks
# ---------------------------------------------------------------------------


def _lw2_inputs(dtype, nlay, ncol=9, ngpt=20, nbnd=4, seed=21):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)
    tau = u(0.01, 3.0, nlay, ncol, ngpt)
    tau[0, :, :3] = 1e-8  # below the Toon threshold: no layer source
    return dict(tau=tau, ssa=u(0.0, 0.9, nlay, ncol, ngpt), g=u(0.0, 0.8, nlay, ncol, ngpt),
                lev=u(5.0, 80.0, nlay + 1, ncol, ngpt), sfc=u(20.0, 120.0, ncol, ngpt),
                emis=u(0.9, 1.0, nbnd, ncol),
                gpt2band=torch.from_numpy((np.arange(ngpt) * nbnd // ngpt).astype(np.int32)),
                inc=u(0.0, 30.0, ncol, ngpt))


def _lw2_coeffs(x, l):
    return lw_2stream_coeffs(x["tau"][l], x["ssa"][l], x["g"][l], x["lev"][l], x["lev"][l + 1])


def _lw2_surface(x):
    emis = x["emis"].T[:, x["gpt2band"].long()]
    pi = round_to(np.pi, x["tau"].dtype)
    return 1.0 - emis, pi * emis * x["sfc"]


def _lw2_two_passes(x, inc):
    """The parent's K14: bottom-up adding with the albedo and source below
    every layer stored; top-down flux with the coefficients and the
    denominator computed again. Per g-point (up, down), (nlev, ncol, ngpt)."""
    nlay = x["tau"].shape[0]
    alb, src = _lw2_surface(x)
    s_alb, s_src = [None] * nlay, [None] * nlay
    for l in range(nlay):
        Rdif, Tdif, src_up, src_dn = _lw2_coeffs(x, l)
        denom = 1.0 / (1.0 - Rdif * alb)
        s_alb[l], s_src[l] = alb, src
        alb_n = Rdif + Tdif * Tdif * alb * denom
        src_n = src_up + Tdif * denom * (src + alb * src_dn)
        alb, src = alb_n, src_n
    fd = torch.zeros_like(alb) if inc is None else inc
    up, dn = [None] * (nlay + 1), [None] * (nlay + 1)
    up[nlay], dn[nlay] = alb * fd + src, fd
    for l in range(nlay - 1, -1, -1):
        Rdif, Tdif, src_up, src_dn = _lw2_coeffs(x, l)
        denom = 1.0 / (1.0 - Rdif * s_alb[l])
        fd = (Tdif * denom) * fd + denom * (Rdif * s_src[l] + src_dn)
        up[l], dn[l] = s_alb[l] * fd + s_src[l], fd
    return torch.stack(up), torch.stack(dn)


def _lw2_checkpoints(x, inc, chunk):
    """K14's design: the bottom-up pass stores (alb, src) at the bottom of
    each chunk of ``chunk`` layers only and ends holding the top chunk's
    state; the top-down pass replays each lower chunk from its checkpoint
    (the same expressions), keeping per layer alb, src, td = Tdif * denom
    and sc = denom * (Rdif * src + src_dn) (the kernel: in shared memory),
    then folds the flux through them. Same result layout as
    ``_lw2_two_passes``."""
    nlay = x["tau"].shape[0]
    nchunk = -(-nlay // chunk)

    def chunk_up(k, alb, src):
        state = {}
        for l in range(k * chunk, min((k + 1) * chunk, nlay)):
            Rdif, Tdif, src_up, src_dn = _lw2_coeffs(x, l)
            denom = 1.0 / (1.0 - Rdif * alb)
            state[l] = (alb, src, Tdif * denom, denom * (Rdif * src + src_dn))
            alb_n = Rdif + Tdif * Tdif * alb * denom
            src_n = src_up + Tdif * denom * (src + alb * src_dn)
            alb, src = alb_n, src_n
        return alb, src, state

    alb, src = _lw2_surface(x)
    checkpoints, state = [], {}
    for k in range(nchunk):
        checkpoints.append((alb, src))
        alb, src, state = chunk_up(k, alb, src)
    fd = torch.zeros_like(alb) if inc is None else inc
    up, dn = [None] * (nlay + 1), [None] * (nlay + 1)
    up[nlay], dn[nlay] = alb * fd + src, fd
    for k in range(nchunk - 1, -1, -1):
        if k < nchunk - 1:
            state = chunk_up(k, *checkpoints[k])[2]
        for l in range(min((k + 1) * chunk, nlay) - 1, k * chunk - 1, -1):
            alb_l, src_l, td, sc = state[l]
            fd = td * fd + sc
            up[l], dn[l] = alb_l * fd + src_l, fd
    return torch.stack(up), torch.stack(dn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("chunk", [4, 8])
@pytest.mark.parametrize("nlay", [1, 3, 8, 13])
@pytest.mark.parametrize("with_inc", [False, True])
def test_lw2_checkpoints_equal_the_two_passes_bit_for_bit(dtype, chunk, nlay, with_inc):
    """Replaying each chunk's adding recurrence from its checkpoint gives the
    bits of storing every layer's albedo and source, per g-point: columns
    shallower than a chunk, a partial top chunk (3, 13 layers) and whole
    chunks (8), with and without incident flux."""
    x = _lw2_inputs(dtype, nlay)
    inc = x["inc"] if with_inc else None
    for a, b in zip(_lw2_checkpoints(x, inc, chunk), _lw2_two_passes(x, inc)):
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_lw2_checkpoints_hold_the_twin(dtype, tol):
    """Summed over g-points, the checkpoint model agrees with
    lw_2stream_reduced_ref (what chip_smoke.py holds the kernel against),
    with and without incident flux."""
    x = _lw2_inputs(dtype, 13, seed=22)
    for inc in (x["inc"], None):
        out = tuple(f.sum(-1) for f in _lw2_checkpoints(x, inc, rte_kernels.LW2_CHUNK))
        ref = rte_kernels.lw_2stream_reduced_ref(x["tau"], x["ssa"], x["g"], x["lev"], x["sfc"], x["emis"],
                                                 x["gpt2band"], inc)
        assert _rel(out, ref) <= tol


@pytest.mark.parametrize("with_inc", [False, True])
def test_lw2_checkpoints_hold_jax_lw_2stream(with_inc):
    """The checkpoint model at 8 layers (chunks of 4: a replayed chunk and
    the top one) summed over g-points against the JAX
    lw_2stream_pallas_reduced (its Pallas kernel in interpret mode, 16
    columns in blocks of 8) and ops.rte.lw_2stream summed: rtol 2e-5 / atol
    1e-3, as tests/test_torch_sweeps.py holds K14's twin."""
    from rrtmgp_tpu.ops import pallas_rte as jprte

    x = _lw2_inputs(torch.float32, 8, ncol=16, ngpt=32, seed=23)
    inc = x["inc"] if with_inc else None
    out = tuple(f.sum(-1) for f in _lw2_checkpoints(x, inc, 4))
    J = lambda t: jnp.asarray(t.numpy())
    emis = x["emis"].T[:, x["gpt2band"].long()].contiguous()
    jargs = (J(x["tau"]), J(x["ssa"]), J(x["g"]), J(x["lev"]), J(x["sfc"]), J(emis), None if inc is None else J(inc))
    pal = jprte.lw_2stream_pallas_reduced(*jargs, block_cols=8)
    xla = tuple(jnp.sum(f, -1) for f in jrte.lw_2stream(*jargs))
    for o, p, r in zip(out, pal, xla):
        np.testing.assert_allclose(o.numpy(), np.asarray(p), rtol=2e-5, atol=1e-3)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("nlay", [1, 7, 8, 9, 60, 61, 800])
def test_lw2_sweep_scratch_is_one_checkpoint_level_per_chunk(nlay):
    """lw_2stream_reduced's scratch: two distinct (ceil(nlay / LW2_CHUNK),
    ncol, ngpt) f32 arrays, the albedo and the source at the bottom of each
    chunk, in place of two (nlay, ncol, ngpt) arrays: at 60 layers and
    chunks of 8, 8 levels against 60."""
    scratch = rte_kernels.lw2_sweep_scratch(nlay, 5, 7, "cpu")
    assert len(scratch) == 2 and scratch[0].data_ptr() != scratch[1].data_ptr()
    for t in scratch:
        assert t.shape == (-(-nlay // rte_kernels.LW2_CHUNK), 5, 7) and t.dtype == torch.float32
    source = (_build.CSRC / "lw_2stream_reduced.cu").read_text()
    assert f"constexpr int LW2_CHUNK = {rte_kernels.LW2_CHUNK};" in source
    assert "sizeof(float) * 4 * LW2_CHUNK * (size_t)group" in source
    assert rte_kernels.LW2_STATE_BYTES == 4 * 4 * rte_kernels.LW2_CHUNK


# ---------------------------------------------------------------------------
# aerosol_bands: the tables staged as records in shared memory
# ---------------------------------------------------------------------------

_AERO_TABLES = ("dust", "sea_salt", "sulfate", "black_carbon_rh", "organic_carbon_rh", "black_carbon",
                "organic_carbon")


def _aero_case(seed=31, nlay=6, ncol=40):
    from rrtmgp_tpu_torch import AllSkyRadiation, lookup_tables
    from rrtmgp_tpu_torch.states import AerosolState

    L = lookup_tables(AllSkyRadiation(aerosol_radiation=True), dtype=torch.float32, device="cpu")
    lkp = L.lookup_lw_aero
    lo, hi = lkp.size_bin_limits[0].numpy(), lkp.size_bin_limits[1].numpy()
    rng = np.random.default_rng(seed)
    mass = rng.uniform(-0.2, 1.0, (15, nlay, ncol)).astype(np.float32)  # some species absent (<= 0)
    size = rng.uniform(lo.min() * 0.5, hi.max() * 1.5, (15, nlay, ncol)).astype(np.float32)  # some off every bin
    rh = rng.uniform(-0.1, 1.1, (nlay, ncol)).astype(np.float32)  # some below and above the RH grid
    aero = AerosolState(aero_size=torch.from_numpy(size), aero_mass=torch.from_numpy(mass))
    return L, aero, torch.from_numpy(rh)


def _staged_records(lkp):
    """The staged tables as csrc/aerosol_bands.cu lays them out (AeroLayout):
    bin limits, RH levels, then each table's records of nbnd (ext, ssa,
    asy) triples ``record_stride`` words apart. Returns the words and the
    first word of each table's records."""
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    nbnd, nbin = lkp.dust.shape[-1], lkp.size_bin_limits.shape[1]
    S = ab.record_stride(nbnd)
    words = [lkp.size_bin_limits.reshape(-1), lkp.rh_levels]
    first, at = {}, 2 * nbin + lkp.rh_levels.shape[0]
    for name in _AERO_TABLES:
        t = getattr(lkp, name)
        recs = t.reshape(3, -1, nbnd).permute(1, 2, 0).reshape(-1, 3 * nbnd)  # (records, nbnd x 3)
        padded = torch.zeros(recs.shape[0], S)
        padded[:, :3 * nbnd] = recs
        first[name], at = at, at + padded.numel()
        words.append(padded.reshape(-1))
    return torch.cat(words), first


def _aero_rows(lkp, aero, rh, read, active=None):
    """Per-(layer, column) band sums in the kernel's order: per band dust,
    sea salt, sulfate, BC-RH, OC-RH, BC, OC, each from ``read(table, record,
    band, value)``: the parent's gathers from the tables or the staged
    records; a species not in ``active`` (all when None) is skipped.
    Returns (tau, tau*ssa, tau*ssa*g), each (nlay, nbnd, ncol)."""
    nbnd, nbin, nrh = lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0]
    levels = lkp.rh_levels
    lo, hi = lkp.size_bin_limits
    r = rh
    loc = torch.clamp((levels[:, None, None] <= r).sum(0) - 1, 0, nrh - 2)
    lev0, lev1 = levels[loc], levels[loc + 1]
    fac = torch.clamp((r - lev0) / (lev1 - lev0), 0.0, 1.0)
    omf = 1.0 - fac

    def size_bin(sz):
        inside = (sz[..., None] >= lo) & (sz[..., None] <= hi)
        return torch.where(inside.any(-1), torch.argmax(inside.to(torch.uint8), -1), nbin - 1)

    out = [torch.zeros(rh.shape[0], nbnd, rh.shape[1]) for _ in range(3)]
    mass, size = aero.aero_mass, aero.aero_size
    on = [active is None or i in active for i in range(15)]
    for b in range(nbnd):
        t = ts = tsg = torch.zeros_like(r)

        def add(m, v):
            nonlocal t, ts, tsg
            if m is None:
                return
            tt = torch.where(m > 0.0, m * v[0], 0.0)
            tts = tt * v[1]
            t, ts, tsg = t + tt, ts + tts, tsg + tts * v[2]

        interp = lambda name, rec0, rec1: [read(name, rec0, b, q) * omf + read(name, rec1, b, q) * fac
                                           for q in range(3)]
        m_of = lambda i: mass[i] if on[i] else None
        for i in (0, 7, 8, 9, 10):
            add(m_of(i), [read("dust", size_bin(size[i]), b, q) for q in range(3)])
        for i in (1, 11, 12, 13, 14):
            sb = size_bin(size[i])
            add(m_of(i), interp("sea_salt", loc * nbin + sb, (loc + 1) * nbin + sb))
        for name, i in (("sulfate", 2), ("black_carbon_rh", 3), ("organic_carbon_rh", 5)):
            add(m_of(i), interp(name, loc, loc + 1))
        for name, i in (("black_carbon", 4), ("organic_carbon", 6)):
            add(m_of(i), [read(name, torch.zeros_like(loc), b, q) for q in range(3)])
        for o, v in zip(out, (t, ts, tsg)):
            o[:, b] = v
    return tuple(out)


@pytest.mark.parametrize("active", [None, (0, 2, 4, 11), (6,)])
def test_staged_aerosol_records_equal_the_table_gathers_bit_for_bit(active):
    """Read from the staged records (one word offset per record, band at 3 b,
    value q at + q) the band sums are those of reading the (3, ..., nbnd)
    tables, the parent's gathers, bit for bit, with every species active
    (the kernel's instance without a test per species) and with a subset;
    and both hold the twin aerosol_bands_ref (chip_smoke.py's 1e-6)."""
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    L, aero, rh = _aero_case()
    for lkp in (L.lookup_lw_aero, L.lookup_sw_aero):
        nbnd = lkp.dust.shape[-1]
        words, first = _staged_records(lkp)
        S = ab.record_stride(nbnd)
        staged = _aero_rows(lkp, aero, rh, lambda name, rec, b, q: words[first[name] + rec * S + 3 * b + q],
                            active)
        tables = {name: getattr(lkp, name).reshape(3, -1, nbnd) for name in _AERO_TABLES}
        gathered = _aero_rows(lkp, aero, rh, lambda name, rec, b, q: tables[name][q, rec, b], active)
        for a, b in zip(staged, gathered):
            torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
        assert _rel(staged, ab.aerosol_bands_ref(lkp, aero, rh, active)) <= 1e-6


@pytest.mark.parametrize("nbnd,nbin,nrh", [(16, 5, 7), (14, 5, 7), (16, 5, 36), (1, 1, 2), (15, 3, 4)])
def test_staged_bytes_count_the_records(nbnd, nbin, nrh):
    """``staged_bytes`` (the wrapper's check against the device's limit) is
    the bin limits, the RH levels and nbin + nrh nbin + 3 nrh + 2 records
    of an odd stride >= 3 nbnd; with the synthetic tables it is the size of
    the staged words, and the records of any 32 distinct (RH level, bin)
    fall in 32 distinct banks."""
    from rrtmgp_tpu_torch.ops import aerosol_bands as ab

    S = ab.record_stride(nbnd)
    assert S % 2 == 1 and 3 * nbnd <= S <= 3 * nbnd + 1
    records = nbin + nrh * nbin + 3 * nrh + 2
    assert ab.staged_bytes(nbnd, nbin, nrh) == 4 * (2 * nbin + nrh + records * S)
    assert len({(r * S) % 32 for r in range(32)}) == 32
    L, _, _ = _aero_case()
    for lkp in (L.lookup_lw_aero, L.lookup_sw_aero):
        words, _ = _staged_records(lkp)
        shape = (lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0])
        assert ab.staged_bytes(*shape) == 4 * words.numel() <= 48 * 1024
    source = (_build.CSRC / "aerosol_bands.cu").read_text()
    assert "stride = 3 * nbnd | 1;" in source
    assert ab.staged_bytes(16, 5, 36) == 58004  # a MERRA-sized lookup (36 RH levels) fits a block


def test_every_planned_kernel_has_a_block_limit_query():
    """Each kernel name the wrappers plan with (``kernel_plan`` /
    ``max_threads`` in ops/) is one that the C entry point
    ``rrtmgp_max_threads`` (csrc/errors.cu) answers, and every one it
    answers is planned."""
    import pathlib

    ops = pathlib.Path(rte_kernels.__file__).parent
    planned = set()
    for p in ops.glob("*.py"):
        planned |= set(re.findall(r'(?:kernel_plan|max_threads|_plan|_groups|angles_plan)\(\s*"(\w+)"', p.read_text()))
    table = set(re.findall(r'\{"(\w+)", \w+_max_threads\}', (_build.CSRC / "errors.cu").read_text()))
    assert planned == table
    assert {"lw2_mega", "sw_clear_mega", "lw_clear_mega", "lw_2stream_reduced"} <= table


# ---------------------------------------------------------------------------
# planck_band / planck_band_rows: a thread per point over the staged table
# ---------------------------------------------------------------------------


def _planck_per_point(ts, totplnk, t_min, t_delta, rows, span):
    """csrc/planck_band.cu in plain torch: the blocks of the sets plan, each
    over its points; a point's node and weights once, the table as (nbnd,
    n_t), the bands looped; outputs (N, nbnd) with ``rows``, else (nbnd, N)."""
    n_t, nbnd = totplnk.shape
    table = totplnk.T.contiguous()
    sizes = [t.numel() for t in ts]
    plan = _launch.sets_plan(sizes, span)
    outs = [torch.full((n, nbnd) if rows else (nbnd, n), float("nan"), dtype=totplnk.dtype) for n in sizes]
    for block in range(plan.grid):
        k, points = _launch.block_points(plan, sizes, block)
        idx = torch.arange(points.start, points.stop)
        loc = (ts[k][idx] - t_min) / t_delta
        j = torch.clamp(torch.floor(loc), 0.0, float(n_t - 2))
        f = torch.clamp(loc - j, 0.0, 1.0)
        g = 1.0 - f
        jj = j.to(torch.int32).long()
        for b in range(nbnd):
            v = table[b][jj] * g + table[b][jj + 1] * f
            if rows:
                outs[k][idx, b] = v
            else:
                outs[k][b, idx] = v
    return outs


def _planck_edge_sets(dtype, sizes=(257, 0, 1030)):
    lkp = synthetic_gas_lookup(longwave=True, n_gpt=32, n_bnd=16, dtype=dtype, device="cpu")
    n_t = lkp.totplnk.shape[0]
    t_min, dt = float(lkp.t_planck_min), float(lkp.t_planck_delta)
    t_max = t_min + (n_t - 1) * dt
    edges = [t_min - 50.0, t_min - 1e-3, *(t_min + k * dt for k in range(n_t)), t_max - 0.5 * dt,
             t_max - 1e-3, t_max, t_max + 1e-3, t_max + 50.0]
    rng = np.random.default_rng(6)
    t = np.concatenate([edges, rng.uniform(t_min - 30.0, t_max + 30.0, sum(sizes) - len(edges))]).astype(dtype)
    return lkp, list(torch.split(torch.from_numpy(t), list(sizes)))


@pytest.mark.parametrize("dtype,rows", [(np.float32, False), (np.float64, False), (np.float32, True)])
@pytest.mark.parametrize("span", [256, _launch.PLANCK_SPAN])
def test_planck_per_point_equals_the_twin_bit_for_bit(dtype, rows, span):
    lkp, ts = _planck_edge_sets(dtype)
    tab = (lkp.totplnk, lkp.t_planck_min, lkp.t_planck_delta)
    out = _planck_per_point(ts, *tab, rows, span)
    for o, t in zip(out, ts):
        want = planck_bands(lkp.totplnk, t, *tab[1:])
        assert torch.equal(o, want if rows else want.T)
    first = out[0][0] if rows else out[0][:, 0]
    assert torch.equal(first, lkp.totplnk[0])  # below the table: the first node
    last = torch.nonzero(ts[0] > lkp.t_planck_min + (lkp.totplnk.shape[0] - 1) * lkp.t_planck_delta)
    assert len(last) and torch.equal(out[0][last[0, 0]] if rows else out[0][:, last[0, 0]], lkp.totplnk[-1])


def test_planck_staged_bytes_are_the_kernels():
    """The wrapper's shared-memory count is the kernel's: the table
    transposed at an odd row stride."""
    source = (_build.CSRC / "planck_band.cu").read_text()
    assert "inline int planck_ld(int n_t) { return n_t | 1; }" in source
    assert "(size_t)nbnd * ld * sizeof(R)" in source
    assert interp.planck_staged_bytes(16, 196, 4) == 16 * 197 * 4
    assert interp.planck_staged_bytes(16, 197, 8) == 16 * 197 * 8
