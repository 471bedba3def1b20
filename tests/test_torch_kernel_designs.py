"""CPU rehearsals of the arithmetic of two kernel designs, with no card:

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

And the wrappers' checks that the designs add: a table of 2^31 elements or
more is refused, sw_2stream_reduced's scratch is two arrays, and each C
entry point takes as many arguments as its ctypes signature lists.

Tolerances, relative to the largest reference value: the models against
the twin 1e-5 in f32 and 1e-12 in f64 (the twin forms the beam from the
summed optical depth and folds the flux in another order, a few ulp apart);
against the JAX ``sw_2stream`` rtol 2e-4 / atol 1e-3, as
tests/test_torch_two_kernel.py holds the SW sweep.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.ops import rte as jrte
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_gas_lookup
from rrtmgp_tpu_torch.ops import _build, _launch, interp, rte_kernels
from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs
from rrtmgp_tpu_torch.ops.rte import sw_2stream_coeffs

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
    signature in ops/_build.py lists (two of them changed with the designs
    above)."""
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", sources)
        assert m, entry
        assert len(m.group(1).split(",")) == len(argtypes), entry
