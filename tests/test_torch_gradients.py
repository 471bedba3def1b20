"""Gradients of the port's solves against ``jax.grad`` of the JAX package's
XLA solves, and ``differentiable_solve_lw`` / ``_sw`` (kernel-route forward,
torch-path backward) against the JAX package's.

The synthetic atmosphere puts most layer and level temperatures exactly on
the Planck table's 1 K knots, where the interpolation fraction sits on its
bound: ``jnp.clip`` passes half the cotangent there and ``torch.clamp`` all
of it, so these tests run at the knots, unjittered (``ops.bounds``). f64,
8 layers x 16 columns x 32 g-points in 4 bands; the gradient of a weighted
sum of every flux with respect to each input is held within 1e-8 of its
largest entry.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu.states import AerosolState as JAerosolState
from rrtmgp_tpu.states import LwBCs as JLwBCs
from rrtmgp_tpu.states import SwBCs as JSwBCs
from rrtmgp_tpu.states import compute_relative_humidity as jrel_hum
from rrtmgp_tpu.parameters import RRTMGPParameters as JParams
from rrtmgp_tpu_torch import RRTMGPParameters, compute_relative_humidity, convert
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.states import AerosolState, Vmr, VmrGM, tree_leaves, tree_unflatten

NLAY, NCOL, NGPT, NBND = 8, 16, 32, 4
TIE_TOL = 1e-8
#: The LW pressure gradient's residual against JAX (4.0e-6 no-scattering,
#: 6.8e-6 two-stream, measured) is rounding in the 3 Pa top layer: the
#: derivatives of the Clough factor (1 - exp(-x)) / x - exp(-x) and of the
#: Toon source's (B_bot - B_top) / tau cancel there, and XLA's exp differs
#: from torch's by an ulp (test_lw_pressure_gradient_residual_is_rounding).
LW_P_LAY_TOL = 1e-5

ATM_FIELDS = ("t_lay", "t_lev", "t_sfc", "p_lay")
SW_ATM_FIELDS = ("t_lay", "p_lay")  # SW gas optics read no level or surface temperature
LW_FIELDS = ("sfc_emis",)
SW_FIELDS = ("cos_zenith", "toa_flux", "sfc_alb_direct", "sfc_alb_diffuse")
CLOUD_FIELDS = ("cld_path_liq", "cld_path_ice", "cld_r_eff_liq", "cld_r_eff_ice")
AERO_FIELDS = ("aero_mass", "rel_hum")


@functools.lru_cache(maxsize=None)
def _lookups(dtype, clouds=False, aerosols=False):
    """JAX lookups and their port copies: LW and SW gas (and cloud, aerosol)."""
    j = dict(
        lw=jsyn.synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, seed=2, dtype=dtype),
        sw=jsyn.synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=2, dtype=dtype),
    )
    t = {k: convert.gas_lookup_from_object(v, device="cpu") for k, v in j.items()}
    if clouds:
        j["cld"] = jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=dtype)
        t["cld"] = convert.cloud_lookup_from_object(j["cld"], device="cpu")
    if aerosols:
        j["aero"] = jsyn.synthetic_aerosol_lookup(n_bnd=NBND, dtype=dtype)
        t["aero"] = convert.aerosol_lookup_from_object(j["aero"], device="cpu")
    return j, t


def _atmosphere(dtype, clouds=False, aerosols=False, ncol=NCOL, nlay=NLAY):
    """The synthetic atmosphere, unjittered; with aerosols every species
    carries mass in every layer (the synthetic masses sit below 800 hPa,
    which 8 layers do not reach) at a relative humidity spread over the
    table's levels."""
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=dtype, with_clouds=clouds,
                                   with_aerosols=aerosols)
    if aerosols:
        rng = np.random.default_rng(11)
        mass = rng.uniform(1e-6, 3e-5, (15, nlay, ncol))
        size = rng.uniform(0.05, 12.0, (15, nlay, ncol))
        ja = dataclasses.replace(
            ja, aerosol_state=JAerosolState(aero_size=jnp.asarray(size, dtype), aero_mass=jnp.asarray(mass, dtype)),
            rel_hum=jnp.asarray(rng.uniform(0.0, 1.05, (nlay, ncol)), dtype))
    return ja, convert.atmosphere_from_object(ja, device="cpu")


def _bcs(dtype, ncol=NCOL):
    """Numpy LW and SW boundary conditions, one night column."""
    rng = np.random.default_rng(5)
    mu0 = rng.uniform(0.1, 0.95, ncol)
    mu0[3] = -0.2
    lw = dict(sfc_emis=rng.uniform(0.85, 1.0, (NBND, ncol)).astype(dtype))
    sw = dict(cos_zenith=mu0.astype(dtype), toa_flux=rng.uniform(1300.0, 1400.0, ncol).astype(dtype),
              sfc_alb_direct=rng.uniform(0.05, 0.4, (NBND, ncol)).astype(dtype),
              sfc_alb_diffuse=rng.uniform(0.05, 0.4, (NBND, ncol)).astype(dtype))
    return lw, sw


def _weights(n_out, ncol=NCOL):
    rng = np.random.default_rng(21)
    return [rng.uniform(-1.0, 1.0, (NLAY + 1, ncol)) for _ in range(n_out)]


def _get(tree, name):
    """A field of the state, its cloud or aerosol state, or the BCs."""
    for t in (tree, getattr(tree, "cloud_state", None), getattr(tree, "aerosol_state", None)):
        if t is not None and hasattr(t, name):
            return getattr(t, name)
    raise KeyError(name)


def _set_jax(atm, bcs, values):
    """JAX state and BCs with the named fields replaced."""
    sub = lambda t, names: dataclasses.replace(t, **{k: values[k] for k in names if k in values})
    if atm.cloud_state is not None:
        atm = dataclasses.replace(atm, cloud_state=sub(atm.cloud_state, CLOUD_FIELDS))
    if atm.aerosol_state is not None:
        atm = dataclasses.replace(atm, aerosol_state=sub(atm.aerosol_state, ("aero_mass",)))
    atm = sub(atm, ATM_FIELDS + ("rel_hum",))
    return atm, sub(bcs, LW_FIELDS + SW_FIELDS)


def _jax_grads(solve, ja, jb, fields, weights, **kw):
    values = {k: _get(ja, k) if not hasattr(jb, k) else getattr(jb, k) for k in fields}

    def loss(vals):
        a, b = _set_jax(ja, jb, vals)
        flux = solve(a, b, **kw)[0]
        return sum(jnp.sum(f * w) for f, w in zip(flux[:len(weights)], weights))

    g = jax.jit(jax.grad(loss))(values)
    return {k: np.asarray(v) for k, v in g.items()}


def _port_grads(solve, ta, tb, fields, weights, **kw):
    leaves = {k: getattr(tb, k) if hasattr(tb, k) else _get(ta, k) for k in fields}
    for x in leaves.values():
        x.requires_grad_(True)
    flux = solve(ta, tb, **kw)
    flux = flux[0] if isinstance(flux, tuple) and not hasattr(flux, "_fields") else flux
    loss = sum((f * torch.from_numpy(w)).sum() for f, w in zip(tuple(flux)[:len(weights)], weights))
    g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: (np.zeros(tuple(v.shape)) if gi is None else gi.numpy()) for (k, v), gi in zip(leaves.items(), g)}


def _assert_close(port, ref, tols=None, tol=TIE_TOL):
    for k, r in ref.items():
        scale = np.abs(r).max()
        assert scale > 0.0, k
        err = np.abs(port[k] - r).max() / scale
        assert err <= (tols or {}).get(k, tol), (k, err)


def _case(wave, clouds=False, aerosols=False):
    j, t = _lookups(np.float64, clouds, aerosols)
    ja, ta = _atmosphere(np.float64, clouds, aerosols)
    lw, sw = _bcs(np.float64)
    if wave == "lw":
        return j, t, ja, ta, JLwBCs(**{k: jnp.asarray(v) for k, v in lw.items()}), convert.lw_bcs_from_numpy(
            **lw, device="cpu")
    return j, t, ja, ta, JSwBCs(**{k: jnp.asarray(v) for k, v in sw.items()}), convert.sw_bcs_from_numpy(
        **sw, device="cpu")


SOLVES = [("lw", {}), ("lw", {"two_stream": True}), ("sw", {})]
SOLVE_IDS = ["lw_noscat", "lw_2stream", "sw"]


def _solve_kw(wave, j, t, clouds, aerosols, mask):
    jk, tk = {}, {}
    if clouds:
        jk.update(lkp_cld=j["cld"], cld_mask=jnp.asarray(mask))
        tk.update(lkp_cld=t["cld"], cld_mask=torch.from_numpy(mask))
    if aerosols:
        jk["lkp_aero"], tk["lkp_aero"] = j["aero"], t["aero"]
    return jk, tk


@pytest.mark.parametrize("sky", ["clear", "aerosols", "clouds"])
@pytest.mark.parametrize("wave,kw", SOLVES, ids=SOLVE_IDS)
def test_gradients_at_knots_match_jax(wave, kw, sky):
    """torch.autograd.grad of the torch path against jax.grad of the JAX XLA
    solve, f64, every flux weighted, at the knot temperatures: clear sky,
    with every aerosol species (the relative-humidity interpolation's
    clamps), and with clouds under an explicit mask."""
    clouds, aerosols = sky == "clouds", sky == "aerosols"
    j, t, ja, ta, jb, tb = _case(wave, clouds, aerosols)
    ngpt = NGPT
    mask = None
    if clouds:
        frac = np.asarray(ja.cloud_state.cld_frac)
        mask = (np.random.default_rng(8).random((NLAY, NCOL, ngpt)) < 0.6) & (frac[..., None] > 0)
    jk, tk = _solve_kw(wave, j, t, clouds, aerosols, mask)
    fields = (ATM_FIELDS + LW_FIELDS) if wave == "lw" else (SW_ATM_FIELDS + SW_FIELDS)
    fields += (CLOUD_FIELDS[0], CLOUD_FIELDS[2]) if clouds else ()
    fields += AERO_FIELDS if aerosols else ()
    w = _weights(3)
    jsolve = jmod.solve_lw if wave == "lw" else jmod.solve_sw
    tsolve = tmod.solve_lw if wave == "lw" else tmod.solve_sw
    ref = _jax_grads(lambda a, b, **k: jsolve(j[wave], a, b, **k), ja, jb, fields, w, **kw, **jk)
    port = _port_grads(lambda a, b, **k: tsolve(t[wave], a, b, **k), ta, tb, fields, w, **kw, **tk)
    _assert_close(port, ref, {"p_lay": LW_P_LAY_TOL} if wave == "lw" else {})


def test_lw_pressure_gradient_residual_is_rounding():
    """What the LW p_lay gradient keeps after the tie repair is rounding,
    not a tie: it grows with height into the 3 Pa top layer, and one ulp of
    exp moves the port's own gradient there by a tenth of it."""
    j, t, ja, ta, jb, tb = _case("lw")
    w = _weights(3)
    ref = _jax_grads(lambda a, b: jmod.solve_lw(j["lw"], a, b), ja, jb, ("p_lay",), w)["p_lay"]

    def grad():  # fresh leaves each time
        _, t2, _, ta2, _, tb2 = _case("lw")
        return _port_grads(lambda a, b: tmod.solve_lw(t2["lw"], a, b), ta2, tb2, ("p_lay",), w)["p_lay"]

    port = grad()
    exp = torch.exp
    try:
        torch.exp = lambda x: exp(x) * (1.0 + torch.finfo(x.dtype).eps)
        moved = grad()
    finally:
        torch.exp = exp
    scale = np.abs(ref).max()
    resid = np.abs(port - ref).max(axis=1) / scale
    assert resid[:3].max() <= TIE_TOL                    # the thick lower layers
    assert resid.max() <= LW_P_LAY_TOL
    assert np.argmax(resid) >= NLAY - 2                  # the thin top
    assert np.abs(moved - port).max() / scale >= 0.1 * resid.max()


def test_knots_are_ties():
    """The case above is the one the repair is about: most temperatures sit
    exactly on a Planck knot, where the clamped fraction is 0."""
    j, _, ja, _, _, _ = _case("lw")
    lkp = j["lw"]
    for name in ("t_lay", "t_lev"):
        loc = (np.asarray(getattr(ja, name)) - lkp.t_planck_min) / lkp.t_planck_delta
        assert np.mean(loc == np.floor(loc)) > 0.5, name


def test_relative_humidity_gradient_matches_jax():
    """compute_relative_humidity's two lower bounds, at ties and off them,
    against jax.grad of the JAX package's."""
    rng = np.random.default_rng(3)
    p = rng.uniform(5e3, 1e5, (NLAY, NCOL))
    t = rng.uniform(200.0, 310.0, (NLAY, NCOL))
    h2o = rng.uniform(1e-9, 2e-2, (NLAY, NCOL))
    h2o[0, :4] = 0.0                     # q at its lower bound
    w = rng.uniform(-1.0, 1.0, (NLAY, NCOL))
    jp = JParams()
    g_ref = jax.grad(lambda a, b, c: jnp.sum(jrel_hum(a, b, c, jp) * w), argnums=(0, 1, 2))(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(h2o))
    xs = [torch.tensor(a, requires_grad=True) for a in (p, t, h2o)]
    out = (compute_relative_humidity(*xs, RRTMGPParameters()) * torch.from_numpy(w)).sum()
    for g, r in zip(torch.autograd.grad(out, xs), g_ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-12 * np.abs(r).max()


# ---------------------------------------------------------------------------
# differentiable_solve_lw / _sw
# ---------------------------------------------------------------------------

DIFF = [("lw", {}), ("lw", {"two_stream": True}), ("sw", {})]


@functools.lru_cache(maxsize=None)
def _differentiable_case(wave, two_stream, dtype):
    """Both packages' differentiable solves' fluxes, and the JAX and port
    gradients of a weighted sum of every flux (computed once per case)."""
    kw = {"two_stream": True} if two_stream else {}
    j, t = _lookups(dtype)
    ja, ta = _atmosphere(dtype)
    lw, sw = _bcs(dtype)
    if wave == "lw":
        jb, tb = JLwBCs(**{k: jnp.asarray(v) for k, v in lw.items()}), convert.lw_bcs_from_numpy(**lw, device="cpu")
        jf, tf = jmod.differentiable_solve_lw(j["lw"], **kw), tmod.differentiable_solve_lw(t["lw"], **kw)
        fields = ATM_FIELDS + LW_FIELDS
    else:
        jb, tb = JSwBCs(**{k: jnp.asarray(v) for k, v in sw.items()}), convert.sw_bcs_from_numpy(**sw, device="cpu")
        jf, tf = jmod.differentiable_solve_sw(j["sw"], **kw), tmod.differentiable_solve_sw(t["sw"], **kw)
        fields = SW_ATM_FIELDS + SW_FIELDS
    w = _weights(3)
    out, jout = tf(ta, tb), jax.jit(jf)(ja, jb)
    ref = _jax_grads(lambda a, b: (jf(a, b),), ja, jb, fields, w)
    port = _port_grads(lambda a, b: tf(a, b), ta, tb, fields, w)
    return out, jout, ref, port


@pytest.mark.parametrize("wave,kw", DIFF, ids=SOLVE_IDS)
def test_differentiable_solve_matches_jax(wave, kw):
    """Forward fluxes and the gradient of a weighted sum of every flux with
    respect to every input against the JAX package's differentiable_solve_lw
    / _sw without pallas_* kwargs (its XLA path both ways), f64: within 1e-8
    of the largest entry."""
    out, jout, ref, port = _differentiable_case(wave, bool(kw), np.float64)
    for o, r in zip(out, jout):
        r = np.asarray(r)
        assert np.abs(o.detach().numpy() - r).max() <= 1e-8 * np.abs(r).max()
    _assert_close(port, ref, {"p_lay": LW_P_LAY_TOL} if wave == "lw" else {})


#: f32: the port's gradient against the JAX package's, of the largest entry,
#: the rtol with which the JAX package holds its f32 kernel-route gradient
#: against its own XLA path (tests/test_autodiff.py)
F32_RTOL = 3e-5
#: Above this pressure the f32 gradients with respect to t_lay and t_lev are
#: rounding-limited; in the layers and levels above it (52, 13 and 3 Pa at 8
#: layers) the derivatives of the Clough factor, the Toon source and the
#: SW gas optics cancel, and either package's f32 gradient is off its own
#: f64 one by up to 5e-5 (LW) and 5e-3 (SW t_lay) of the largest entry.
F32_THIN_PA = 100.0
#: Gradients that cancel in f32 in every layer: p_lay (either package off
#: its f64 gradient by 1e-4 of the largest entry at 3.7 kPa, by over half
#: at the top) and cos_zenith (3e-3, in the one column whose SW gradient
#: nearly cancels). PERF.md (PR 15) has every field's reading.
F32_CANCELLING = ("p_lay", "cos_zenith")


def _f32_errors(wave, two_stream):
    """Per gradient field, of its largest entry: ``fixed``, the port's f32
    gradient against the JAX package's where f32 does not cancel (None if
    it cancels everywhere); ``jax`` and ``port``, each package's f32 gradient
    against the JAX f64 one where it cancels (None if nowhere)."""
    _, _, ref32, port32 = _differentiable_case(wave, two_stream, np.float32)
    _, _, ref64, _ = _differentiable_case(wave, two_stream, np.float64)
    _, ta = _atmosphere(np.float32)
    p = {"t_lay": ta.p_lay.numpy(), "t_lev": ta.p_lev.numpy()}
    out = {}
    for k, g64 in ref64.items():
        if k in F32_CANCELLING:
            cancels = np.ones(g64.shape, bool)
        else:
            cancels = p[k] < F32_THIN_PA if k in p else np.zeros(g64.shape, bool)
        fixed = jax_err = port_err = None
        if not cancels.all():
            fixed = np.abs(port32[k] - ref32[k])[~cancels].max() / np.abs(ref32[k]).max()
        if cancels.any():
            scale = np.abs(g64).max()
            jax_err = np.abs(ref32[k] - g64)[cancels].max() / scale
            port_err = np.abs(port32[k] - g64)[cancels].max() / scale
        out[k] = dict(fixed=fixed, jax=jax_err, port=port_err)
    return out


@pytest.mark.parametrize("wave,kw", DIFF, ids=SOLVE_IDS)
def test_differentiable_solve_f32_as_accurate_as_jax(wave, kw):
    """f32: forward fluxes within 1e-5 of the largest JAX flux. Each gradient
    within F32_RTOL of the largest entry of the JAX package's f32 gradient,
    apart from what cancels in f32 (the layers above F32_THIN_PA, and the
    F32_CANCELLING fields): there the two packages' f32 gradients differ
    as much as each differs from f64, and the port's error against the f64
    gradient is held to at most 3x the JAX package's own plus 1e-5."""
    out, jout, _, _ = _differentiable_case(wave, bool(kw), np.float32)
    for o, r in zip(out, jout):
        r = np.asarray(r)
        assert np.abs(o.detach().numpy() - r).max() <= 1e-5 * np.abs(r).max()
    for k, e in _f32_errors(wave, bool(kw)).items():
        assert e["fixed"] is None or e["fixed"] <= F32_RTOL, (k, e)
        assert e["port"] is None or e["port"] <= 3.0 * e["jax"] + 1e-5, (k, e)


@pytest.mark.parametrize("key", ["cld_mask", "cld_mask_seed"])
@pytest.mark.parametrize("which", ["lw", "sw"])
def test_differentiable_solve_refuses_mcica(which, key):
    _, t = _lookups(np.float64)
    make = tmod.differentiable_solve_lw if which == "lw" else tmod.differentiable_solve_sw
    with pytest.raises(ValueError, match="cld_mask"):
        make(t[which], **{key: 0})


@pytest.mark.parametrize("variant", ["gm", "full", "scaling_lev", "scaling_col"])
@pytest.mark.parametrize("wave,kw", DIFF, ids=SOLVE_IDS)
def test_chunked_backward_equals_unchunked(monkeypatch, wave, kw, variant):
    """A backward over 5-column chunks (16 columns: 5, 5, 5, 1; grad_chunk
    patched) gives the whole-width gradient, the VmrGM global-mean vector's
    (no column axis: a sum over the chunks) and a 3-D Vmr's among them, and
    the incident flux's ((ncol, ngpt): its column axis leads); also with a
    metric scaling of one value a level, (nlev, 1), which no chunk cuts, and
    of one a level and column, (nlev, ncol), which each chunk cuts."""
    j, t = _lookups(np.float64)
    ja, ta = _atmosphere(np.float64)
    if variant == "full":
        v = ta.vmr
        full = v.vmr[:, None, None].expand(-1, NLAY, NCOL).clone()
        full[1], full[3] = v.vmr_h2o, v.vmr_o3
        ta = dataclasses.replace(ta, vmr=Vmr(vmr=full))
    lw, sw = _bcs(np.float64)
    inc = np.random.default_rng(2).uniform(0.0, 3.0, (NCOL, NGPT))
    if wave == "lw":
        tb = convert.lw_bcs_from_numpy(**lw, inc_flux=inc, device="cpu")
        make = tmod.differentiable_solve_lw
    else:
        tb = convert.sw_bcs_from_numpy(**sw, inc_flux_diffuse=inc, device="cpu")
        make = tmod.differentiable_solve_sw
    if variant.startswith("scaling"):
        shape = (NLAY + 1, 1 if variant == "scaling_lev" else NCOL)
        kw = dict(kw, metric_scaling=torch.from_numpy(np.random.default_rng(6).uniform(0.9, 1.1, shape)))
    w = _weights(3)
    assert tmod.grad_chunk(t[wave], ta) == NCOL  # one chunk on the CPU

    def grads():
        leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves((ta, tb))]
        a, b = tree_unflatten((ta, tb), leaves)
        flux = make(t[wave], **kw)(a, b)
        loss = sum((x * torch.from_numpy(wi)).sum() for x, wi in zip(flux, w))
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    whole = grads()
    monkeypatch.setattr(tmod, "grad_chunk", lambda lkp, as_: 5)
    chunked = grads()
    vmr_leaf = [i for i, x in enumerate(tree_leaves((ta, tb))) if x is (ta.vmr.vmr)]
    assert vmr_leaf
    for i, (g, c) in enumerate(zip(whole, chunked)):
        if g is None:
            assert c is None
            continue
        scale = g.abs().max().item()
        assert (g - c).abs().max().item() <= 1e-12 * max(scale, 1e-300), i
    g_vmr = whole[vmr_leaf[0]]
    assert g_vmr.abs().max() > 0.0


def test_gradients_reach_every_state_and_bc_tensor():
    """Every floating tensor of the state and the BCs that requires grad gets
    a gradient (zero where the solve does not read it); a tensor that does
    not require grad gets none."""
    j, t = _lookups(np.float64, aerosols=True)
    _, ta = _atmosphere(np.float64, aerosols=True)
    lw, _ = _bcs(np.float64)
    tb = convert.lw_bcs_from_numpy(**lw, device="cpu")
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in tree_leaves((ta, tb))]
    leaves[0].requires_grad_(False)  # p_lay
    a, b = tree_unflatten((ta, tb), leaves)
    flux = tmod.differentiable_solve_lw(t["lw"], lkp_aero=t["aero"])(a, b)
    flux.flux_up[-1].sum().backward()
    assert leaves[0].grad is None
    for x in leaves[1:]:
        if x.requires_grad:
            assert x.grad is not None and torch.isfinite(x.grad).all()
    assert torch.all(a.p_lev.grad == 0.0)  # col_dry given: p_lev is not read
    assert leaves[1].grad.abs().max() > 0  # t_lay
    assert b.sfc_emis.grad.abs().max() > 0
    assert a.aerosol_state.aero_mass.grad.abs().max() > 0


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_gradcheck_through_gas_optics_and_composition(wave):
    """torch.autograd.gradcheck, f64, 3 layers x 2 columns x 8 g-points:
    differentiable_solve through the gas optics and the aerosol composition,
    and solve_lw / solve_sw(impl="torch") with clouds under an explicit mask.
    Temperatures are moved off the table knots, where a finite difference
    straddles a kink, and the column ends at 10 hPa: in thinner layers the
    derivative of the Clough factor cancels (see LW_P_LAY_TOL)."""
    nlay, ncol, ngpt, nbnd = 3, 2, 8, 2
    lkp = jsyn.synthetic_gas_lookup(longwave=wave == "lw", n_gpt=ngpt, n_bnd=nbnd, seed=2, dtype=np.float64)
    lkp = convert.gas_lookup_from_object(lkp, device="cpu")
    cld = convert.cloud_lookup_from_object(jsyn.synthetic_cloud_lookup(n_bnd=nbnd), device="cpu")
    aero = convert.aerosol_lookup_from_object(jsyn.synthetic_aerosol_lookup(n_bnd=nbnd), device="cpu")
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float64, with_clouds=True, p_top=1000.0)
    ta = convert.atmosphere_from_object(ja, device="cpu")
    rng = np.random.default_rng(4)
    jit = lambda x, lo, hi: x + torch.from_numpy(rng.uniform(lo, hi, tuple(x.shape)))
    ta = dataclasses.replace(
        ta, t_lay=jit(ta.t_lay, 0.2, 0.7), t_lev=jit(ta.t_lev, 0.2, 0.7), t_sfc=jit(ta.t_sfc, 0.2, 0.7),
        rel_hum=torch.from_numpy(rng.uniform(0.1, 0.9, (nlay, ncol))),
        aerosol_state=AerosolState(aero_size=torch.from_numpy(rng.uniform(0.1, 8.0, (15, nlay, ncol))),
                                   aero_mass=torch.from_numpy(rng.uniform(1e-6, 2e-5, (15, nlay, ncol)))),
        cloud_state=dataclasses.replace(ta.cloud_state, cld_path_liq=ta.cloud_state.cld_path_liq + 20.0,
                                        cld_r_eff_liq=ta.cloud_state.cld_r_eff_liq + 6.3,
                                        cld_path_ice=ta.cloud_state.cld_path_ice + 10.0,
                                        cld_r_eff_ice=ta.cloud_state.cld_r_eff_ice + 20.1))
    if wave == "lw":
        tb = convert.lw_bcs_from_numpy(sfc_emis=rng.uniform(0.85, 0.99, (nbnd, ncol)), device="cpu")
        make, solve, fields = tmod.differentiable_solve_lw, tmod.solve_lw, ("sfc_emis",)
        kw = dict(two_stream=True)
    else:
        tb = convert.sw_bcs_from_numpy(cos_zenith=np.array([0.4, 0.8]), toa_flux=np.array([1361.0, 1300.0]),
                                       sfc_alb_direct=rng.uniform(0.1, 0.3, (nbnd, ncol)),
                                       sfc_alb_diffuse=rng.uniform(0.1, 0.3, (nbnd, ncol)), device="cpu")
        make, solve, fields = tmod.differentiable_solve_sw, tmod.solve_sw, ("cos_zenith", "sfc_alb_direct")
        kw = {}
    names = ("t_lay", "t_lev", "p_lay") + fields
    mask = torch.from_numpy(np.random.default_rng(1).random((nlay, ncol, ngpt)) < 0.5)

    def inputs(atm, bcs, xs):
        vals = dict(zip(names + ("aero_mass", "cld_path_liq"), xs))
        atm = dataclasses.replace(atm, **{k: vals[k] for k in ("t_lay", "t_lev", "p_lay")},
                                  aerosol_state=dataclasses.replace(atm.aerosol_state, aero_mass=vals["aero_mass"]),
                                  cloud_state=dataclasses.replace(atm.cloud_state, cld_path_liq=vals["cld_path_liq"]))
        return atm, dataclasses.replace(bcs, **{k: vals[k] for k in fields})

    xs = [(getattr(tb, k) if hasattr(tb, k) else getattr(ta, k)).clone().requires_grad_(True) for k in names]
    xs += [ta.aerosol_state.aero_mass.clone().requires_grad_(True),
           ta.cloud_state.cld_path_liq.clone().requires_grad_(True)]
    f = make(lkp, lkp_aero=aero, **kw)
    assert torch.autograd.gradcheck(lambda *v: tuple(f(*inputs(ta, tb, v))), xs[:-1] + [xs[-1].detach()])
    assert torch.autograd.gradcheck(
        lambda *v: tuple(solve(lkp, *inputs(ta, tb, v), lkp_cld=cld, cld_mask=mask, **kw)[0]), xs)


if __name__ == "__main__":
    # The f32 readings PERF.md quotes: PYTHONPATH=. python tests/test_torch_gradients.py
    jax.config.update("jax_enable_x64", True)
    for (wave, kw), name in zip(DIFF, SOLVE_IDS):
        for k, e in _f32_errors(wave, bool(kw)).items():
            print(name, k, *(f"{n} {'-' if v is None else f'{v:.2e}'}" for n, v in e.items()))
