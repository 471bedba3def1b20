"""Cloud optics and the McICA cloud mask in plain torch (counterpart of
``rrtmgp_tpu/ops/cloud_optics.py``).

- ``cloud_optics_bands``: liquid/ice table interpolation in effective radius
  for every band at once, by a gather on the radius grid (the JAX package's
  one-hot matrix product is TPU-only structure); ``cloud_optics_band``,
  one band of it;
- ``delta_scale``, ``increment_2stream``: two-stream property algebra;
- ``build_cloud_mask_mcica``: the max-random-overlap McICA mask drawn from
  the JAX package's off-TPU threefry stream (``ops.threefry``), bit for bit:
  with ``col_offset`` each column's key is ``fold_in(seed key, col_offset +
  column)``, so the mask is a pure function of (seed, global column) and
  invariant to column splits. The CUDA kernels draw the same stream
  (``csrc/mcica.cuh``). It differs from the JAX package's TPU kernels, which
  draw from the TPU's own generator.
"""

from __future__ import annotations

import torch

from ..data.lookups import CloudLookup
from ..states import CloudState
from . import threefry
from .bounds import at_least


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def delta_scale(tau, ssa, g):
    """Delta-scaling of two-stream properties."""
    eps = _eps(tau.dtype)
    f = g * g
    wf = ssa * f
    tau_s = (1.0 - wf) * tau
    ssa_s = (ssa - wf) / at_least(1.0 - wf, eps)
    g_s = (g - f) / at_least(1.0 - f, eps)
    return tau_s, ssa_s, g_s


def increment_2stream(tau1, ssa1, g1, tau2, ssa2, g2):
    """Combine two sets of two-stream optical properties."""
    eps = _eps(tau1.dtype)
    tau = tau1 + tau2
    ssa_w = tau1 * ssa1 + tau2 * ssa2
    g_out = (tau1 * ssa1 * g1 + tau2 * ssa2 * g2) / at_least(ssa_w, eps)
    ssa_out = ssa_w / at_least(tau, eps)
    return tau, ssa_out, g_out


def compose_2stream(tau, ssa, g, tau2, ssa2, g2, mask):
    """(tau, ssa, g) incremented by (tau2, ssa2, g2) where ``mask`` holds,
    unchanged elsewhere."""
    tn, sn, gn = increment_2stream(tau, ssa, g, tau2, ssa2, g2)
    return torch.where(mask, tn, tau), torch.where(mask, sn, ssa), torch.where(mask, gn, g)


def _rad_interp_bands(table, re, path, rad_lwr, rad_upr, nsize):
    """Linear interpolation of (ext, ssa, asy) in effective radius for all
    bands; table (3, nsize, nbnd), re/path (nlay, ncol). Returns (tau,
    tau*ssa, tau*ssa*g), each (nlay, ncol, nbnd), zero where path <= eps."""
    eps = _eps(re.dtype)
    dr = (rad_upr - rad_lwr) / (nsize - 1)
    re_c = torch.minimum(torch.maximum(re, rad_lwr), rad_upr)
    loc = torch.clamp(torch.floor((re_c - rad_lwr) / dr), 0, nsize - 2).to(torch.int64)
    fac = ((re_c - rad_lwr - loc * dr) / dr)[..., None]
    fc1 = 1.0 - fac
    lo, hi = table[:, loc], table[:, loc + 1]  # (3, nlay, ncol, nbnd)
    ext = fc1 * lo[0] + fac * hi[0]
    ssa = fc1 * lo[1] + fac * hi[1]
    asy = fc1 * lo[2] + fac * hi[2]
    tau = at_least(ext * path[..., None], 0.0)
    tau_ssa = ssa * tau
    tau_ssag = asy * tau_ssa
    active = (path > eps)[..., None]
    return (
        torch.where(active, tau, 0.0),
        torch.where(active, tau_ssa, 0.0),
        torch.where(active, tau_ssag, 0.0),
    )


def cloud_optics_bands(lkp: CloudLookup, cs: CloudState):
    """Cloud two-stream properties (tau, ssa, g) for all bands, each
    (nlay, ncol, nbnd)."""
    eps = _eps(cs.cld_path_liq.dtype)
    tl, tl_ssa, tl_ssag = _rad_interp_bands(
        lkp.liq, cs.cld_r_eff_liq, cs.cld_path_liq,
        lkp.radliq_lwr, lkp.radliq_upr, lkp.nsize_liq,
    )
    ti, ti_ssa, ti_ssag = _rad_interp_bands(
        lkp.ice[:, :, :, cs.ice_rgh - 1], cs.cld_r_eff_ice, cs.cld_path_ice,
        lkp.radice_lwr, lkp.radice_upr, lkp.nsize_ice,
    )
    tau_c = tl + ti
    ssa_c = tl_ssa + ti_ssa
    g_c = (tl_ssag + ti_ssag) / at_least(ssa_c, eps)
    ssa_c = ssa_c / at_least(tau_c, eps)
    return tau_c, ssa_c, g_c


def cloud_optics_band(lkp: CloudLookup, cs: CloudState, ibnd: int):
    """Cloud two-stream properties (tau, ssa, g) of band ``ibnd``, each
    (nlay, ncol): that band of ``cloud_optics_bands``."""
    return tuple(x[..., ibnd] for x in cloud_optics_bands(lkp, cs))


# ---------------------------------------------------------------------------
# McICA cloud mask
# ---------------------------------------------------------------------------


def mcica_layer_uniforms(seed: int, nlay: int, ncol: int, n_gpt: int,
                         col_offset: int | None, dtype, device):
    """A function l -> the (ncol, n_gpt) McICA uniforms of layer l: the
    draws of ``jax.random.uniform`` with per-column keys
    ``fold_in(key(seed), col_offset + c)`` over a (nlay, n_gpt) shape, or,
    with ``col_offset=None``, one key over (nlay, ncol, n_gpt)."""
    key = threefry.seed_key(seed)
    g = torch.arange(n_gpt, dtype=torch.int64, device=device)
    if col_offset is None:
        c = torch.arange(ncol, dtype=torch.int64, device=device)[:, None]
        return lambda l: threefry.uniform_from_counter(key, (l * ncol + c) * n_gpt + g, dtype)
    cols = torch.arange(ncol, dtype=torch.int64, device=device) + int(col_offset)
    k0, k1 = threefry.fold_in(key, cols & threefry.M32)
    ck = (k0[:, None], k1[:, None])
    return lambda l: threefry.uniform_from_counter(ck, l * n_gpt + g, dtype)


def mcica_sample(cld_frac: torch.Tensor, n_gpt: int, seed: int, col_offset: int | None = None):
    """Max-random-overlap McICA sample: (u, mask), the raw uniforms and the
    mask, each (nlay, ncol, n_gpt) (mask bool). The recurrence runs from the
    top layer down over the layers with cloud:

      u_eff = u                                  above the first cloudy layer
      u_eff = u_eff(above)                       below a masked layer
      u_eff = u * (1 - cf(above))                below an unmasked layer
      mask  = (cf > 0) & (u_eff >= 1 - cf)
    """
    nlay, ncol = cld_frac.shape
    dtype, dev = cld_frac.dtype, cld_frac.device
    draw = mcica_layer_uniforms(seed, nlay, ncol, n_gpt, col_offset, dtype, dev)
    u_all = torch.empty((nlay, ncol, n_gpt), dtype=dtype, device=dev)
    masks = torch.empty((nlay, ncol, n_gpt), dtype=torch.bool, device=dev)
    u_above = torch.zeros((ncol, n_gpt), dtype=dtype, device=dev)
    mask_above = torch.zeros((ncol, n_gpt), dtype=torch.bool, device=dev)
    cf_above = torch.zeros((ncol, 1), dtype=dtype, device=dev)
    started = torch.zeros((ncol, 1), dtype=torch.bool, device=dev)
    for l in range(nlay - 1, -1, -1):
        u_i = draw(l)
        cf_i = cld_frac[l][:, None]
        u_eff = torch.where(
            started, torch.where(mask_above, u_above, u_i * (1.0 - cf_above)), u_i
        )
        cloudy = cf_i > 0.0
        mask_i = cloudy & (u_eff >= (1.0 - cf_i))
        u_all[l], masks[l] = u_i, mask_i
        u_above, mask_above, cf_above, started = u_eff, mask_i, cf_i, started | cloudy
    return u_all, masks


def build_cloud_mask_mcica(cld_frac: torch.Tensor, n_gpt: int, seed: int,
                           col_offset: int | None = None) -> torch.Tensor:
    """Max-random-overlap McICA cloud mask, (nlay, ncol, n_gpt) bool, equal
    bit for bit to the JAX package's
    ``build_cloud_mask_mcica(jax.random.key(seed), cld_frac, n_gpt,
    col_offset)``."""
    return mcica_sample(cld_frac, n_gpt, seed, col_offset)[1]


def cloud_cover_from_mask(cld_mask: torch.Tensor) -> torch.Tensor:
    """McICA cloud cover per column: the fraction of g-points with any cloudy
    layer, f32 (ncol,). The count is divided by the g-point count, correctly
    rounded as ``jnp.mean`` and the kernels do; torch on CUDA multiplies by
    the reciprocal for ``mean`` and for division by a Python number, which
    can differ by an ulp, so the divisor is a tensor."""
    count = cld_mask.any(dim=0).sum(dim=-1, dtype=torch.float32)
    return count / torch.full_like(count, cld_mask.shape[-1])
