// SW two-stream device code shared by the SW megakernel (sw_clear_mega.cu)
// and the SW sweeps from materialized optics (sw_2stream_reduced.cu): the
// layer coefficients (every SW kernel), and two designs of the passes after
// the top-down beam, for a kernel of one thread per g-point that carried
// the direct beam top-down in a register:
// - four-array passes (sw_adding_and_fluxes): the top-down pass left, per
//   layer, Rdir * beam, Tdir * beam, Rdif and Tdif in four state arrays,
//   which the adding pass rewrites for the flux pass (the SW megakernel's
//   all-sky variants);
// - recomputed passes (sw_recomputed_passes): the top-down pass left the
//   beam at each layer's top; the adding and the flux pass compute the
//   coefficients again from tau and ssa (asymmetry 0), two more state
//   arrays (the SW megakernel on clear sky, which stores its tau and ssa
//   beside the beam; the g-summed sweep, the TPU kernel's design, runs the
//   same passes with an optional asymmetry inline in sw_2stream_reduced.cu,
//   where a call cost it registers and time, PERF.md, and so does its
//   per-g-point sweep).
// Both use the same expressions in the same order, so every path agrees to
// the last bit on equal optics.
#pragma once

#include "common.cuh"

namespace rrtmgp {

// Fields of the SW level sums.
enum SwField { SW_UP = 0, SW_DN_DIF = 1, SW_DIR = 2 };

// Zdunkowski PIFM gammas + Meador-Weaver reflectance/transmittance with the
// energy clamps (rrtmgp_tpu/ops/pallas_rte.py _sw_coeffs); a clear-sky
// kernel passes asymmetry g = 0. T0 = exp(-tau / max(mu0, eps)) is passed in.
// The real type R is a template parameter, deduced from the arguments.
template <typename R>
__device__ __forceinline__ void sw_coeffs(R tau, R ssa, R g, R mu0, R T0, R& Rdir, R& Tdir, R& Rdif, R& Tdif) {
  const R eps = r_eps<R>();
  const R k_min = r_sqrt_eps<R>();
  const R one = R(1), two = R(2), three = R(3), quarter = R(0.25);
  const R gamma1 = (R(8) - ssa * (R(5) + three * g)) * quarter;
  const R gamma2 = three * (ssa * (one - g)) * quarter;
  const R gamma3 = (two - (three * mu0) * g) * quarter;
  const R gamma4 = one - gamma3;
  const R alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const R alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const R k = r_sqrt(r_max((gamma1 - gamma2) * (gamma1 + gamma2), k_min));
  const R e1 = r_exp(-tau * k);
  const R e2 = e1 * e1;
  const R rt = one / (k * (one + e2) + gamma1 * (one - e2));
  Rdif = rt * gamma2 * (one - e2);
  Tdif = rt * two * k * e1;
  const R k_mu = k * mu0, k_g3 = k * gamma3, k_g4 = k * gamma4;
  const R omk2 = one - k_mu * k_mu;
  const R rt2 = ssa * rt / (r_abs(omk2) >= eps ? omk2 : eps);
  const R rdir = rt2 * ((one - k_mu) * (alpha2 + k_g3) - (one + k_mu) * (alpha2 - k_g3) * e2 -
                        two * (k_g3 - alpha2 * k_mu) * e1 * T0);
  const R tdir = -rt2 * ((one + k_mu) * (alpha1 + k_g4) * T0 - (one - k_mu) * (alpha1 - k_g4) * e2 * T0 -
                         two * (k_g4 + alpha1 * k_mu) * e1);
  Rdir = r_max(R(0), r_min(rdir, one - T0));
  Tdir = r_max(R(0), r_min(tdir, one - T0 - Rdir));
}

// The passes after the top-down optics pass, for the thread of g-point g of
// column col (every thread of the block calls it; idle threads add zeros).
// On entry the state holds, per layer, Rdir * beam, Tdir * beam (beam at
// the top of the layer), Rdif and Tdif; `beam` is the direct beam at the
// surface, and the SW_DIR sums of every level are already added. The state
// is four (nlay, ncol, ngpt) arrays in device memory; rdir, tdir, rdif and
// tdif point to the thread's (col, g) in each, layer l at [l * ncol * ngpt].
//   bottom-up adding: layer l's slots become rdif = denom * (Rdif * src_l +
//     Tdir * beam), tdif = Tdif * denom, and rdir / tdir the albedo / source
//     at level l + 1, so no (nlev, ncol, ngpt) arrays exist;
//   top-down diffuse flux with the SW_UP and SW_DN_DIF sums;
//   then, with the sums in the block (LevelSumsT), the block writes flux_up,
//   flux_dn (diffuse + direct) and flux_dir, each (nlev, ncol); partials
//   across blocks are completed by finish_level_sums (SUMS_SW).
template <typename R, typename Sums>
__device__ __forceinline__ void sw_adding_and_fluxes(const Dims& d, const Sums& sums, int col, int g, bool active,
                                                     int band, R beam,
                                                     const R* __restrict__ alb_dir,  // (nbnd, ncol)
                                                     const R* __restrict__ alb_dif,  // (nbnd, ncol)
                                                     const R* __restrict__ inc_dif,  // (ncol, ngpt) or null
                                                     R* rdir, R* tdir, R* rdif, R* tdif,  // the state
                                                     R* __restrict__ flux_up, R* __restrict__ flux_dn,
                                                     R* __restrict__ flux_dir) {
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol;
  // the state's layer l of (col, g) at l * fstride (+ g0)
  const size_t fstride = (size_t)ncol * d.ngpt, g0 = (size_t)col * d.ngpt + g;
  const R alb0 = active ? __ldg(alb_dif + (size_t)band * ncol + col) : R(0);
  const R src0 = active ? beam * __ldg(alb_dir + (size_t)band * ncol + col) : R(0);
  R alb = alb0, src = src0;
  if (active) {
    for (int l = 0; l < nlay; ++l) {
      const size_t s = (size_t)l * fstride;
      const R Rdif = rdif[s], Tdif = tdif[s], tdird = tdir[s];
      const R denom = R(1) / (R(1) - Rdif * alb);
      const R alb_n = Rdif + Tdif * Tdif * alb * denom;
      const R src_n = rdir[s] + Tdif * denom * (src + alb * tdird);
      rdif[s] = denom * (Rdif * src + tdird);
      tdif[s] = Tdif * denom;
      rdir[s] = alb_n;
      tdir[s] = src_n;
      alb = alb_n;
      src = src_n;
    }
  }

  R fd = (active && inc_dif != nullptr) ? inc_dif[g0] : R(0);
  sums.add(SW_UP, nlay, active ? fd * alb + src : R(0));
  sums.add(SW_DN_DIF, nlay, fd);
  for (int l = nlay - 1; l >= 0; --l) {
    R up = R(0);
    if (active) {
      const size_t s = (size_t)l * fstride;
      fd = tdif[s] * fd + rdif[s];
      const R alb_l = l == 0 ? alb0 : rdir[s - fstride];
      const R src_l = l == 0 ? src0 : tdir[s - fstride];
      up = fd * alb_l + src_l;
    }
    sums.add(SW_UP, l, up);
    sums.add(SW_DN_DIF, l, fd);
  }

  if constexpr (std::is_same<Sums, LevelSumsT<R>>::value) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      const size_t o = (size_t)lev * ncol + col;
      const R dir = sums.total(SW_DIR, lev);
      flux_up[o] = sums.total(SW_UP, lev);
      flux_dn[o] = sums.total(SW_DN_DIF, lev) + dir;
      flux_dir[o] = dir;
    }
  }
}

// The recomputed passes (sw_2stream_reduced.cu's passes 2 and 3 without an
// asymmetry, the same expressions) for the thread of g-point g0 = col *
// ngpt + g (every thread of the block calls it; idle threads add zeros).
// Its (nlay, ncol, ngpt) slots, written earlier by the same kernel, hold per
// layer at [l * stride] tau, ssa and, in beam_p, the direct beam at the
// layer's top; `beam` is the beam at the surface, beam_toa at the top, and
// the SW_DIR sums of every level are added.
//   bottom-up adding: each layer's coefficients from tau, ssa and its
//     stored beam, the adding recurrence in registers, the albedo (over the
//     beam's slot, which is read first) and the source at the layer's
//     bottom level stored;
//   top-down flux: the coefficients, the beam (beam *= T0, the top-down
//     pass's order) and the adding denominator computed again, the diffuse
//     flux folded as sw_adding_and_fluxes folds it (tdif' = Tdif * denom,
//     rdif' = denom * (Rdif * src + Tdir * beam), fd = tdif' * fd + rdif'),
//     and the SW_UP / SW_DN_DIF sums;
//   then, with the sums in the block (LevelSumsT), the block writes
//   flux_up, flux_dn (diffuse + direct) and flux_dir, each (nlev, ncol);
//   partials across blocks are completed by finish_level_sums (SUMS_SW).
// Each pass reads the next layer's values one layer ahead, so that the
// loads overlap the layer's arithmetic.
template <typename R, typename Sums>
__device__ __forceinline__ void sw_recomputed_passes(const Dims& d, const Sums& sums, int col, bool active, int band,
                                                     R mu0, R mu0_safe, R beam_toa, R beam,
                                                     const R* __restrict__ alb_dir,  // (nbnd, ncol)
                                                     const R* __restrict__ alb_dif,  // (nbnd, ncol)
                                                     const R* __restrict__ inc_dif,  // (ncol, ngpt) or null
                                                     size_t g0, size_t stride, const R* tau_p, const R* ssa_p,
                                                     R* beam_p, R* __restrict__ src_p, R* __restrict__ flux_up,
                                                     R* __restrict__ flux_dn, R* __restrict__ flux_dir) {
  R* alb_p = beam_p;
  const int nlay = d.nlay;
  R alb = active ? __ldg(alb_dif + (size_t)band * d.ncol + col) : R(0);
  R src = active ? beam * __ldg(alb_dir + (size_t)band * d.ncol + col) : R(0);
  if (active && nlay > 0) {
    R t_n = tau_p[0], w_n = ssa_p[0], bt_n = beam_p[0];
    for (int l = 0; l < nlay; ++l) {
      const size_t s = (size_t)l * stride;
      const R t = t_n, w = w_n, bt = bt_n;
      if (l + 1 < nlay) {
        t_n = tau_p[s + stride];
        w_n = ssa_p[s + stride];
        bt_n = beam_p[s + stride];
      }
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, w, R(0), mu0, r_exp(-t / mu0_safe), Rdir, Tdir, Rdif, Tdif);
      alb_p[s] = alb;
      src_p[s] = src;
      const R denom = R(1) / (R(1) - Rdif * alb);
      const R alb_n = Rdif + Tdif * Tdif * alb * denom;
      const R src_n = Rdir * bt + Tdif * denom * (src + alb * (Tdir * bt));
      alb = alb_n;
      src = src_n;
    }
  }

  R fd = (active && inc_dif != nullptr) ? inc_dif[g0] : R(0);
  sums.add(SW_UP, nlay, active ? fd * alb + src : R(0));
  sums.add(SW_DN_DIF, nlay, fd);
  beam = beam_toa;
  R t_n = R(0), w_n = R(0), a_n = R(0), c_n = R(0);
  if (active && nlay > 0) {
    const size_t s = (size_t)(nlay - 1) * stride;
    t_n = tau_p[s];
    w_n = ssa_p[s];
    a_n = alb_p[s];
    c_n = src_p[s];
  }
  for (int l = nlay - 1; l >= 0; --l) {
    R up = R(0);
    if (active) {
      const size_t s = (size_t)l * stride;
      const R t = t_n, w = w_n, alb_l = a_n, src_l = c_n;
      if (l > 0) {
        t_n = tau_p[s - stride];
        w_n = ssa_p[s - stride];
        a_n = alb_p[s - stride];
        c_n = src_p[s - stride];
      }
      const R T0 = r_exp(-t / mu0_safe);
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, w, R(0), mu0, T0, Rdir, Tdir, Rdif, Tdif);
      const R denom = R(1) / (R(1) - Rdif * alb_l);
      fd = (Tdif * denom) * fd + denom * (Rdif * src_l + Tdir * beam);
      up = fd * alb_l + src_l;
      beam *= T0;
    }
    sums.add(SW_UP, l, up);
    sums.add(SW_DN_DIF, l, fd);
  }

  if constexpr (std::is_same<Sums, LevelSumsT<R>>::value) {
    __syncthreads();
    for (int lev = threadIdx.x; lev <= nlay; lev += blockDim.x) {
      const size_t o = (size_t)lev * d.ncol + col;
      const R dir = sums.total(SW_DIR, lev);
      flux_up[o] = sums.total(SW_UP, lev);
      flux_dn[o] = sums.total(SW_DN_DIF, lev) + dir;
      flux_dir[o] = dir;
    }
  }
}

}  // namespace rrtmgp
