// LW two-stream device code shared by the LW two-stream megakernel
// (lw2_mega.cu) and the LW two-stream sweep from materialized optics
// (lw_2stream_reduced.cu): the layer coefficients. Both kernels fold them
// into the adding recurrence with the same expressions in the same order, so
// the two paths agree to the last bit on equal optics and sources.
#pragma once

#include "common.cuh"

namespace rrtmgp {

// Meador-Weaver diffuse R/T + Toon linear-in-tau sources, in the order of
// ops/rte.py lw_2stream_coeffs. lev_bot / lev_top are the level Planck
// sources at the bottom and the top of the layer. The real type R is a
// template parameter, deduced from the arguments.
template <typename R>
__device__ __forceinline__ void lw2_coeffs(R tau, R ssa, R g, R lev_bot, R lev_top, R& Rdif, R& Tdif, R& src_up,
                                           R& src_dn) {
  const R eps = r_eps<R>();
  const R k_min = r_sqrt_eps<R>();
  const R tau_thresh = R(100) * eps;
  const R one = R(1), two = R(2), half = R(0.5);
  const R diff_sec = R(1.66);
  const R half_diff_sec = R(1.66 * 0.5);
  const R pi = R(3.14159265358979323846);
  const R gamma1 = diff_sec * (one - half * ssa * (one + g));
  const R gamma2 = half_diff_sec * ssa * (one - g);
  const R k = r_sqrt(r_max((gamma1 + gamma2) * (gamma1 - gamma2), k_min));
  const R coeff = r_exp(-two * tau * k);
  const R rt = one / (k * (one + coeff) + gamma1 * (one - coeff));
  Rdif = rt * gamma2 * (one - coeff);
  Tdif = rt * two * k * r_exp(-tau * k);
  const bool big = tau > tau_thresh;
  const R Z = (lev_bot - lev_top) / ((big ? tau : one) * (gamma1 + gamma2));
  const R zup_top = Z + lev_top, zup_bot = Z + lev_bot;
  const R zdn_top = -Z + lev_top, zdn_bot = -Z + lev_bot;
  src_up = big ? pi * (zup_top - Rdif * zdn_top - Tdif * zup_bot) : R(0);
  src_dn = big ? pi * (zdn_bot - Rdif * zup_bot - Tdif * zdn_top) : R(0);
}

}  // namespace rrtmgp
