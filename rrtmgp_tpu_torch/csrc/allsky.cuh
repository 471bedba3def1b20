// Cloud and aerosol composition shared by the megakernels (lw2_mega.cu,
// sw_clear_mega.cu, lw_clear_mega.cu): the inputs of one all-sky solve, the
// two-stream increment in the operation order of the plain twins
// (ops/cloud_optics.py increment_2stream), and the absorption-only
// increment of the LW no-scattering solve.
//
// Layouts: cloud band properties (nlay, ncol, nbnd), as ops/cloud_optics.py
// cloud_optics_bands returns them; aerosol band properties (nlay, nbnd,
// ncol), as the aerosol_bands kernel writes them; the cloud mask (nlay, ncol,
// ngpt) and the aerosol active mask (nlay, ncol) one byte each.
#pragma once

#include <cfloat>

#include "mcica.cuh"

namespace rrtmgp {

// What a megakernel launch composes: MASK_NONE (clear sky), MASK_GIVEN (a
// cloud mask from the caller) or MASK_SEED (McICA drawn in the kernel).
enum MaskMode { MASK_NONE = 0, MASK_GIVEN = 1, MASK_SEED = 2 };

struct AllSkyIn {
  const float* ctau;             // cloud tau, ssa, g: (nlay, ncol, nbnd)
  const float* cssa;
  const float* cg;
  const unsigned char* cmask;    // (nlay, ncol, ngpt), MASK_GIVEN
  const float* cld_frac;         // (nlay, ncol), MASK_SEED
  Key2x32 seed;                  // MASK_SEED
  long long col_offset;          // global index of column 0, MASK_SEED
  const float* atau;             // aerosol tau, ssa, g: (nlay, nbnd, ncol)
  const float* assa;
  const float* ag;
  const unsigned char* amask;    // (nlay, ncol)
};

// (tau, ssa, g) += (t2, s2, g2) in the two-stream sense.
__device__ __forceinline__ void increment_2stream(float& tau, float& ssa, float& g, float t2, float s2,
                                                  float g2) {
  const float eps = FLT_EPSILON;
  const float tau_n = tau + t2;
  const float ssa_w = tau * ssa + t2 * s2;
  const float g_n = (tau * ssa * g + t2 * s2 * g2) / fmaxf(eps, ssa_w);
  ssa = ssa_w / fmaxf(eps, tau_n);
  tau = tau_n;
  g = g_n;
}

// Cloud composition of one (layer, column, g-point) under its mask bit.
__device__ __forceinline__ void add_cloud(const AllSkyIn& a, size_t lc, int nbnd, int band, bool m,
                                          float& tau, float& ssa, float& g) {
  if (!m) return;
  const size_t cb = lc * nbnd + band;
  increment_2stream(tau, ssa, g, __ldg(a.ctau + cb), __ldg(a.cssa + cb), __ldg(a.cg + cb));
}

// Aerosol composition of one (layer, column, g-point) where the layer
// carries aerosol.
__device__ __forceinline__ void add_aerosol(const AllSkyIn& a, int l, int col, int ncol, size_t lc, int nbnd,
                                            int band, float& tau, float& ssa, float& g) {
  if (__ldg(a.amask + lc) == 0) return;
  const size_t ab = ((size_t)l * nbnd + band) * ncol + col;
  increment_2stream(tau, ssa, g, __ldg(a.atau + ab), __ldg(a.assa + ab), __ldg(a.ag + ab));
}

// Absorption-only composition of the no-scattering solve: the optical depth
// grows by the absorbing part tau_x - ssa_x * tau_x of the cloud (under its
// mask bit) and of the aerosol (where the layer carries aerosol); the
// asymmetry is not read.
__device__ __forceinline__ void add_cloud_absorption(const AllSkyIn& a, size_t lc, int nbnd, int band, bool m,
                                                     float& tau) {
  if (!m) return;
  const size_t cb = lc * nbnd + band;
  const float t = __ldg(a.ctau + cb);
  tau += t - __ldg(a.cssa + cb) * t;
}

__device__ __forceinline__ void add_aerosol_absorption(const AllSkyIn& a, int l, int col, int ncol, size_t lc,
                                                       int nbnd, int band, float& tau) {
  if (__ldg(a.amask + lc) == 0) return;
  const size_t ab = ((size_t)l * nbnd + band) * ncol + col;
  const float t = __ldg(a.atau + ab);
  tau += t - __ldg(a.assa + ab) * t;
}

}  // namespace rrtmgp
