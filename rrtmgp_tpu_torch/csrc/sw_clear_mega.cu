// Whole clear-sky SW two-stream solve in one kernel.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _sw_mega_kernel (wrapper
//   sw_clear_mega): gas optics with Rayleigh scattering, the PIFM /
//   Meador-Weaver layer coefficients with their energy clamps, the direct
//   beam, the adding recurrence and the g-point sums.
//
// Bound on this card: at 32768 columns x 60 layers x 224 g-points each
//   (layer, column, g-point) reads 12 table values (8 kmajor + 4 Rayleigh,
//   plus 4 kminor per covering minor interval) from tables that stay in L2,
//   does ~150 flops with three exp, one sqrt and two divides, and moves four
//   floats of scratch out and back twice (the adding pass rewrites them in
//   place): ~14 GB through device memory, ~4 ms at 3.35 TB/s. Expected
//   limit: the scratch traffic and load issue, with the transcendentals
//   close behind.
//
// Design: one block per column, one thread per g-point (any ngpt up to
//   1024). The optics loop runs top-down, which is also the direct beam's
//   direction: the beam rides in a register (beam *= exp(-tau/mu0) per
//   layer) and the coefficients go to scratch already multiplied by the beam
//   at the top of their layer. The bottom-up adding pass overwrites the four
//   scratch slots of each layer with what the top-down flux pass needs (as in
//   the TPU kernel), so no (nlev, ncol, ngpt) albedo/source arrays exist.
//   mu0 guarded by eps enters only the beam transmittance; the coefficients
//   see the raw mu0. Level sums are deterministic per-warp partials, as in
//   lw_clear_mega.cu. Night columns are zeroed by the caller.
#include "common.cuh"

namespace rrtmgp {

// Zdunkowski PIFM gammas + Meador-Weaver reflectance/transmittance with the
// energy clamps (rrtmgp_tpu/ops/pallas_rte.py _sw_coeffs); asymmetry g = 0
// for clear sky. T0 = exp(-tau / max(mu0, eps)) is passed in.
__device__ __forceinline__ void sw_coeffs(float tau, float ssa, float mu0, float T0, float& Rdir,
                                          float& Tdir, float& Rdif, float& Tdif) {
  const float eps = FLT_EPSILON;
  const float k_min = 3.4526698300124393e-4f;  // sqrt(eps)
  const float g = 0.f;
  const float gamma1 = (8.f - ssa * (5.f + 3.f * g)) * 0.25f;
  const float gamma2 = 3.f * (ssa * (1.f - g)) * 0.25f;
  const float gamma3 = (2.f - (3.f * mu0) * g) * 0.25f;
  const float gamma4 = 1.f - gamma3;
  const float alpha1 = gamma1 * gamma4 + gamma2 * gamma3;
  const float alpha2 = gamma1 * gamma3 + gamma2 * gamma4;
  const float k = sqrtf(fmaxf((gamma1 - gamma2) * (gamma1 + gamma2), k_min));
  const float e1 = expf(-tau * k);
  const float e2 = e1 * e1;
  const float rt = 1.f / (k * (1.f + e2) + gamma1 * (1.f - e2));
  Rdif = rt * gamma2 * (1.f - e2);
  Tdif = rt * 2.f * k * e1;
  const float k_mu = k * mu0, k_g3 = k * gamma3, k_g4 = k * gamma4;
  const float omk2 = 1.f - k_mu * k_mu;
  const float rt2 = ssa * rt / (fabsf(omk2) >= eps ? omk2 : eps);
  const float rdir = rt2 * ((1.f - k_mu) * (alpha2 + k_g3) - (1.f + k_mu) * (alpha2 - k_g3) * e2 -
                            2.f * (k_g3 - alpha2 * k_mu) * e1 * T0);
  const float tdir = -rt2 * ((1.f + k_mu) * (alpha1 + k_g4) * T0 - (1.f - k_mu) * (alpha1 - k_g4) * e2 * T0 -
                             2.f * (k_g4 + alpha1 * k_mu) * e1);
  Rdir = fmaxf(0.f, fminf(rdir, 1.f - T0));
  Tdir = fmaxf(0.f, fminf(tdir, 1.f - T0 - Rdir));
}

__global__ void sw_clear_mega_kernel(OpticsIn in, Tables tb, Dims d,
                                     const float* __restrict__ mu0_col,   // (ncol,)
                                     const float* __restrict__ toa_gpt,   // (ncol, ngpt)
                                     const float* __restrict__ alb_dir,   // (nbnd, ncol)
                                     const float* __restrict__ alb_dif,   // (nbnd, ncol)
                                     const float* __restrict__ inc_dif,   // (ncol, ngpt) or null
                                     float* __restrict__ s_rdir,          // 4 x (nlay, ncol, ngpt)
                                     float* __restrict__ s_tdir,
                                     float* __restrict__ s_rdif,
                                     float* __restrict__ s_tdif,
                                     float* __restrict__ flux_up,         // 3 x (nlev, ncol)
                                     float* __restrict__ flux_dn,
                                     float* __restrict__ flux_dir) {
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol;
  const LevelSums sums{smem, nlev, (int)(blockDim.x >> 5)};
  const int band = active ? __ldg(tb.gpt2band + g) : 0;
  const float mu0 = __ldg(mu0_col + col);
  const float mu0_safe = fmaxf(mu0, FLT_EPSILON);
  enum { UP = 0, DN_DIF = 1, DIR = 2 };

  // phase 1, top-down: optics + coefficients to scratch, beam in a register
  float beam = active ? __ldg(toa_gpt + (size_t)col * d.ngpt + g) * mu0 : 0.f;
  sums.add(DIR, nlay, beam);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const Cell c = load_cell(in, d, l, col, band);
      // Rayleigh: (tropo side, temperature, eta) interpolation
      const int side = c.lower ? 0 : 1;
      const float r0 = tab(tb.second, d, side, c.jt, c.je1, g) * (1.f - c.fe1) +
                       tab(tb.second, d, side, c.jt, c.je1 + 1, g) * c.fe1;
      const float r1 = tab(tb.second, d, side, c.jt + 1, c.je2, g) * (1.f - c.fe2) +
                       tab(tb.second, d, side, c.jt + 1, c.je2 + 1, g) * c.fe2;
      const float tau_ray = ((1.f - c.ft) * r0 + c.ft * r1) * __ldg(in.ray_factor + c.lc);
      const float tau = fmaxf(tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g) + tau_ray, 0.f);
      const float ssa = tau > 0.f ? tau_ray / tau : 0.f;
      const float T0 = expf(-tau / mu0_safe);
      float Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(tau, ssa, mu0, T0, Rdir, Tdir, Rdif, Tdif);
      const size_t s = c.lc * d.ngpt + g;
      s_rdir[s] = Rdir * beam;
      s_tdir[s] = Tdir * beam;
      s_rdif[s] = Rdif;
      s_tdif[s] = Tdif;
      beam *= T0;
    }
    sums.add(DIR, l, beam);
  }

  // phase 2, bottom-up adding. Afterwards layer l's slots hold:
  // rdif = denom*(Rdif*src_l + Tdir*beam), tdif = Tdif*denom, and rdir/tdir
  // the albedo/source at level l+1.
  const float alb0 = active ? __ldg(alb_dif + (size_t)band * ncol + col) : 0.f;
  const float src0 = active ? beam * __ldg(alb_dir + (size_t)band * ncol + col) : 0.f;
  float alb = alb0, src = src0;
  if (active) {
    for (int l = 0; l < nlay; ++l) {
      const size_t s = ((size_t)l * ncol + col) * d.ngpt + g;
      const float Rdif = s_rdif[s], Tdif = s_tdif[s], tdird = s_tdir[s];
      const float denom = 1.f / (1.f - Rdif * alb);
      const float alb_n = Rdif + Tdif * Tdif * alb * denom;
      const float src_n = s_rdir[s] + Tdif * denom * (src + alb * tdird);
      s_rdif[s] = denom * (Rdif * src + tdird);
      s_tdif[s] = Tdif * denom;
      s_rdir[s] = alb_n;
      s_tdir[s] = src_n;
      alb = alb_n;
      src = src_n;
    }
  }

  // phase 3, top-down diffuse flux
  float fd = (active && inc_dif != nullptr) ? inc_dif[(size_t)col * d.ngpt + g] : 0.f;
  sums.add(UP, nlay, active ? fd * alb + src : 0.f);
  sums.add(DN_DIF, nlay, fd);
  for (int l = nlay - 1; l >= 0; --l) {
    float up = 0.f;
    if (active) {
      const size_t s = ((size_t)l * ncol + col) * d.ngpt + g;
      fd = s_tdif[s] * fd + s_rdif[s];
      const size_t below = s - (size_t)ncol * d.ngpt;
      const float alb_l = l == 0 ? alb0 : s_rdir[below];
      const float src_l = l == 0 ? src0 : s_tdir[below];
      up = fd * alb_l + src_l;
    }
    sums.add(UP, l, up);
    sums.add(DN_DIF, l, fd);
  }

  __syncthreads();
  for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
    const size_t o = (size_t)lev * ncol + col;
    const float dir = sums.total(DIR, lev);
    flux_up[o] = sums.total(UP, lev);
    flux_dn[o] = sums.total(DN_DIF, lev) + dir;
    flux_dir[o] = dir;
  }
}

}  // namespace rrtmgp

extern "C" int rrtmgp_sw_clear_mega(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* ray_factor,
    const void* kmajor, const void* rayl, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* mu0, const void* toa_gpt, const void* alb_dir, const void* alb_dif, const void* inc_dif,
    void* s_rdir, void* s_tdir, void* s_rdif, void* s_tdif,
    void* flux_up, void* flux_dn, void* flux_dir,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, (const float*)ray_factor};
  const Tables tb{(const float*)kmajor, (const float*)rayl, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  const MegaLaunch m = mega_launch(d, 3);
  cudaError_t err = prepare_smem(sw_clear_mega_kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  sw_clear_mega_kernel<<<m.grid, m.block, m.smem, (cudaStream_t)stream>>>(
      in, tb, d, (const float*)mu0, (const float*)toa_gpt, (const float*)alb_dir, (const float*)alb_dif,
      (const float*)inc_dif, (float*)s_rdir, (float*)s_tdir, (float*)s_rdif, (float*)s_tdif,
      (float*)flux_up, (float*)flux_dn, (float*)flux_dir);
  return (int)cudaGetLastError();
}
