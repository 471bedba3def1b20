// Whole clear-sky LW no-scattering solve in one kernel.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _lw_mega_kernel (wrapper
//   lw_clear_mega): gas optics (major + minor gases, Planck fraction), the
//   band-Planck Clough sources, the downward radiance, the upward sweep and
//   the g-point sums.
//
// Bound on this card: at 32768 columns x 60 layers x 256 g-points each
//   (layer, column, g-point) reads 16 table values (8 kmajor + 8 Planck
//   fraction, plus 4 kminor per covering minor interval) from ~16 MB of tables
//   that stay in the 50 MB L2, does about a hundred flops with one exp and
//   one sqrt, and writes then re-reads two floats of scratch: 4 GB out and
//   4 GB back through device memory (~2.4 ms at 3.35 TB/s). Expected limit:
//   load issue through L1/L2 and the scratch round trip, not arithmetic.
//
// Design: one block per column, one thread per g-point (any ngpt up to
//   1024; the last warp is padded with idle threads). The layer loop runs
//   top-down in registers: a level source needs the Planck fractions of both
//   adjacent layers, so the downward radiance crosses layer l+1 when layer l's
//   fraction is known, one step behind the optics, as in the TPU kernel. Only
//   the upward sweep needs a second pass, over (trans, src_up) scratch. Level
//   sums are warp shuffles into per-warp shared-memory slots added in a fixed
//   order at the end: deterministic, no atomics. Tables are f32 in
//   g-point-fastest layouts, so one band's threads read neighbouring
//   addresses. Nothing of the TPU blocking is kept: no one-hot contraction,
//   no bf16 hi/lo split, no table windows, no column padding.
#include "common.cuh"

namespace rrtmgp {

__global__ void lw_clear_mega_kernel(OpticsIn in, Tables tb, Dims d,
                                     const float* __restrict__ plk_lay,   // (nbnd, nlay*ncol)
                                     const float* __restrict__ plk_lev,   // (nbnd, nlev*ncol)
                                     const float* __restrict__ plk_sfc,   // (nbnd, ncol)
                                     const float* __restrict__ sfc_emis,  // (nbnd, ncol)
                                     const float* __restrict__ inc_flux,  // (ncol, ngpt) or null
                                     float* __restrict__ trans_s,         // (nlay, ncol, ngpt)
                                     float* __restrict__ sup_s,           // (nlay, ncol, ngpt)
                                     float* __restrict__ flux_up,         // (nlev, ncol)
                                     float* __restrict__ flux_dn,         // (nlev, ncol)
                                     float ds, float i2f) {
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol;
  const LevelSums sums{smem, nlev, (int)(blockDim.x >> 5)};
  const float tau_thresh = 100.f * FLT_EPSILON;
  const int band = active ? __ldg(tb.gpt2band + g) : 0;
  const size_t lay_plane = (size_t)nlay * ncol, lev_plane = (size_t)nlev * ncol;

  float i_dn = 0.f;
  if (active && inc_flux != nullptr) i_dn = inc_flux[(size_t)col * d.ngpt + g] / i2f;
  sums.add(1, nlay, i_dn);

  // state of the layer above (the previous, higher iteration)
  float pf_above = 0.f, trans_above = 0.f, fact_above = 0.f, lay_above = 0.f;
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const Cell c = load_cell(in, d, l, col, band);
      float v0, v1;
      interp_p_eta(tb.second, d, c, g, v0, v1);
      const float pf = (1.f - c.ft) * v0 + c.ft * v1;
      const float tau = fmaxf(tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g), 0.f);

      const float tau_loc = tau * ds;
      const float trans = expf(-tau_loc);
      const float fact = tau_loc > tau_thresh
                             ? (1.f - trans) / tau_loc - trans
                             : tau_loc * (0.5f + tau_loc * (-1.f / 3.f + tau_loc * 0.125f));
      const float lay_val = __ldg(plk_lay + band * lay_plane + c.lc) * pf;
      // level l+1: geometric mean of the adjacent fractions; at the top the
      // neighbour is the layer's own
      const float lev_above = __ldg(plk_lev + band * lev_plane + (size_t)(l + 1) * ncol + col) *
                              (l < nlay - 1 ? sqrtf(pf * pf_above) : pf);
      const float src_up = (1.f - trans) * lev_above + 2.f * fact * (lay_val - lev_above);
      if (l < nlay - 1) {
        // the radiance crosses layer l+1, whose bottom level is now known
        const float src_dn = (1.f - trans_above) * lev_above + 2.f * fact_above * (lay_above - lev_above);
        i_dn = trans_above * i_dn + src_dn;
      }
      const size_t s = c.lc * d.ngpt + g;
      trans_s[s] = trans;
      sup_s[s] = src_up;
      pf_above = pf;
      trans_above = trans;
      fact_above = fact;
      lay_above = lay_val;
    }
    if (l < nlay - 1) sums.add(1, l + 1, i_dn);
  }

  // cross layer 0 (level 0 uses layer 0's own fraction), then the surface
  float i_up = 0.f;
  if (active) {
    const float lev0 = __ldg(plk_lev + band * lev_plane + col) * pf_above;
    i_dn = trans_above * i_dn + ((1.f - trans_above) * lev0 + 2.f * fact_above * (lay_above - lev0));
    const float emis = __ldg(sfc_emis + (size_t)band * ncol + col);
    i_up = i_dn * (1.f - emis) + emis * (__ldg(plk_sfc + (size_t)band * ncol + col) * pf_above);
  }
  sums.add(1, 0, i_dn);
  sums.add(0, 0, i_up);

  for (int l = 0; l < nlay; ++l) {
    if (active) {
      const size_t s = ((size_t)l * ncol + col) * d.ngpt + g;
      i_up = trans_s[s] * i_up + sup_s[s];
    }
    sums.add(0, l + 1, i_up);
  }

  __syncthreads();
  for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
    flux_up[(size_t)lev * ncol + col] = sums.total(0, lev) * i2f;
    flux_dn[(size_t)lev * ncol + col] = sums.total(1, lev) * i2f;
  }
}

}  // namespace rrtmgp

extern "C" int rrtmgp_lw_clear_mega(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kmajor, const void* pfrac, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* plk_lay, const void* plk_lev, const void* plk_sfc, const void* sfc_emis,
    const void* inc_flux, void* trans_s, void* sup_s, void* flux_up, void* flux_dn,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib,
    float ds, float i2f, void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, nullptr};
  const Tables tb{(const float*)kmajor, (const float*)pfrac, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  const MegaLaunch m = mega_launch(d, 2);
  cudaError_t err = prepare_smem(lw_clear_mega_kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  lw_clear_mega_kernel<<<m.grid, m.block, m.smem, (cudaStream_t)stream>>>(
      in, tb, d, (const float*)plk_lay, (const float*)plk_lev, (const float*)plk_sfc,
      (const float*)sfc_emis, (const float*)inc_flux, (float*)trans_s, (float*)sup_s,
      (float*)flux_up, (float*)flux_dn, ds, i2f);
  return (int)cudaGetLastError();
}
