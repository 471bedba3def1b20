// LW no-scattering sweeps from materialized optics and Planck sources: one
// quadrature angle, fluxes summed over g-points or kept per g-point.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_noscat_reduced_kernel (wrapper
//   lw_noscat_pallas_reduced; here PER_GPT = false) and _lw_noscat_kernel
//   (wrapper lw_noscat_pallas; PER_GPT = true): from tau and the layer
//   sources per (layer, column, g-point), the level sources per (level,
//   column, g-point), the surface source and emissivity and an optional
//   incident flux, the Clough linear-in-tau layer emission, the downward
//   radiance from the top, the surface reflection and emission, the upward
//   radiance, and both as fluxes at every level: summed over g-points,
//   (nlev, ncol), or per g-point, (nlev, ncol, ngpt).
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau and the layer sources are 2 x 2.01 GB, the level sources
//   2.05 GB: 6.1 GB read, 1.8 ms at 3.35 TB/s with the 16 MB of summed
//   fluxes, 10.2 GB and 3.0 ms with the 2 x 2.05 GB of per-g-point fluxes.
//   One exp and one divide per point and sweep.
//
// Design: the source-fused sweep's mapping (lw_noscat_banded.cu): one block
//   per column, one thread per g-point (more than 1024: a column over
//   several blocks, the sums completed by finish_level_sums), the radiance in
//   a register, layers looped. The upward sweep reads tau and the two sources
//   again and recomputes the transmittance and the Clough factor
//   (common.cuh's, the one every LW no-scattering kernel uses) instead of
//   keeping (transmittance, upward source) scratch from the downward sweep:
//   three arrays read again against two written and two read, so the reread
//   moves fewer bytes and holds no memory; its price is a second exp and
//   divide per point, which are not near the limit. PER_GPT is a template
//   parameter: the summed variant takes the band-valued emissivity of the
//   solves, (nbnd, ncol) through gpt2band, and adds per-warp partial sums in
//   a fixed order (common.cuh, no atomics); the per-g-point variant takes the
//   emissivity per g-point, (ncol, ngpt), as the TPU function does, stores
//   each thread's two fluxes per level and uses no shared memory. The secant
//   and the weight are launch arguments; a null incident flux is zero.
//   Nothing of the TPU kernels' structure is kept: no column blocks, no lane
//   or column padding, no transposed (ncol, nlev) output.
#include "common.cuh"

namespace rrtmgp {

template <typename R, bool PER_GPT, bool SPLIT>
__global__ void lw_noscat_sources_kernel(const R* __restrict__ tau,         // (nlay, ncol, ngpt)
                                         const R* __restrict__ lay_source,  // (nlay, ncol, ngpt)
                                         const R* __restrict__ lev_source,  // (nlev, ncol, ngpt)
                                         const R* __restrict__ sfc_source,  // (ncol, ngpt)
                                         const R* __restrict__ sfc_emis,    // (nbnd, ncol); PER_GPT (ncol, ngpt)
                                         const int* __restrict__ gpt2band,  // (ngpt,); PER_GPT unused
                                         const R* __restrict__ inc_flux,    // (ncol, ngpt) or null
                                         R* __restrict__ flux_up,           // (nlev, ncol); PER_GPT (nlev, ncol, ngpt)
                                         R* __restrict__ flux_dn,
                                         R* __restrict__ partials,          // (2, nlev, ncol, column's warps) or null
                                         int nlay, int ncol, int ngpt, R ds, R i2f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const R one = R(1), two = R(2);
  const size_t stride = (size_t)ncol * ngpt, g0 = (size_t)col * ngpt + g;
  enum { UP = 0, DN = 1 };
  // one level's value of one field: a store per g-point, or the level sum
  auto put = [&](int f, int lev, R v) {
    if constexpr (PER_GPT) {
      if (active) (f == UP ? flux_up : flux_dn)[(size_t)lev * stride + g0] = v * i2f;
    } else {
      sums.add(f, lev, v);
    }
  };
  // layer l's transmittance and its emission toward the level with source lev_val
  auto emission = [&](int l, R lev_val, R& trans) {
    const size_t s = (size_t)l * stride + g0;
    const R tau_loc = __ldg(tau + s) * ds;
    trans = r_exp(-tau_loc);
    const R fact = clough_factor(tau_loc, trans);
    return (one - trans) * lev_val + two * fact * (__ldg(lay_source + s) - lev_val);
  };

  // downward, TOA -> surface: layer l emits toward the surface with its
  // bottom level's source
  R i_dn = R(0);
  if (active && inc_flux != nullptr) i_dn = inc_flux[g0] / i2f;
  put(DN, nlay, i_dn);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      R trans;
      const R s_dn = emission(l, __ldg(lev_source + (size_t)l * stride + g0), trans);
      i_dn = trans * i_dn + s_dn;
    }
    put(DN, l, i_dn);
  }

  // surface reflection and emission
  R i_up = R(0);
  if (active) {
    const R emis = PER_GPT ? __ldg(sfc_emis + g0) : __ldg(sfc_emis + (size_t)__ldg(gpt2band + g) * ncol + col);
    i_up = i_dn * (one - emis) + emis * __ldg(sfc_source + g0);
  }
  put(UP, 0, i_up);

  // upward: layer l emits toward space with its top level's source
  for (int l = 0; l < nlay; ++l) {
    if (active) {
      R trans;
      const R s_up = emission(l, __ldg(lev_source + (size_t)(l + 1) * stride + g0), trans);
      i_up = trans * i_up + s_up;
    }
    put(UP, l + 1, i_up);
  }

  if constexpr (!PER_GPT && !SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      flux_up[(size_t)lev * ncol + col] = sums.total(UP, lev) * i2f;
      flux_dn[(size_t)lev * ncol + col] = sums.total(DN, lev) * i2f;
    }
  }
}

// group, n_groups, in_block: the host's launch plan; partials (2, nlev, ncol,
// column's warps) for the summed variant unless in_block, else null.
template <bool PER_GPT>
int launch_lw_noscat_sources(const void* tau, const void* lay_source, const void* lev_source,
                             const void* sfc_source, const void* sfc_emis, const void* gpt2band,
                             const void* inc_flux, void* flux_up, void* flux_dn, void* partials, int nlay, int ncol,
                             int ngpt, int group, int n_groups, bool in_block, float ds, float i2f, void* stream) {
  const Dims d{nlay, ncol, ngpt, 0, 0, 0, 0};
  const MegaLaunch m = group_launch<float>(d, PER_GPT ? 0 : 2, group, n_groups, in_block);
  const cudaStream_t s = (cudaStream_t)stream;
  auto kernel = in_block ? lw_noscat_sources_kernel<float, PER_GPT, false> : lw_noscat_sources_kernel<float, PER_GPT, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<m.grid, m.block, m.smem, s>>>(
      (const float*)tau, (const float*)lay_source, (const float*)lev_source, (const float*)sfc_source,
      (const float*)sfc_emis, (const int*)gpt2band, (const float*)inc_flux, (float*)flux_up, (float*)flux_dn,
      in_block ? nullptr : (float*)partials, nlay, ncol, ngpt, ds, i2f);
  err = cudaGetLastError();
  if (err != cudaSuccess || PER_GPT || in_block) return (int)err;
  return (int)finish_sums<float>(s, (const float*)partials, 2, nlay + 1, ncol, n_groups * group / 32, SUMS_SCALED,
                                 i2f, (float*)flux_up, (float*)flux_dn, nullptr);
}

}  // namespace rrtmgp

// f32; ds is the secant of the angle, i2f = pi * weight. Summed over
// g-points: sfc_emis (nbnd, ncol) with gpt2band, fluxes (nlev, ncol).
extern "C" int rrtmgp_lw_noscat_reduced(const void* tau, const void* lay_source, const void* lev_source,
                                        const void* sfc_source, const void* sfc_emis, const void* gpt2band,
                                        const void* inc_flux, void* flux_up, void* flux_dn, void* partials,
                                        int nlay, int ncol, int ngpt, int group, int n_groups, int in_block,
                                        float ds, float i2f, void* stream) {
  return rrtmgp::launch_lw_noscat_sources<false>(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band,
                                                 inc_flux, flux_up, flux_dn, partials, nlay, ncol, ngpt, group,
                                                 n_groups, in_block != 0, ds, i2f, stream);
}

// Per g-point: sfc_emis (ncol, ngpt), fluxes (nlev, ncol, ngpt).
extern "C" int rrtmgp_lw_noscat_gpt(const void* tau, const void* lay_source, const void* lev_source,
                                    const void* sfc_source, const void* sfc_emis, const void* inc_flux,
                                    void* flux_up, void* flux_dn, int nlay, int ncol, int ngpt, int group,
                                    int n_groups, float ds, float i2f, void* stream) {
  return rrtmgp::launch_lw_noscat_sources<true>(tau, lay_source, lev_source, sfc_source, sfc_emis, nullptr,
                                                inc_flux, flux_up, flux_dn, nullptr, nlay, ncol, ngpt, group,
                                                n_groups, n_groups == 1, ds, i2f, stream);
}
