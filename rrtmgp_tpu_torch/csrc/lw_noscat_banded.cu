// LW no-scattering sweep of the two-kernel path: one quadrature angle, the
// Planck sources built in the kernel, fluxes summed over g-points.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_noscat_banded_kernel (wrapper
//   lw_noscat_banded_reduced): from tau and the Planck fraction per (layer,
//   column, g-point) and band Planck values at layers, levels and the surface,
//   the Clough linear-in-tau sources (level value x geometric mean of the
//   adjacent layers' Planck fractions, the boundary levels their layer's
//   own), the downward radiance from the top, the surface reflection and
//   emission, the upward radiance, and the g-point sums of both at every
//   level. Called once per angle on the same optics.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau and the Planck fraction are 2 x 2.01 GB, the band Planck
//   values 0.25 GB, the outputs 16 MB: 1.3 ms at 3.35 TB/s. The upward sweep
//   reads tau and the Planck fraction a second time (8 GB in all, ~2.4 ms):
//   a column's 123 KB of optics times the ~1000 columns in flight exceeds the
//   50 MB L2, so most of the second read comes from device memory too. One
//   exp, one sqrt and one divide per point and sweep: arithmetic is not near
//   the limit.
//
// Design: the mapping of the LW megakernel (lw_clear_mega.cu): one block per
//   column, one thread per g-point (more than 1024: a column over several
//   blocks, the sums completed by finish_level_sums), layers looped in
//   registers, per-level sums as per-warp shuffle partials in shared memory
//   added in a fixed order (deterministic, no atomics). Each thread reads its
//   band's Planck values through gpt2band; a column's bands are adjacent in
//   the (., ncol, nbnd) layout. No scratch: like the TPU kernel the upward
//   sweep recomputes the transmittance and the source from tau and the Planck
//   fraction instead of storing them, which trades a second read of two
//   arrays for a write and a read of two. The Clough factor is common.cuh's,
//   the one the megakernel uses, so both paths agree to rounding. The secant
//   and the weight are launch arguments; the incident flux is optional (a
//   null pointer is zero). The real type is a template parameter. Nothing of
//   the TPU kernel's structure is kept: no [M; M] band-expansion matmul, no
//   hi/lo split, no lane padding, no column blocks.
#include "common.cuh"

namespace rrtmgp {

template <typename R, bool SPLIT>
__global__ void lw_noscat_banded_kernel(const R* __restrict__ tau,       // (nlay, ncol, ngpt)
                                        const R* __restrict__ pfrac,     // (nlay, ncol, ngpt)
                                        const R* __restrict__ plk_lay,   // (nlay, ncol, nbnd)
                                        const R* __restrict__ plk_lev,   // (nlev, ncol, nbnd)
                                        const R* __restrict__ plk_sfc,   // (ncol, nbnd)
                                        const R* __restrict__ sfc_emis,  // (nbnd, ncol)
                                        const int* __restrict__ gpt2band,  // (ngpt,)
                                        const R* __restrict__ inc_flux,  // (ncol, ngpt) or null
                                        R* __restrict__ flux_up,         // (nlev, ncol)
                                        R* __restrict__ flux_dn,         // (nlev, ncol)
                                        R* __restrict__ partials,        // (2, nlev, ncol, column's warps) or null
                                        int nlay, int ncol, int ngpt, int nbnd, R ds, R i2f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const R one = R(1), two = R(2);
  const int band = active ? __ldg(gpt2band + g) : 0;
  // offsets of (layer or level 0, col, g) and (layer or level 0, col, band)
  const size_t g_stride = (size_t)ncol * ngpt, b_stride = (size_t)ncol * nbnd;
  const size_t g0 = (size_t)col * ngpt + g, b0 = (size_t)col * nbnd + band;

  // downward, TOA -> surface: layer l emits toward the surface with its
  // bottom level's source (level l: the fractions of layers l and l - 1)
  R i_dn = R(0);
  if (active && inc_flux != nullptr) i_dn = inc_flux[g0] / i2f;
  sums.add(1, nlay, i_dn);
  R pf = active ? __ldg(pfrac + (size_t)(nlay - 1) * g_stride + g0) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const R pf_below = l > 0 ? __ldg(pfrac + (size_t)(l - 1) * g_stride + g0) : pf;
      const R tau_loc = __ldg(tau + (size_t)l * g_stride + g0) * ds;
      const R trans = r_exp(-tau_loc);
      const R fact = clough_factor(tau_loc, trans);
      const R lay_val = __ldg(plk_lay + (size_t)l * b_stride + b0) * pf;
      const R lev_val = __ldg(plk_lev + (size_t)l * b_stride + b0) * (l > 0 ? r_sqrt(pf_below * pf) : pf);
      i_dn = trans * i_dn + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      pf = pf_below;
    }
    sums.add(1, l, i_dn);
  }

  // surface: pf is layer 0's fraction now
  R i_up = R(0);
  if (active) {
    const R emis = __ldg(sfc_emis + (size_t)band * ncol + col);
    i_up = i_dn * (one - emis) + emis * (__ldg(plk_sfc + b0) * pf);
  }
  sums.add(0, 0, i_up);

  // upward: layer l emits toward space with its top level's source (level
  // l + 1: the fractions of layers l and l + 1)
  for (int l = 0; l < nlay; ++l) {
    if (active) {
      const R pf_above = l < nlay - 1 ? __ldg(pfrac + (size_t)(l + 1) * g_stride + g0) : pf;
      const R tau_loc = __ldg(tau + (size_t)l * g_stride + g0) * ds;
      const R trans = r_exp(-tau_loc);
      const R fact = clough_factor(tau_loc, trans);
      const R lay_val = __ldg(plk_lay + (size_t)l * b_stride + b0) * pf;
      const R lev_val =
          __ldg(plk_lev + (size_t)(l + 1) * b_stride + b0) * (l < nlay - 1 ? r_sqrt(pf * pf_above) : pf);
      i_up = trans * i_up + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      pf = pf_above;
    }
    sums.add(0, l + 1, i_up);
  }

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      flux_up[(size_t)lev * ncol + col] = sums.total(0, lev) * i2f;
      flux_dn[(size_t)lev * ncol + col] = sums.total(1, lev) * i2f;
    }
  }
}

}  // namespace rrtmgp

// f32; ds is the secant of the angle, i2f = pi * weight. group, n_groups,
// in_block: the host's launch plan; partials (2, nlev, ncol, column's warps)
// unless in_block, else null.
extern "C" int rrtmgp_lw_noscat_banded(const void* tau, const void* pfrac, const void* plk_lay,
                                       const void* plk_lev, const void* plk_sfc, const void* sfc_emis,
                                       const void* gpt2band, const void* inc_flux, void* flux_up, void* flux_dn,
                                       void* partials, int nlay, int ncol, int ngpt, int nbnd, int group,
                                       int n_groups, int in_block, float ds, float i2f, void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  const MegaLaunch m = group_launch<float>(d, 2, group, n_groups, in_block);
  const cudaStream_t s = (cudaStream_t)stream;
  auto kernel = in_block ? lw_noscat_banded_kernel<float, false> : lw_noscat_banded_kernel<float, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<m.grid, m.block, m.smem, s>>>(
      (const float*)tau, (const float*)pfrac, (const float*)plk_lay, (const float*)plk_lev,
      (const float*)plk_sfc, (const float*)sfc_emis, (const int*)gpt2band, (const float*)inc_flux,
      (float*)flux_up, (float*)flux_dn, in_block ? nullptr : (float*)partials, nlay, ncol, ngpt, nbnd, ds, i2f);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return (int)err;
  return (int)finish_sums<float>(s, (const float*)partials, 2, nlay + 1, ncol, n_groups * group / 32, SUMS_SCALED,
                                 i2f, (float*)flux_up, (float*)flux_dn, nullptr);
}
