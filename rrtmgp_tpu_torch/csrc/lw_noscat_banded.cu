// LW no-scattering sweep of the two-kernel path: 1 to 4 quadrature angles in
// one launch, the Planck sources built in the kernel, fluxes summed over
// g-points, per angle.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_noscat_banded_kernel (wrapper
//   lw_noscat_banded_reduced): from tau and the Planck fraction per (layer,
//   column, g-point) and band Planck values at layers, levels and the surface,
//   the Clough linear-in-tau sources (level value x geometric mean of the
//   adjacent layers' Planck fractions, the boundary levels their layer's
//   own), the downward radiance from the top, the surface reflection and
//   emission, the upward radiance, and the g-point sums of both at every
//   level. The TPU kernel is called once per angle on the same optics; this
//   one sweeps every angle of a solve in one launch and writes each angle's
//   fluxes, which the host adds in the angles' order.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau and the Planck fraction are 2 x 2.01 GB, the band Planck
//   values 0.25 GB, the outputs 16 MB per angle: 1.3 ms at 3.35 TB/s. The
//   upward sweep reads tau and the Planck fraction a second time (8 GB in
//   all, ~2.4 ms): a column's 123 KB of optics times the ~1000 columns in
//   flight exceeds the 50 MB L2, so most of the second read comes from
//   device memory too. Per angle one exp, one divide (the Clough factor) and
//   the recurrence per point and sweep; one sqrt per point and sweep for all
//   angles.
//
// Design: the mapping of the LW megakernel (lw_clear_mega.cu): one block per
//   column, one thread per g-point (more than 1024, or a column whose level
//   sums do not fit the block: the sums in device memory, completed by
//   finish_level_sums, one call per angle), layers looped in registers,
//   per-level sums as per-warp shuffle partials in shared memory added in a
//   fixed order (deterministic, no atomics). The angle count NANG is a
//   template parameter: a thread keeps one radiance per angle in registers;
//   what does not depend on the angle (the loads of tau, the Planck fraction
//   and the band Planck values, the layer and level sources, the geometric
//   mean of the fractions, the surface emission) is done once per (layer,
//   g-point), and the slant optical depth, transmittance, Clough factor and
//   recurrence once per angle, each angle with its own two level sums
//   (fields 2k up, 2k + 1 down), a level's angles reduced together over the
//   warp (common.cuh add_fields: 6 shuffles for 3 or 4 angles in place of
//   5 per angle, the same sum tree). The sweep's time goes to the
//   instructions of its per-angle arithmetic (an exp, an IEEE divide, the
//   recurrence and the level sums per point, angle and sweep), not to its
//   loads: reading the next layer's inputs a layer ahead, as
//   sw_2stream_reduced.cu does, took 8 more registers and was slower
//   (PERF.md, the K12 ablation). Every value is formed
//   by the expressions of the one-angle sweep in the same order, so an
//   angle's fluxes have the bits of a launch for that angle alone. Each
//   thread reads its band's Planck values through gpt2band; a column's
//   bands are adjacent in the (., ncol, nbnd) layout. No scratch:
//   like the TPU kernel the upward sweep recomputes the transmittance and
//   the source from tau and the Planck fraction instead of storing them,
//   which trades a second read of two arrays for a write and a read of two.
//   The Clough factor is common.cuh's, the one the megakernel uses, so both
//   paths agree to rounding. The secants and the flux factors are launch
//   arguments; the incident flux is optional (a null pointer is zero), one
//   (ncol, ngpt) slab per angle, split by weight on the host. The real type
//   is a template parameter. Nothing of the TPU kernel's structure is kept:
//   no [M; M] band-expansion matmul, no hi/lo split, no lane padding, no
//   column blocks.
#include "common.cuh"

namespace rrtmgp {

template <typename R, int NANG, bool SPLIT>
__global__ void lw_noscat_banded_kernel(const R* __restrict__ tau,       // (nlay, ncol, ngpt)
                                        const R* __restrict__ pfrac,     // (nlay, ncol, ngpt)
                                        const R* __restrict__ plk_lay,   // (nlay, ncol, nbnd)
                                        const R* __restrict__ plk_lev,   // (nlev, ncol, nbnd)
                                        const R* __restrict__ plk_sfc,   // (ncol, nbnd)
                                        const R* __restrict__ sfc_emis,  // (nbnd, ncol)
                                        const int* __restrict__ gpt2band,  // (ngpt,)
                                        const R* __restrict__ inc_flux,  // (NANG, ncol, ngpt) or null
                                        R* __restrict__ flux_up,         // (NANG, nlev, ncol)
                                        R* __restrict__ flux_dn,         // (NANG, nlev, ncol)
                                        R* __restrict__ partials,        // (2 NANG, nlev, ncol, column's warps)
                                                                         // or null
                                        int nlay, int ncol, int ngpt, int nbnd, AnglesT<R> ang) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt && nlay > 0;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const R one = R(1), two = R(2);
  const int band = g < ngpt ? __ldg(gpt2band + g) : 0;
  // this thread's (layer or level 0, col, g) and (layer or level 0, col,
  // band); layer l at [l * stride]
  const size_t g_stride = (size_t)ncol * ngpt, b_stride = (size_t)ncol * nbnd;
  const size_t g0 = (size_t)col * ngpt + g, b0 = (size_t)col * nbnd + band;
  const R *tau_p = tau + g0, *pf_p = pfrac + g0, *lay_p = plk_lay + b0, *lev_p = plk_lev + b0;

  R rad[NANG];
#pragma unroll
  for (int k = 0; k < NANG; ++k) {
    rad[k] = (active && inc_flux != nullptr) ? inc_flux[k * g_stride + g0] / ang.i2f[k] : R(0);
  }
  add_fields<NANG>(sums, 1, 2, nlay, rad);

  // downward, TOA -> surface: layer l emits toward the surface with its
  // bottom level's source (level l: the fractions of layers l and l - 1)
  R pf = active ? __ldg(pf_p + (size_t)(nlay - 1) * g_stride) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const R pf_below = l > 0 ? __ldg(pf_p + (size_t)(l - 1) * g_stride) : pf;
      const R t = __ldg(tau_p + (size_t)l * g_stride);
      const R lay_val = __ldg(lay_p + (size_t)l * b_stride) * pf;
      const R lev_val = __ldg(lev_p + (size_t)l * b_stride) * (l > 0 ? r_sqrt(pf_below * pf) : pf);
#pragma unroll
      for (int k = 0; k < NANG; ++k) {
        const R tau_loc = t * ang.ds[k];
        const R trans = r_exp(-tau_loc);
        const R fact = clough_factor(tau_loc, trans);
        rad[k] = trans * rad[k] + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      }
      pf = pf_below;
    }
    add_fields<NANG>(sums, 1, 2, l, rad);
  }

  // surface: pf is layer 0's fraction now
  if (active) {
    const R emis = __ldg(sfc_emis + (size_t)band * ncol + col);
    const R emitted = emis * (__ldg(plk_sfc + b0) * pf);
#pragma unroll
    for (int k = 0; k < NANG; ++k) rad[k] = rad[k] * (one - emis) + emitted;
  }
  add_fields<NANG>(sums, 0, 2, 0, rad);

  // upward: layer l emits toward space with its top level's source (level
  // l + 1: the fractions of layers l and l + 1)
  for (int l = 0; l < nlay; ++l) {
    if (active) {
      const R pf_above = l < nlay - 1 ? __ldg(pf_p + (size_t)(l + 1) * g_stride) : pf;
      const R t = __ldg(tau_p + (size_t)l * g_stride);
      const R lay_val = __ldg(lay_p + (size_t)l * b_stride) * pf;
      const R lev_val = __ldg(lev_p + (size_t)(l + 1) * b_stride) * (l < nlay - 1 ? r_sqrt(pf * pf_above) : pf);
#pragma unroll
      for (int k = 0; k < NANG; ++k) {
        const R tau_loc = t * ang.ds[k];
        const R trans = r_exp(-tau_loc);
        const R fact = clough_factor(tau_loc, trans);
        rad[k] = trans * rad[k] + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      }
      pf = pf_above;
    }
    add_fields<NANG>(sums, 0, 2, l + 1, rad);
  }

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
#pragma unroll
      for (int k = 0; k < NANG; ++k) {
        const size_t o = ((size_t)k * nlev + lev) * ncol + col;
        flux_up[o] = sums.total(2 * k, lev) * ang.i2f[k];
        flux_dn[o] = sums.total(2 * k + 1, lev) * ang.i2f[k];
      }
    }
  }
}

template <int NANG>
cudaError_t launch_lw_noscat_banded(const float* tau, const float* pfrac, const float* plk_lay, const float* plk_lev,
                                    const float* plk_sfc, const float* sfc_emis, const int* gpt2band,
                                    const float* inc_flux, float* flux_up, float* flux_dn, float* partials,
                                    const Dims& d, int group, int n_groups, bool in_block, const AnglesT<float>& ang,
                                    cudaStream_t s) {
  const MegaLaunch m = group_launch<float>(d, 2 * NANG, group, n_groups, in_block);
  auto kernel = in_block ? lw_noscat_banded_kernel<float, NANG, false> : lw_noscat_banded_kernel<float, NANG, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, s>>>(tau, pfrac, plk_lay, plk_lev, plk_sfc, sfc_emis, gpt2band, inc_flux,
                                         flux_up, flux_dn, in_block ? nullptr : partials, d.nlay, d.ncol, d.ngpt,
                                         d.nbnd, ang);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return err;
  return finish_angle_sums(s, partials, NANG, d.nlay + 1, d.ncol, n_groups * group / 32, ang, flux_up, flux_dn);
}

}  // namespace rrtmgp

// f32; nang angles (1 to 4), ds: their secants and i2f: pi x their weights,
// each a host array of nang floats; inc_flux (nang, ncol, ngpt) or null;
// flux_up, flux_dn (nang, nlev, ncol). group, n_groups, in_block: the host's
// launch plan for 2 x nang fields; partials (2 nang, nlev, ncol, column's
// warps) unless in_block, else null.
extern "C" int rrtmgp_lw_noscat_banded(const void* tau, const void* pfrac, const void* plk_lay,
                                       const void* plk_lev, const void* plk_sfc, const void* sfc_emis,
                                       const void* gpt2band, const void* inc_flux, void* flux_up, void* flux_dn,
                                       void* partials, int nlay, int ncol, int ngpt, int nbnd, int group,
                                       int n_groups, int in_block, int nang, const void* ds, const void* i2f,
                                       void* stream) {
  using namespace rrtmgp;
  AnglesT<float> ang;
  if (!host_angles(nang, ds, i2f, ang)) return (int)cudaErrorInvalidValue;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  const float *t = (const float*)tau, *pf = (const float*)pfrac, *lay = (const float*)plk_lay,
              *lev = (const float*)plk_lev, *sfc = (const float*)plk_sfc, *emis = (const float*)sfc_emis,
              *inc = (const float*)inc_flux;
  const int* g2b = (const int*)gpt2band;
  float *up = (float*)flux_up, *dn = (float*)flux_dn, *part = (float*)partials;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ib = in_block != 0;
  cudaError_t err;
  switch (nang) {
    case 1: err = launch_lw_noscat_banded<1>(t, pf, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                             ib, ang, s); break;
    case 2: err = launch_lw_noscat_banded<2>(t, pf, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                             ib, ang, s); break;
    case 3: err = launch_lw_noscat_banded<3>(t, pf, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                             ib, ang, s); break;
    default: err = launch_lw_noscat_banded<4>(t, pf, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group,
                                              n_groups, ib, ang, s);
  }
  return (int)err;
}

namespace rrtmgp {

// The most threads a block of lw_noscat_banded over `variant` angles (1 to 4) may have,
// both level-sum variants (errors.cu rrtmgp_max_threads).
cudaError_t lw_noscat_banded_max_threads(int variant, int* threads) {
#define RRTMGP_MT(N) \
  max_threads(threads, lw_noscat_banded_kernel<float, N, false>, lw_noscat_banded_kernel<float, N, true>)
  switch (variant) {
    case 1: return RRTMGP_MT(1);
    case 2: return RRTMGP_MT(2);
    case 3: return RRTMGP_MT(3);
    case 4: return RRTMGP_MT(4);
    default: return cudaErrorInvalidValue;
  }
#undef RRTMGP_MT
}

}  // namespace rrtmgp
