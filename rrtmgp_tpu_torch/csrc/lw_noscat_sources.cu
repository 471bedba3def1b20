// LW no-scattering sweeps from materialized optics and Planck sources:
// fluxes summed over g-points for 1 to 4 quadrature angles in one launch, or
// kept per g-point for one angle.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_noscat_reduced_kernel (wrapper
//   lw_noscat_pallas_reduced; here lw_noscat_reduced_kernel) and
//   _lw_noscat_kernel (wrapper lw_noscat_pallas; here lw_noscat_gpt_kernel):
//   from tau and the layer sources per (layer, column, g-point), the level
//   sources per (level, column, g-point), the surface source and emissivity
//   and an optional incident flux, the Clough linear-in-tau layer emission,
//   the downward radiance from the top, the surface reflection and emission,
//   the upward radiance, and both as fluxes at every level: summed over
//   g-points, (nlev, ncol), or per g-point, (nlev, ncol, ngpt). The TPU
//   kernel is called once per angle on the same optics; the summed sweep
//   here takes every angle of a solve in one launch and writes each angle's
//   fluxes, which the host adds in the angles' order.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau and the layer sources are 2 x 2.01 GB, the level sources
//   2.05 GB: 6.1 GB read, 1.8 ms at 3.35 TB/s with the 16 MB of summed
//   fluxes per angle, 10.2 GB and 3.0 ms with the 2 x 2.05 GB of per-g-point
//   fluxes. Per point, angle and sweep one exp, one divide (the Clough
//   factor) and the recurrence: the summed sweep's time goes to that
//   per-angle work and the level sums, as lw_noscat_banded.cu's does.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 3 angles in
//   one launch 6.0-6.1 ms (3.3x the byte bound), against 13.4-13.6 for a
//   launch per angle; one angle 3.9-4.6 ms.
//
// Design: the source-fused sweep's mapping (lw_noscat_banded.cu): one block
//   per column, one thread per g-point (more than 1024, or a column whose
//   level sums do not fit the block: the sums in device memory, completed by
//   finish_level_sums, once per angle), the radiances in registers, layers
//   looped. The summed sweep takes the angle count NANG as a template
//   parameter: a thread keeps one radiance per angle; the loads of tau and
//   the two sources happen once per (layer, g-point), and the slant depth,
//   transmittance, Clough factor (common.cuh's, the one every LW
//   no-scattering kernel uses) and recurrence once per angle, each angle
//   with its own two level sums (fields 2k up, 2k + 1 down), a level's
//   angles reduced together over the warp (common.cuh add_fields: the
//   shuffle tree of add(), so the same bits). Every value is formed by the
//   one-angle sweep's expressions in the same order, so an angle's fluxes
//   have the bits of a launch for that angle alone; one angle is NANG 1. The
//   upward sweep reads tau and the two sources again and recomputes the
//   transmittance and the Clough factor instead of keeping (transmittance,
//   upward source) scratch from the downward sweep: three arrays read again
//   against two written and two read, so the reread moves fewer bytes and
//   holds no memory. The summed sweep takes the band-valued emissivity of
//   the solves, (nbnd, ncol) through gpt2band, and adds per-warp partial
//   sums in a fixed order (no atomics); the incident flux is one (ncol,
//   ngpt) slab per angle, split by weight on the host, or null (zero). The
//   per-g-point sweep (one angle) takes the emissivity per g-point, (ncol,
//   ngpt), as the TPU function does, and stores each thread's two fluxes per
//   level: 32 bytes a point if its upward pass read its inputs again (4.8
//   ms at 32768 x 60 x 256), 20 in the bound. Its downward pass already
//   holds each layer's transmittance and Clough factor, and the source of
//   the layer's top level from the iteration before, so for the bottom C
//   layers it also forms the upward source with the upward pass's
//   expression and keeps it with the transmittance in shared memory (8
//   bytes a layer and thread; C from the host's plan, ops/rte_kernels.py
//   lw_noscat_gpt_design, a column of at most C layers whole): 32 - 12 C /
//   nlay bytes a point, one exp and one divide fewer per cached point, the
//   same bits. C = 12 ran fastest at 32768 x 60 x 256 (13 within its
//   spread); from 14 layers (28 KB a block of 256 threads) an SM holds
//   fewer blocks, which cost more than the bytes saved (PERF.md). The
//   secants and the flux factors are launch arguments. Nothing of the TPU kernels' structure is kept: no
//   column blocks, no lane or column padding, no transposed (ncol, nlev)
//   output.
#include "common.cuh"

namespace rrtmgp {

// The g-summed sweep over NANG angles.
template <typename R, int NANG, bool SPLIT>
__global__ void lw_noscat_reduced_kernel(const R* __restrict__ tau,         // (nlay, ncol, ngpt)
                                         const R* __restrict__ lay_source,  // (nlay, ncol, ngpt)
                                         const R* __restrict__ lev_source,  // (nlev, ncol, ngpt)
                                         const R* __restrict__ sfc_source,  // (ncol, ngpt)
                                         const R* __restrict__ sfc_emis,    // (nbnd, ncol)
                                         const int* __restrict__ gpt2band,  // (ngpt,)
                                         const R* __restrict__ inc_flux,    // (NANG, ncol, ngpt) or null
                                         R* __restrict__ flux_up,           // (NANG, nlev, ncol)
                                         R* __restrict__ flux_dn,           // (NANG, nlev, ncol)
                                         R* __restrict__ partials,          // (2 NANG, nlev, ncol, column's warps)
                                                                            // or null
                                         int nlay, int ncol, int ngpt, AnglesT<R> ang) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const R one = R(1), two = R(2);
  // this thread's (layer or level 0, col, g); layer l at [l * stride]
  const size_t stride = (size_t)ncol * ngpt, g0 = (size_t)col * ngpt + g;
  const R *tau_p = tau + g0, *lay_p = lay_source + g0, *lev_p = lev_source + g0;

  R rad[NANG];
#pragma unroll
  for (int k = 0; k < NANG; ++k) {
    rad[k] = (active && inc_flux != nullptr) ? inc_flux[k * stride + g0] / ang.i2f[k] : R(0);
  }
  add_fields<NANG>(sums, 1, 2, nlay, rad);

  // downward, TOA -> surface: layer l emits toward the surface with its
  // bottom level's source
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const size_t s = (size_t)l * stride;
      const R t = __ldg(tau_p + s), lay_val = __ldg(lay_p + s), lev_val = __ldg(lev_p + s);
#pragma unroll
      for (int k = 0; k < NANG; ++k) {
        const R tau_loc = t * ang.ds[k];
        const R trans = r_exp(-tau_loc);
        const R fact = clough_factor(tau_loc, trans);
        rad[k] = trans * rad[k] + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      }
    }
    add_fields<NANG>(sums, 1, 2, l, rad);
  }

  // surface reflection and emission
  if (active) {
    const R emis = __ldg(sfc_emis + (size_t)__ldg(gpt2band + g) * ncol + col);
    const R emitted = emis * __ldg(sfc_source + g0);
#pragma unroll
    for (int k = 0; k < NANG; ++k) rad[k] = rad[k] * (one - emis) + emitted;
  }
  add_fields<NANG>(sums, 0, 2, 0, rad);

  // upward: layer l emits toward space with its top level's source
  for (int l = 0; l < nlay; ++l) {
    if (active) {
      const size_t s = (size_t)l * stride;
      const R t = __ldg(tau_p + s), lay_val = __ldg(lay_p + s), lev_val = __ldg(lev_p + s + stride);
#pragma unroll
      for (int k = 0; k < NANG; ++k) {
        const R tau_loc = t * ang.ds[k];
        const R trans = r_exp(-tau_loc);
        const R fact = clough_factor(tau_loc, trans);
        rad[k] = trans * rad[k] + ((one - trans) * lev_val + two * fact * (lay_val - lev_val));
      }
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

// The per-g-point sweep, one angle: each thread stores its fluxes. The
// downward pass also forms the upward source of each of the bottom ncache
// layers and keeps it with the layer's transmittance in shared memory,
// [2][ncache][blockDim.x], which the upward pass reads in place of the
// layer's inputs.
template <typename R, bool SPLIT>
__global__ void lw_noscat_gpt_kernel(const R* __restrict__ tau,         // (nlay, ncol, ngpt)
                                     const R* __restrict__ lay_source,  // (nlay, ncol, ngpt)
                                     const R* __restrict__ lev_source,  // (nlev, ncol, ngpt)
                                     const R* __restrict__ sfc_source,  // (ncol, ngpt)
                                     const R* __restrict__ sfc_emis,    // (ncol, ngpt)
                                     const R* __restrict__ inc_flux,    // (ncol, ngpt) or null
                                     R* __restrict__ flux_up,           // (nlev, ncol, ngpt)
                                     R* __restrict__ flux_dn,
                                     int nlay, int ncol, int ngpt, int ncache, R ds, R i2f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  if (g >= ngpt) return;  // no level sums and no barrier: an idle thread has nothing to do
  const R one = R(1), two = R(2);
  const size_t stride = (size_t)ncol * ngpt, g0 = (size_t)col * ngpt + g;
  // cached layer l's transmittance at cache[l * blockDim.x], its upward
  // source at cache[(ncache + l) * blockDim.x]
  R* cache = reinterpret_cast<R*>(smem_raw) + threadIdx.x;
  const size_t up_at = (size_t)ncache * blockDim.x;
  // one level's flux of this thread
  auto put = [&](R* flux, int lev, R v) { flux[(size_t)lev * stride + g0] = v * i2f; };
  // layer l's emission toward the level with source lev_val, from its
  // transmittance and Clough factor
  auto emission = [&](R trans, R fact, R lay_val, R lev_val) {
    return (one - trans) * lev_val + two * fact * (lay_val - lev_val);
  };

  // downward, TOA -> surface: layer l emits toward the surface with its
  // bottom level's source; a cached layer also toward space with its top
  // level's, the level source the iteration before read (read here for the
  // top layer)
  R i_dn = inc_flux != nullptr ? inc_flux[g0] / i2f : R(0);
  put(flux_dn, nlay, i_dn);
  R lev_top = nlay <= ncache ? __ldg(lev_source + (size_t)nlay * stride + g0) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    const size_t s = (size_t)l * stride + g0;
    const R tau_loc = __ldg(tau + s) * ds;
    const R trans = r_exp(-tau_loc);
    const R fact = clough_factor(tau_loc, trans);
    const R lay_val = __ldg(lay_source + s), lev_val = __ldg(lev_source + s);
    i_dn = trans * i_dn + emission(trans, fact, lay_val, lev_val);
    if (l < ncache) {
      cache[(size_t)l * blockDim.x] = trans;
      cache[up_at + (size_t)l * blockDim.x] = emission(trans, fact, lay_val, lev_top);
    }
    lev_top = lev_val;
    put(flux_dn, l, i_dn);
  }

  // surface reflection and emission
  const R emis = __ldg(sfc_emis + g0);
  R i_up = i_dn * (one - emis) + emis * __ldg(sfc_source + g0);
  put(flux_up, 0, i_up);

  // upward: layer l emits toward space with its top level's source; the
  // cached layers from shared memory
  for (int l = 0; l < nlay; ++l) {
    if (l < ncache) {
      i_up = cache[(size_t)l * blockDim.x] * i_up + cache[up_at + (size_t)l * blockDim.x];
    } else {
      const size_t s = (size_t)l * stride + g0;
      const R tau_loc = __ldg(tau + s) * ds;
      const R trans = r_exp(-tau_loc);
      const R fact = clough_factor(tau_loc, trans);
      i_up = trans * i_up + emission(trans, fact, __ldg(lay_source + s), __ldg(lev_source + s + stride));
    }
    put(flux_up, l + 1, i_up);
  }
}

template <int NANG>
cudaError_t launch_lw_noscat_reduced(const float* tau, const float* lay_source, const float* lev_source,
                                     const float* sfc_source, const float* sfc_emis, const int* gpt2band,
                                     const float* inc_flux, float* flux_up, float* flux_dn, float* partials,
                                     const Dims& d, int group, int n_groups, bool in_block,
                                     const AnglesT<float>& ang, cudaStream_t s) {
  const MegaLaunch m = group_launch<float>(d, 2 * NANG, group, n_groups, in_block);
  auto kernel = in_block ? lw_noscat_reduced_kernel<float, NANG, false> : lw_noscat_reduced_kernel<float, NANG, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, s>>>(tau, lay_source, lev_source, sfc_source, sfc_emis, gpt2band, inc_flux,
                                         flux_up, flux_dn, in_block ? nullptr : partials, d.nlay, d.ncol, d.ngpt,
                                         ang);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return err;
  return finish_angle_sums(s, partials, NANG, d.nlay + 1, d.ncol, n_groups * group / 32, ang, flux_up, flux_dn);
}

}  // namespace rrtmgp

// f32, summed over g-points: nang angles (1 to 4), ds: their secants and
// i2f: pi x their weights, each a host array of nang floats; sfc_emis
// (nbnd, ncol) with gpt2band; inc_flux (nang, ncol, ngpt) or null; flux_up,
// flux_dn (nang, nlev, ncol). group, n_groups, in_block: the host's launch
// plan for 2 x nang fields; partials (2 nang, nlev, ncol, column's warps)
// unless in_block, else null.
extern "C" int rrtmgp_lw_noscat_reduced(const void* tau, const void* lay_source, const void* lev_source,
                                        const void* sfc_source, const void* sfc_emis, const void* gpt2band,
                                        const void* inc_flux, void* flux_up, void* flux_dn, void* partials,
                                        int nlay, int ncol, int ngpt, int group, int n_groups, int in_block,
                                        int nang, const void* ds, const void* i2f, void* stream) {
  using namespace rrtmgp;
  AnglesT<float> ang;
  if (!host_angles(nang, ds, i2f, ang)) return (int)cudaErrorInvalidValue;
  const Dims d{nlay, ncol, ngpt, 0, 0, 0, 0};
  const float *t = (const float*)tau, *lay = (const float*)lay_source, *lev = (const float*)lev_source,
              *sfc = (const float*)sfc_source, *emis = (const float*)sfc_emis, *inc = (const float*)inc_flux;
  const int* g2b = (const int*)gpt2band;
  float *up = (float*)flux_up, *dn = (float*)flux_dn, *part = (float*)partials;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool ib = in_block != 0;
  cudaError_t err;
  switch (nang) {
    case 1: err = launch_lw_noscat_reduced<1>(t, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                              ib, ang, s); break;
    case 2: err = launch_lw_noscat_reduced<2>(t, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                              ib, ang, s); break;
    case 3: err = launch_lw_noscat_reduced<3>(t, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group, n_groups,
                                              ib, ang, s); break;
    default: err = launch_lw_noscat_reduced<4>(t, lay, lev, sfc, emis, g2b, inc, up, dn, part, d, group,
                                               n_groups, ib, ang, s);
  }
  return (int)err;
}

// Per g-point, one angle: sfc_emis (ncol, ngpt), fluxes (nlev, ncol, ngpt).
// ncache: the bottom layers whose transmittance and upward source the
// downward pass keeps in shared memory, 0 to nlay (else
// cudaErrorInvalidValue); group, n_groups: the host's launch plan, which
// counts that memory (bottom_state_bytes).
extern "C" int rrtmgp_lw_noscat_gpt(const void* tau, const void* lay_source, const void* lev_source,
                                    const void* sfc_source, const void* sfc_emis, const void* inc_flux,
                                    void* flux_up, void* flux_dn, int nlay, int ncol, int ngpt, int ncache,
                                    int group, int n_groups, float ds, float i2f, void* stream) {
  using namespace rrtmgp;
  if (ncache < 0 || ncache > nlay) return (int)cudaErrorInvalidValue;
  const Dims d{nlay, ncol, ngpt, 0, 0, 0, 0};
  const MegaLaunch m =
      group_launch<float>(d, 0, group, n_groups, n_groups == 1, bottom_state_bytes<float>(ncache, group));
  auto kernel = n_groups == 1 ? lw_noscat_gpt_kernel<float, false> : lw_noscat_gpt_kernel<float, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<m.grid, m.block, m.smem, (cudaStream_t)stream>>>(
      (const float*)tau, (const float*)lay_source, (const float*)lev_source, (const float*)sfc_source,
      (const float*)sfc_emis, (const float*)inc_flux, (float*)flux_up, (float*)flux_dn, nlay, ncol, ngpt, ncache,
      ds, i2f);
  return (int)cudaGetLastError();
}

namespace rrtmgp {

// The most threads a block of lw_noscat_reduced over `variant` angles (1 to 4) may have,
// both level-sum variants (errors.cu rrtmgp_max_threads).
cudaError_t lw_noscat_reduced_max_threads(int variant, int* threads) {
#define RRTMGP_MT(N) \
  max_threads(threads, lw_noscat_reduced_kernel<float, N, false>, lw_noscat_reduced_kernel<float, N, true>)
  switch (variant) {
    case 1: return RRTMGP_MT(1);
    case 2: return RRTMGP_MT(2);
    case 3: return RRTMGP_MT(3);
    case 4: return RRTMGP_MT(4);
    default: return cudaErrorInvalidValue;
  }
#undef RRTMGP_MT
}

// The most threads a block of lw_noscat_gpt may have, one block per column
// or split (errors.cu rrtmgp_max_threads); variant is 0.
cudaError_t lw_noscat_gpt_max_threads(int, int* threads) {
  return max_threads(threads, lw_noscat_gpt_kernel<float, false>, lw_noscat_gpt_kernel<float, true>);
}

}  // namespace rrtmgp
