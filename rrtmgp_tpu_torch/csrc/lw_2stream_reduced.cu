// LW two-stream sweep from materialized optics and level sources: fluxes
// summed over g-points.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_2stream_reduced_kernel (wrapper
//   lw_2stream_pallas_reduced): from tau, ssa, g per (layer, column, g-point)
//   and the level Planck sources per (level, column, g-point), the
//   Meador-Weaver diffuse reflectance and transmittance, the Toon
//   linear-in-tau layer sources, the Shonk-Hogan adding recurrence from the
//   surface, the diffuse flux from the top, and the g-point sums of up and
//   down flux at every level.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau, ssa and g are 3 x 2.01 GB, the level sources 2.05 GB, the
//   outputs 16 MB: 8.1 GB, 2.4 ms at 3.35 TB/s. This design reads the four
//   inputs twice and writes and reads two scratch arrays: ~24 GB, three
//   times the bytes of the bound. Four exp, two sqrt and five divides per point (the coefficients twice).
//
// Design: one block per column, one thread per g-point (more than 1024: a
//   column over several blocks, the sums completed by finish_level_sums),
//   the LW two-stream megakernel's recurrence (lw2_mega.cu). The bottom-up pass
//   computes each layer's coefficients, stores the albedo and the source at
//   the layer's bottom level in two scratch arrays in device memory and
//   carries the adding recurrence in registers. The top-down pass computes
//   the coefficients again from the inputs instead of reading them back:
//   storing them folded, as the megakernel does (four arrays), moves the same
//   bytes (four written and four read against two written, two read and four
//   inputs read again) but holds twice the scratch, and this kernel's inputs
//   already stand in memory at full size beside it. The coefficient function
//   is lw_twostream.cuh's and the recurrence is folded with the megakernel's
//   expressions (td = Tdif * denom, sc = denom * (Rdif * src + src_dn)), so
//   the two routes agree to the last bit on equal optics and sources. The
//   emissivity is band-valued, (nbnd, ncol), read through gpt2band, as the
//   solves hold it; the surface source is per g-point. Level sums are
//   deterministic per-warp partials (common.cuh). The real type is a template
//   parameter (the entry point builds f32). Nothing of the TPU kernel's
//   structure is kept: no DMA ring, no column blocks, no lane or column
//   padding.
#include "common.cuh"
#include "lw_twostream.cuh"

namespace rrtmgp {

template <typename R, bool SPLIT>
__global__ void lw_2stream_reduced_kernel(const R* __restrict__ tau,         // (nlay, ncol, ngpt)
                                          const R* __restrict__ ssa,         // (nlay, ncol, ngpt)
                                          const R* __restrict__ gasym,       // (nlay, ncol, ngpt)
                                          const R* __restrict__ lev_source,  // (nlev, ncol, ngpt)
                                          const R* __restrict__ sfc_source,  // (ncol, ngpt)
                                          const R* __restrict__ sfc_emis,    // (nbnd, ncol)
                                          const int* __restrict__ gpt2band,  // (ngpt,)
                                          const R* __restrict__ inc_flux,    // (ncol, ngpt) or null
                                          R* __restrict__ s_alb,             // 2 x (nlay, ncol, ngpt)
                                          R* __restrict__ s_src,
                                          R* __restrict__ flux_up,           // (nlev, ncol)
                                          R* __restrict__ flux_dn,
                                          R* __restrict__ partials,          // (2, nlev, ncol, column's warps) or null
                                          int nlay, int ncol, int ngpt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const size_t stride = (size_t)ncol * ngpt, g0 = (size_t)col * ngpt + g;
  const R one = R(1), pi = R(3.14159265358979323846);
  enum { UP = 0, DN = 1 };

  // bottom-up: coefficients, the albedo and source below each layer to
  // scratch, the adding recurrence in registers
  R alb = R(0), src = R(0);
  if (active) {
    const R emis = __ldg(sfc_emis + (size_t)__ldg(gpt2band + g) * ncol + col);
    alb = one - emis;
    src = pi * emis * __ldg(sfc_source + g0);
    R lev_bot = __ldg(lev_source + g0);
    for (int l = 0; l < nlay; ++l) {
      const size_t s = (size_t)l * stride + g0;
      const R lev_top = __ldg(lev_source + s + stride);
      R Rdif, Tdif, src_up, src_dn;
      lw2_coeffs(__ldg(tau + s), __ldg(ssa + s), __ldg(gasym + s), lev_bot, lev_top, Rdif, Tdif, src_up, src_dn);
      const R denom = one / (one - Rdif * alb);
      s_alb[s] = alb;
      s_src[s] = src;
      const R alb_n = Rdif + Tdif * Tdif * alb * denom;
      const R src_n = src_up + Tdif * denom * (src + alb * src_dn);
      alb = alb_n;
      src = src_n;
      lev_bot = lev_top;
    }
  }

  // top-down diffuse flux
  R fd = (active && inc_flux != nullptr) ? inc_flux[g0] : R(0);
  sums.add(UP, nlay, active ? alb * fd + src : R(0));
  sums.add(DN, nlay, fd);
  R lev_top = active ? __ldg(lev_source + (size_t)nlay * stride + g0) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    R up = R(0);
    if (active) {
      const size_t s = (size_t)l * stride + g0;
      const R lev_bot = __ldg(lev_source + s);
      R Rdif, Tdif, src_up, src_dn;
      lw2_coeffs(__ldg(tau + s), __ldg(ssa + s), __ldg(gasym + s), lev_bot, lev_top, Rdif, Tdif, src_up, src_dn);
      const R alb_l = s_alb[s], src_l = s_src[s];
      const R denom = one / (one - Rdif * alb_l);
      fd = (Tdif * denom) * fd + denom * (Rdif * src_l + src_dn);
      up = alb_l * fd + src_l;
      lev_top = lev_bot;
    }
    sums.add(UP, l, up);
    sums.add(DN, l, fd);
  }

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      flux_up[(size_t)lev * ncol + col] = sums.total(UP, lev);
      flux_dn[(size_t)lev * ncol + col] = sums.total(DN, lev);
    }
  }
}

}  // namespace rrtmgp

// f32; inc_flux null = no incident flux. group, n_groups, in_block: the
// host's launch plan; partials (2, nlev, ncol, column's warps) unless
// in_block, else null.
extern "C" int rrtmgp_lw_2stream_reduced(const void* tau, const void* ssa, const void* gasym,
                                         const void* lev_source, const void* sfc_source, const void* sfc_emis,
                                         const void* gpt2band, const void* inc_flux, void* s_alb, void* s_src,
                                         void* flux_up, void* flux_dn, void* partials, int nlay, int ncol, int ngpt,
                                         int nbnd, int group, int n_groups, int in_block, void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  const MegaLaunch m = group_launch<float>(d, 2, group, n_groups, in_block);
  const cudaStream_t s = (cudaStream_t)stream;
  auto kernel = in_block ? lw_2stream_reduced_kernel<float, false> : lw_2stream_reduced_kernel<float, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<m.grid, m.block, m.smem, s>>>(
      (const float*)tau, (const float*)ssa, (const float*)gasym, (const float*)lev_source,
      (const float*)sfc_source, (const float*)sfc_emis, (const int*)gpt2band, (const float*)inc_flux,
      (float*)s_alb, (float*)s_src, (float*)flux_up, (float*)flux_dn, in_block ? nullptr : (float*)partials, nlay,
      ncol, ngpt);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return (int)err;
  return (int)finish_sums<float>(s, (const float*)partials, 2, nlay + 1, ncol, n_groups * group / 32, SUMS_PLAIN,
                                 1.f, (float*)flux_up, (float*)flux_dn, nullptr);
}
