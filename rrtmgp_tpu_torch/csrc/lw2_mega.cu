// Whole LW two-stream solve in one kernel, clear or all-sky.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _lw2_mega_kernel (wrapper
//   lw2_mega): gas optics (major + minor gases, Planck fraction), the McICA
//   cloud mask, cloud and aerosol composition, the level Planck sources, the
//   Meador-Weaver / Toon layer coefficients, the Shonk-Hogan adding
//   recurrence and the g-point sums.
//
// Bound on this card: at 75748 columns x 60 layers x 256 g-points each
//   (layer, column, g-point) reads 16 table values (8 kmajor + 8 Planck
//   fraction, plus 4 kminor per covering minor interval) from tables that
//   stay in L2 and does ~150 flops with three exp, two sqrt and three
//   divides; in seed mode the McICA draw adds one threefry block (~1e12
//   integer operations at full size). Its inputs and outputs are ~0.3 GB.
//   What it costs beyond: the adding method's state, four floats and in seed
//   mode a mask byte per (layer, g-point), written once and read back (~37
//   GB of traffic a call), and the latency of the dependent table loads.
//
// Design: one block per column, one thread per g-point (up to 1024; more
//   spread a column over several blocks of the host's launch plan, the level
//   partials completed in warp order by finish_level_sums, the same bits). In
//   seed mode a top-down pre-pass draws the McICA mask into a byte array (the
//   recurrence runs top-down, the adding recurrence bottom-up) and counts the
//   column's cloud cover. The main pass runs bottom-up: optics and
//   composition of layer l, then the level source at the layer's bottom (it
//   needs the Planck fractions of both adjacent layers), then layer l-1 is
//   completed one step late, when its top level source exists, as in the TPU
//   kernel. Each completed layer stores what the top-down flux pass needs,
//   folded by the adding denominator: td = Tdif*denom, sc = denom*(Rdif*src +
//   src_dn), and the albedo and source at its bottom level; the pass then
//   needs no divide. The state lives in device memory, each thread's slots
//   addressed from pointers to its (col, g) by layer. The TPU kernel keeps it
//   in VMEM; here a block's whole state in shared memory (one warp of
//   g-points a block, 6 warps per SM at 60 layers) and the bottom layers of
//   it beside a full block of g-points were both slower than device memory
//   at full width: the optics loop waits on dependent table loads and needs
//   the warps that shared memory would take (PERF.md). Level sums are
//   deterministic per-warp partials (common.cuh). Cloud, aerosol, mask mode
//   and the split of a column are template parameters, so the clear variant
//   carries none of their code. The layer coefficients are
//   lw_twostream.cuh's, shared with the sweep from materialized optics
//   (lw_2stream_reduced.cu).
#include "allsky.cuh"
#include "common.cuh"
#include "lw_twostream.cuh"

namespace rrtmgp {

template <bool CLOUD, bool AERO, int MASK, bool SPLIT>
__global__ void lw2_mega_kernel(OpticsIn in, Tables tb, Dims d, AllSkyIn as,
                                const float* __restrict__ plk_lev,   // (nbnd, nlev*ncol)
                                const float* __restrict__ plk_sfc,   // (nbnd, ncol)
                                const float* __restrict__ sfc_emis,  // (nbnd, ncol)
                                const float* __restrict__ inc_flux,  // (ncol, ngpt) or null
                                unsigned char* __restrict__ mask_s,  // (nlay, ncol, ngpt), MASK_SEED
                                float* __restrict__ s_td,            // 4 x (nlay, ncol, ngpt)
                                float* __restrict__ s_sc,
                                float* __restrict__ s_alb,
                                float* __restrict__ s_src,
                                float* __restrict__ partials,        // SPLIT: (2, nlev, ncol, column's warps)
                                int* __restrict__ cover_part,        // SPLIT, MASK_SEED: (ncol, groups)
                                float* __restrict__ flux_up,         // (nlev, ncol)
                                float* __restrict__ flux_dn,
                                float* __restrict__ cover) {         // (ncol,), MASK_SEED
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol, ngpt = d.ngpt;
  const int nwarps = (int)(blockDim.x >> 5);
  const auto sums = level_sums<float, SPLIT>(smem, partials, nlev);
  const int band = active ? __ldg(tb.gpt2band + g) : 0;
  const size_t lev_plane = (size_t)nlev * ncol;
  const float pi = 3.14159265358979323846f;
  enum { UP = 0, DN = 1 };
  // this thread's slots: layer l at [l * stride]
  const size_t g0 = (size_t)col * ngpt + g, stride = (size_t)ncol * ngpt;
  float *td = s_td + g0, *sc = s_sc + g0, *al = s_alb + g0, *sr = s_src + g0;
  unsigned char* mk = mask_s + g0;

  // pass 0, top-down: McICA mask to the byte array, and the cloud cover
  if constexpr (MASK == MASK_SEED) {
    bool any_cloud = false;
    if (active) {
      const Key2x32 ck = mcica_column_key(as.seed, as.col_offset + col);
      McicaCarry carry;
      for (int l = nlay - 1; l >= 0; --l) {
        const bool m = carry.step(mcica_uniform(ck, (uint32_t)l * (uint32_t)ngpt + (uint32_t)g),
                                  __ldg(as.cld_frac + (size_t)l * ncol + col));
        mk[l * stride] = m;
        any_cloud = any_cloud || m;
      }
    }
    if constexpr (SPLIT) {
      const int n = block_count(any_cloud, (int*)smem);
      if (threadIdx.x == 0) cover_part[(size_t)col * gridDim.y + blockIdx.y] = n;
    } else {
      const int n = block_count(any_cloud, (int*)(smem + 2 * nlev * nwarps));
      if (threadIdx.x == 0) cover[col] = (float)n / (float)ngpt;
    }
  }

  // pass 1, bottom-up: optics, composition, sources, coefficients, adding
  float alb = 0.f, src = 0.f;
  if (active) {
    const float emis = __ldg(sfc_emis + (size_t)band * ncol + col);
    float pf_prev = 0.f, tau_p = 0.f, ssa_p = 0.f, g_p = 0.f, lev_p = 0.f;
    // complete layer lay (below the current one) from its top level source
    auto complete = [&](int lay, float lev_top) {
      float Rdif, Tdif, src_up, src_dn;
      lw2_coeffs(tau_p, ssa_p, g_p, lev_p, lev_top, Rdif, Tdif, src_up, src_dn);
      const float denom = 1.f / (1.f - Rdif * alb);
      const size_t s = (size_t)lay * stride;
      td[s] = Tdif * denom;
      sc[s] = denom * (Rdif * src + src_dn);
      al[s] = alb;
      sr[s] = src;
      const float alb_n = Rdif + Tdif * Tdif * alb * denom;
      const float src_n = src_up + Tdif * denom * (src + alb * src_dn);
      alb = alb_n;
      src = src_n;
    };
    for (int l = 0; l < nlay; ++l) {
      const Cell c = load_cell(in, d, l, col, band);
      float v0, v1;
      interp_p_eta(tb.second, d, c, g, v0, v1);
      const float pf = (1.f - c.ft) * v0 + c.ft * v1;
      float tau = fmaxf(tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g), 0.f);
      float ssa = 0.f, gg = 0.f;
      if constexpr (CLOUD) {
        const bool m = MASK == MASK_SEED ? mk[l * stride] != 0 : __ldg(as.cmask + c.lc * ngpt + g) != 0;
        add_cloud(as, c.lc, d.nbnd, band, m, tau, ssa, gg);
      }
      if constexpr (AERO) add_aerosol(as, l, col, ncol, c.lc, d.nbnd, band, tau, ssa, gg);
      // level l: geometric mean of the adjacent fractions; the surface level
      // takes layer 0's own
      const float plk = __ldg(plk_lev + band * lev_plane + c.lc);
      const float lev = plk * (l > 0 ? sqrtf(pf_prev * pf) : pf);
      if (l == 0) {
        alb = 1.f - emis;
        src = pi * emis * (__ldg(plk_sfc + (size_t)band * ncol + col) * pf);
      } else {
        complete(l - 1, lev);
      }
      pf_prev = pf;
      tau_p = tau;
      ssa_p = ssa;
      g_p = gg;
      lev_p = lev;
    }
    // the top layer: its top level takes its own fraction
    complete(nlay - 1, __ldg(plk_lev + band * lev_plane + (size_t)nlay * ncol + col) * pf_prev);
  }

  // pass 2, top-down diffuse flux
  float fd = (active && inc_flux != nullptr) ? inc_flux[g0] : 0.f;
  sums.add(UP, nlay, active ? alb * fd + src : 0.f);
  sums.add(DN, nlay, fd);
  for (int l = nlay - 1; l >= 0; --l) {
    float up = 0.f;
    if (active) {
      const size_t s = (size_t)l * stride;
      fd = td[s] * fd + sc[s];
      up = al[s] * fd + sr[s];
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

template <bool CLOUD, bool AERO, int MASK>
cudaError_t launch_lw2(const MegaLaunch& m, bool split, cudaStream_t stream, OpticsIn in, Tables tb, Dims d,
                       AllSkyIn as, const float* plk_lev, const float* plk_sfc, const float* sfc_emis,
                       const float* inc, unsigned char* mask_s, float* const* s, float* part, int* cover_part,
                       float* up, float* dn, float* cover) {
  auto kernel = split ? lw2_mega_kernel<CLOUD, AERO, MASK, true> : lw2_mega_kernel<CLOUD, AERO, MASK, false>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(in, tb, d, as, plk_lev, plk_sfc, sfc_emis, inc, mask_s, s[0], s[1],
                                              s[2], s[3], part, cover_part, up, dn, cover);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// group, n_groups, in_block: the host's launch plan (ops/_launch.py gpoint_plan);
// partials (2, nlev, ncol, column's warps) and, in seed mode, cover_part
// (ncol, n_groups) int32 unless in_block, else null.
extern "C" int rrtmgp_lw2_mega(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kmajor, const void* pfrac, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* plk_lev, const void* plk_sfc, const void* sfc_emis, const void* inc_flux,
    const void* ctau, const void* cssa, const void* cg, const void* cmask, const void* cld_frac,
    const void* atau, const void* assa, const void* ag, const void* amask,
    void* mask_s, void* s_td, void* s_sc, void* s_alb, void* s_src, void* partials, void* cover_part,
    void* flux_up, void* flux_dn, void* cover,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib,
    int cloud, int aero, int mask_mode, unsigned seed_hi, unsigned seed_lo, long long col_offset,
    int group, int n_groups, int in_block, void* stream) {
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
  const AllSkyIn as{(const float*)ctau, (const float*)cssa, (const float*)cg, (const unsigned char*)cmask,
                    (const float*)cld_frac, Key2x32{seed_hi, seed_lo}, col_offset,
                    (const float*)atau, (const float*)assa, (const float*)ag, (const unsigned char*)amask};
  const bool split = !in_block;
  // block_count of the McICA cover after the in-block sums
  const MegaLaunch m = group_launch(d, 2, group, n_groups, !split, 32 * sizeof(int));
  const cudaStream_t s = (cudaStream_t)stream;
  float* const st[4] = {(float*)s_td, (float*)s_sc, (float*)s_alb, (float*)s_src};
  float *up = (float*)flux_up, *dn = (float*)flux_dn, *part = (float*)partials;
  int* cp = (int*)cover_part;
  float* cv = (float*)cover;
#define RRTMGP_LW2(C, A, M) launch_lw2<C, A, M>(m, split, s, in, tb, d, as, (const float*)plk_lev, \
                                              (const float*)plk_sfc, (const float*)sfc_emis, (const float*)inc_flux, \
                                              (unsigned char*)mask_s, st, part, cp, up, dn, cv)
  cudaError_t err;
  if (!cloud) {
    err = aero ? RRTMGP_LW2(false, true, MASK_NONE) : RRTMGP_LW2(false, false, MASK_NONE);
  } else if (mask_mode == MASK_SEED) {
    err = aero ? RRTMGP_LW2(true, true, MASK_SEED) : RRTMGP_LW2(true, false, MASK_SEED);
  } else {
    err = aero ? RRTMGP_LW2(true, true, MASK_GIVEN) : RRTMGP_LW2(true, false, MASK_GIVEN);
  }
#undef RRTMGP_LW2
  if (err != cudaSuccess || !split) return (int)err;
  const bool seeded = cloud && mask_mode == MASK_SEED;
  return (int)finish_sums<float>(s, part, 2, nlay + 1, ncol, n_groups * group / 32, SUMS_PLAIN, 1.f, up, dn,
                                 nullptr, seeded ? cp : nullptr, n_groups, ngpt, seeded ? cv : nullptr);
}

namespace rrtmgp {

// The most threads a block of lw2_mega's instance `variant` may have, both
// level-sum variants (the launch plan's limit; errors.cu
// rrtmgp_max_threads): variant = cloud | aero << 1 | mask_mode << 2.
cudaError_t lw2_mega_max_threads(int variant, int* threads) {
#define RRTMGP_MT(C, A, M) \
  max_threads(threads, lw2_mega_kernel<C, A, M, false>, lw2_mega_kernel<C, A, M, true>)
  const bool cloud = variant & 1, aero = variant & 2;
  if (!cloud)
    return aero ? RRTMGP_MT(false, true, MASK_NONE) : RRTMGP_MT(false, false, MASK_NONE);
  if ((variant >> 2 & 3) == MASK_SEED)
    return aero ? RRTMGP_MT(true, true, MASK_SEED) : RRTMGP_MT(true, false, MASK_SEED);
  return aero ? RRTMGP_MT(true, true, MASK_GIVEN) : RRTMGP_MT(true, false, MASK_GIVEN);
#undef RRTMGP_MT
}

}  // namespace rrtmgp
