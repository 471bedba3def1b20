// Whole SW two-stream solve in one kernel, clear or all-sky.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _sw_mega_kernel (wrapper
//   sw_clear_mega): gas optics with Rayleigh scattering, the McICA cloud
//   mask, cloud and aerosol composition (band properties delta-scaled by the
//   caller), the PIFM / Meador-Weaver layer coefficients with their energy
//   clamps, the direct beam, the adding recurrence and the g-point sums.
//
// Bound on this card: at 32768 columns x 60 layers x 224 g-points each
//   (layer, column, g-point) reads 12 table values (8 kmajor + 4 Rayleigh,
//   plus 4 kminor per covering minor interval) from tables that stay in L2,
//   does ~150 flops with three exp, one sqrt and two divides: ~1 ms at the
//   card's f32 rate; its inputs and outputs are ~0.1 GB. What it costs
//   beyond: the adding method's state, four floats per (layer, g-point) that
//   the passes write, read and rewrite (~28 GB of traffic a call), and the
//   latency of the dependent table loads.
//
// Design: one block per column, one thread per g-point (up to 1024; more
//   spread a column over several blocks of the host's launch plan, the level
//   partials completed in warp order by finish_level_sums, the same bits).
//   The optics loop runs top-down, which is also the direct beam's
//   direction: the beam rides in a register (beam *= exp(-tau/mu0) per
//   layer) and the coefficients go to the state already multiplied by the
//   beam at the top of their layer. The bottom-up adding pass overwrites the
//   state with what the top-down flux pass needs (sw_twostream.cuh, shared
//   with the sweep of the two-kernel path), so no (nlev, ncol, ngpt)
//   albedo/source arrays exist. The state lives in device memory, four
//   (nlay, ncol, ngpt) arrays: the optics loop stores at the cell's offset,
//   which it has at hand, and the passes address each thread's slots from a
//   pointer to its (col, g) by layer. The TPU kernel keeps it in VMEM; here a
//   block's whole state in shared memory (one warp of g-points a block, 7
//   warps per SM at 60 layers) and the bottom layers of it beside a full
//   block of g-points were both slower than device memory at full width: the
//   optics loop waits on dependent table loads and needs the warps that
//   shared memory would take (PERF.md). mu0 guarded by eps enters only
//   the beam transmittance; the coefficients see the raw mu0. Night columns
//   are zeroed by the caller. All-sky: the optics loop runs top-down, which
//   is the McICA recurrence's direction, so in seed mode the mask is drawn
//   inline (mcica.cuh) and the column's cloud cover counted; clouds and
//   aerosols compose under their masks (allsky.cuh). Cloud, aerosol, mask
//   mode and the split of a column are template parameters: the clear
//   variant is the clear-sky kernel, with g = 0 folded in.
#include "allsky.cuh"
#include "common.cuh"
#include "sw_twostream.cuh"

namespace rrtmgp {

template <bool CLOUD, bool AERO, int MASK, bool SPLIT>
__global__ void sw_clear_mega_kernel(OpticsIn in, Tables tb, Dims d, AllSkyIn as,
                                     const float* __restrict__ mu0_col,   // (ncol,)
                                     const float* __restrict__ toa_gpt,   // (ncol, ngpt)
                                     const float* __restrict__ alb_dir,   // (nbnd, ncol)
                                     const float* __restrict__ alb_dif,   // (nbnd, ncol)
                                     const float* __restrict__ inc_dif,   // (ncol, ngpt) or null
                                     float* __restrict__ s_rdir,          // 4 x (nlay, ncol, ngpt)
                                     float* __restrict__ s_tdir,
                                     float* __restrict__ s_rdif,
                                     float* __restrict__ s_tdif,
                                     float* __restrict__ partials,        // SPLIT: (3, nlev, ncol, column's warps)
                                     int* __restrict__ cover_part,        // SPLIT, MASK_SEED: (ncol, groups)
                                     float* __restrict__ flux_up,         // 3 x (nlev, ncol)
                                     float* __restrict__ flux_dn,
                                     float* __restrict__ flux_dir,
                                     float* __restrict__ cover) {         // (ncol,), MASK_SEED
  extern __shared__ float smem[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol;
  const auto sums = level_sums<float, SPLIT>(smem, partials, nlev);
  const size_t g0 = (size_t)col * d.ngpt + g;
  const int band = active ? __ldg(tb.gpt2band + g) : 0;
  const float mu0 = __ldg(mu0_col + col);
  const float mu0_safe = fmaxf(mu0, FLT_EPSILON);

  // phase 1, top-down: optics + coefficients to the state, beam in a register
  float beam = active ? __ldg(toa_gpt + g0) * mu0 : 0.f;
  sums.add(SW_DIR, nlay, beam);
  Key2x32 ck{0u, 0u};
  if constexpr (MASK == MASK_SEED) ck = mcica_column_key(as.seed, as.col_offset + col);
  McicaCarry carry;
  bool any_cloud = false;
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const Cell c = load_cell(in, d, l, col, band);
      const float tau_ray = tau_rayleigh(in, tb, d, c, g);
      float tau = fmaxf(tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g) + tau_ray, 0.f);
      float ssa = tau > 0.f ? tau_ray / tau : 0.f;
      float gg = 0.f;
      if constexpr (CLOUD) {
        bool m;
        if constexpr (MASK == MASK_SEED) {
          m = carry.step(mcica_uniform(ck, (uint32_t)l * (uint32_t)d.ngpt + (uint32_t)g),
                         __ldg(as.cld_frac + c.lc));
          any_cloud = any_cloud || m;
        } else {
          m = __ldg(as.cmask + c.lc * d.ngpt + g) != 0;
        }
        add_cloud(as, c.lc, d.nbnd, band, m, tau, ssa, gg);
      }
      if constexpr (AERO) add_aerosol(as, l, col, ncol, c.lc, d.nbnd, band, tau, ssa, gg);
      const float T0 = expf(-tau / mu0_safe);
      float Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(tau, ssa, (CLOUD || AERO) ? gg : 0.f, mu0, T0, Rdir, Tdir, Rdif, Tdif);
      const size_t i = c.lc * d.ngpt + g;
      s_rdir[i] = Rdir * beam;
      s_tdir[i] = Tdir * beam;
      s_rdif[i] = Rdif;
      s_tdif[i] = Tdif;
      beam *= T0;
    }
    sums.add(SW_DIR, l, beam);
  }
  if constexpr (MASK == MASK_SEED) {
    if constexpr (SPLIT) {
      const int n = block_count(any_cloud, (int*)smem);
      if (threadIdx.x == 0) cover_part[(size_t)col * gridDim.y + blockIdx.y] = n;
    } else {
      const int n = block_count(any_cloud, (int*)(smem + 3 * nlev * (int)(blockDim.x >> 5)));
      if (threadIdx.x == 0) cover[col] = (float)n / (float)d.ngpt;
    }
  }

  // phases 2 and 3: bottom-up adding, top-down diffuse flux, level sums
  sw_adding_and_fluxes(d, sums, col, g, active, band, beam, alb_dir, alb_dif, inc_dif, s_rdir + g0, s_tdir + g0,
                       s_rdif + g0, s_tdif + g0, flux_up, flux_dn, flux_dir);
}

template <bool CLOUD, bool AERO, int MASK>
cudaError_t launch_sw(const MegaLaunch& m, bool split, cudaStream_t stream, OpticsIn in, Tables tb, Dims d,
                      AllSkyIn as, const float* mu0, const float* toa_gpt, const float* alb_dir,
                      const float* alb_dif, const float* inc_dif, float* const* s, float* part, int* cover_part,
                      float* up, float* dn, float* dir, float* cover) {
  auto kernel = split ? sw_clear_mega_kernel<CLOUD, AERO, MASK, true> : sw_clear_mega_kernel<CLOUD, AERO, MASK, false>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(in, tb, d, as, mu0, toa_gpt, alb_dir, alb_dif, inc_dif, s[0], s[1],
                                              s[2], s[3], part, cover_part, up, dn, dir, cover);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// group, n_groups, in_block: the host's launch plan (ops/_launch.py
// gpoint_plan); partials (3, nlev, ncol, column's warps) and, in seed mode,
// cover_part (ncol, n_groups) int32 unless in_block, else null.
extern "C" int rrtmgp_sw_clear_mega(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* ray_factor,
    const void* kmajor, const void* rayl, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* mu0, const void* toa_gpt, const void* alb_dir, const void* alb_dif, const void* inc_dif,
    const void* ctau, const void* cssa, const void* cg, const void* cmask, const void* cld_frac,
    const void* atau, const void* assa, const void* ag, const void* amask,
    void* s_rdir, void* s_tdir, void* s_rdif, void* s_tdif, void* partials, void* cover_part,
    void* flux_up, void* flux_dn, void* flux_dir, void* cover,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib,
    int cloud, int aero, int mask_mode, unsigned seed_hi, unsigned seed_lo, long long col_offset,
    int group, int n_groups, int in_block, void* stream) {
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
  const AllSkyIn as{(const float*)ctau, (const float*)cssa, (const float*)cg, (const unsigned char*)cmask,
                    (const float*)cld_frac, Key2x32{seed_hi, seed_lo}, col_offset,
                    (const float*)atau, (const float*)assa, (const float*)ag, (const unsigned char*)amask};
  const bool split = !in_block;
  // block_count of the McICA cover after the in-block sums
  const MegaLaunch m = group_launch(d, 3, group, n_groups, !split, 32 * sizeof(int));
  const cudaStream_t s = (cudaStream_t)stream;
  float* const st[4] = {(float*)s_rdir, (float*)s_tdir, (float*)s_rdif, (float*)s_tdif};
  float *up = (float*)flux_up, *dn = (float*)flux_dn, *dir = (float*)flux_dir, *part = (float*)partials;
  int* cp = (int*)cover_part;
  float* cv = (float*)cover;
#define RRTMGP_SW(C, A, M) launch_sw<C, A, M>(m, split, s, in, tb, d, as, (const float*)mu0, (const float*)toa_gpt, \
                                            (const float*)alb_dir, (const float*)alb_dif, (const float*)inc_dif, st, \
                                            part, cp, up, dn, dir, cv)
  cudaError_t err;
  if (!cloud) {
    err = aero ? RRTMGP_SW(false, true, MASK_NONE) : RRTMGP_SW(false, false, MASK_NONE);
  } else if (mask_mode == MASK_SEED) {
    err = aero ? RRTMGP_SW(true, true, MASK_SEED) : RRTMGP_SW(true, false, MASK_SEED);
  } else {
    err = aero ? RRTMGP_SW(true, true, MASK_GIVEN) : RRTMGP_SW(true, false, MASK_GIVEN);
  }
#undef RRTMGP_SW
  if (err != cudaSuccess || !split) return (int)err;
  const bool seeded = cloud && mask_mode == MASK_SEED;
  return (int)finish_sums<float>(s, part, 3, nlay + 1, ncol, n_groups * group / 32, SUMS_SW, 1.f, up, dn, dir,
                                 seeded ? cp : nullptr, n_groups, ngpt, seeded ? cv : nullptr);
}
