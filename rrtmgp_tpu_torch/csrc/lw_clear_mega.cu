// Whole LW no-scattering solve in one kernel, clear or all-sky, f32 or f64.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _lw_mega_kernel (wrapper
//   lw_clear_mega): gas optics (major + minor gases, Planck fraction), the
//   McICA cloud mask, the absorption-only cloud and aerosol composition, the
//   band-Planck Clough sources, the downward radiance, the upward sweep and
//   the g-point sums; and rrtmgp_tpu/ops/pallas_mega_df.py, _lw_df_kernel
//   (wrappers lw_noscat_mega_df / solve_lw_df64): the same clear-sky solve at
//   f64 accuracy, which the TPU reaches with double-f32 pairs and four-slice
//   bf16 tables. This card has f64 units, so the f64 solve is this kernel
//   instantiated for double: f64 tables, inputs, scratch and level sums.
//
// Bound on this card: at 32768 columns x 60 layers x 256 g-points each
//   (layer, column, g-point) reads 16 table values (8 kmajor + 8 Planck
//   fraction, plus 4 kminor per covering minor interval) from ~16 MB of tables
//   that stay in the 50 MB L2, does about a hundred flops with one exp and
//   one sqrt, and writes then re-reads two reals of scratch: 4 GB out and
//   4 GB back through device memory in f32 (~2.4 ms at 3.35 TB/s), twice that
//   in f64. Expected limit in f32: the rate of loads through L1/L2 and the
//   scratch round trip, not arithmetic. In f64 the tables (~32 MB) still fit in L2,
//   but the ~5e10 f64 operations of a call, with a software exp, sqrt and
//   divide per point, meet an f64 rate half the f32 one: arithmetic and
//   registers weigh as much as the loads there.
//
// Design: one block per column, one thread per g-point (up to 1024; the
//   last warp is padded with idle threads; more g-points spread a column
//   over several blocks of the host's launch plan, each warp's level
//   partials completed in warp order by finish_level_sums, the same bits as
//   the in-block sums). The layer loop runs
//   top-down in registers: a level source needs the Planck fractions of both
//   adjacent layers, so the downward radiance crosses layer l+1 when layer l's
//   fraction is known, one step behind the optics, as in the TPU kernel. Only
//   the upward sweep needs a second pass, over (trans, src_up) scratch. Level
//   sums are warp shuffles into per-warp shared-memory slots added in a fixed
//   order at the end: deterministic, no atomics. Tables are read in
//   g-point-fastest layouts, so one band's threads read neighbouring
//   addresses. Top-down is also the McICA recurrence's direction, so in seed
//   mode the mask is drawn inline (mcica.cuh) and the column's cloud cover
//   counted with a ballot; clouds and aerosols add their absorbing optical
//   depth under their masks (allsky.cuh). The real type, cloud, aerosol and
//   mask mode are template parameters: the clear f32 variant carries none of
//   the composition's code. Nothing of the TPU blocking is kept: no one-hot
//   contraction, no bf16 hi/lo split or double-f32 arithmetic, no table
//   windows, no column padding.
#include "allsky.cuh"
#include "common.cuh"

namespace rrtmgp {

template <typename R, bool CLOUD, bool AERO, int MASK, bool SPLIT>
__global__ void lw_clear_mega_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d, AllSkyIn as,
                                     const R* __restrict__ plk_lay,   // (nbnd, nlay*ncol)
                                     const R* __restrict__ plk_lev,   // (nbnd, nlev*ncol)
                                     const R* __restrict__ plk_sfc,   // (nbnd, ncol)
                                     const R* __restrict__ sfc_emis,  // (nbnd, ncol)
                                     const R* __restrict__ inc_flux,  // (ncol, ngpt) or null
                                     R* __restrict__ trans_s,         // (nlay, ncol, ngpt)
                                     R* __restrict__ sup_s,           // (nlay, ncol, ngpt)
                                     R* __restrict__ flux_up,         // (nlev, ncol)
                                     R* __restrict__ flux_dn,         // (nlev, ncol)
                                     float* __restrict__ cover,       // (ncol,), MASK_SEED
                                     R* __restrict__ partials,        // (2, nlev, ncol, column's warps) or null
                                     int* __restrict__ cover_part,    // (ncol, groups), MASK_SEED with partials
                                     R ds, R i2f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* smem = reinterpret_cast<R*>(smem_raw);
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol;
  const auto sums = level_sums<R, SPLIT>(smem, partials, nlev);
  const R one = R(1), two = R(2);
  const int band = active ? __ldg(tb.gpt2band + g) : 0;
  const size_t lay_plane = (size_t)nlay * ncol, lev_plane = (size_t)nlev * ncol;

  R i_dn = R(0);
  if (active && inc_flux != nullptr) i_dn = inc_flux[(size_t)col * d.ngpt + g] / i2f;
  sums.add(1, nlay, i_dn);

  Key2x32 ck{0u, 0u};
  if constexpr (MASK == MASK_SEED) ck = mcica_column_key(as.seed, as.col_offset + col);
  McicaCarry carry;
  bool any_cloud = false;
  // state of the layer above (the previous, higher iteration)
  R pf_above = R(0), trans_above = R(0), fact_above = R(0), lay_above = R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const CellT<R> c = load_cell(in, d, l, col, band);
      const R pf = planck_fraction(tb, d, c, g);
      R tau = r_max(tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g), R(0));
      if constexpr (CLOUD) {
        bool m;
        if constexpr (MASK == MASK_SEED) {
          m = carry.step(mcica_uniform(ck, (uint32_t)l * (uint32_t)d.ngpt + (uint32_t)g),
                         __ldg(as.cld_frac + c.lc));
          any_cloud = any_cloud || m;
        } else {
          m = __ldg(as.cmask + c.lc * d.ngpt + g) != 0;
        }
        add_cloud_absorption(as, c.lc, d.nbnd, band, m, tau);
      }
      if constexpr (AERO) add_aerosol_absorption(as, l, col, ncol, c.lc, d.nbnd, band, tau);

      const R tau_loc = tau * ds;
      const R trans = r_exp(-tau_loc);
      const R fact = clough_factor(tau_loc, trans);
      const R lay_val = __ldg(plk_lay + band * lay_plane + c.lc) * pf;
      // level l+1: geometric mean of the adjacent fractions; at the top the
      // neighbour is the layer's own
      const R lev_above = __ldg(plk_lev + band * lev_plane + (size_t)(l + 1) * ncol + col) *
                          (l < nlay - 1 ? r_sqrt(pf * pf_above) : pf);
      const R src_up = (one - trans) * lev_above + two * fact * (lay_val - lev_above);
      if (l < nlay - 1) {
        // the radiance crosses layer l+1, whose bottom level is now known
        const R src_dn = (one - trans_above) * lev_above + two * fact_above * (lay_above - lev_above);
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
  if constexpr (MASK == MASK_SEED) {
    if constexpr (SPLIT) {
      const int n = block_count(any_cloud, (int*)smem_raw);
      if (threadIdx.x == 0) cover_part[(size_t)col * gridDim.y + blockIdx.y] = n;
    } else {
      const int n = block_count(any_cloud, (int*)(smem + 2 * nlev * (int)(blockDim.x >> 5)));
      if (threadIdx.x == 0) cover[col] = (float)n / (float)d.ngpt;
    }
  }

  // cross layer 0 (level 0 uses layer 0's own fraction), then the surface
  R i_up = R(0);
  if (active) {
    const R lev0 = __ldg(plk_lev + band * lev_plane + col) * pf_above;
    i_dn = trans_above * i_dn + ((one - trans_above) * lev0 + two * fact_above * (lay_above - lev0));
    const R emis = __ldg(sfc_emis + (size_t)band * ncol + col);
    i_up = i_dn * (one - emis) + emis * (__ldg(plk_sfc + (size_t)band * ncol + col) * pf_above);
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

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      flux_up[(size_t)lev * ncol + col] = sums.total(0, lev) * i2f;
      flux_dn[(size_t)lev * ncol + col] = sums.total(1, lev) * i2f;
    }
  }
}

// The arguments of one launch, shared by the f32 and f64 entry points.
template <typename R>
struct LwArgs {
  OpticsInT<R> in;
  TablesT<R> tb;
  Dims d;
  AllSkyIn as;
  const R *plk_lay, *plk_lev, *plk_sfc, *sfc_emis, *inc_flux;
  R *trans_s, *sup_s, *flux_up, *flux_dn;
  float* cover;
  R ds, i2f;
  int group, n_groups;  // the host's launch plan (ops/_launch.py gpoint_plan)
  R* partials;          // (2, nlev, ncol, column's warps) when n_groups > 1
  int* cover_part;      // (ncol, n_groups), seed mode with n_groups > 1
};

template <typename R, bool CLOUD, bool AERO, int MASK>
cudaError_t launch_lw(const LwArgs<R>& a, cudaStream_t stream) {
  // up to 1024 g-points one block per column, the sums in the block; beyond,
  // a column over n_groups blocks, the sums completed by finish_level_sums
  const bool in_block = a.n_groups == 1;
  const MegaLaunch m = group_launch<R>(a.d, 2, a.group, a.n_groups, in_block,
                                       MASK == MASK_SEED ? 32 * sizeof(int) : 0);  // block_count of the cover
  if (a.d.ncol == 0) return cudaGetLastError();
  auto kernel = in_block ? lw_clear_mega_kernel<R, CLOUD, AERO, MASK, false>
                         : lw_clear_mega_kernel<R, CLOUD, AERO, MASK, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(a.in, a.tb, a.d, a.as, a.plk_lay, a.plk_lev, a.plk_sfc,
                                              a.sfc_emis, a.inc_flux, a.trans_s, a.sup_s, a.flux_up, a.flux_dn,
                                              a.cover, in_block ? nullptr : a.partials, a.cover_part, a.ds, a.i2f);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return err;
  const bool seeded = MASK == MASK_SEED;
  return finish_sums<R>(stream, a.partials, 2, a.d.nlay + 1, a.d.ncol, a.n_groups * a.group / 32, SUMS_SCALED, a.i2f,
                        a.flux_up, a.flux_dn, nullptr, seeded ? a.cover_part : nullptr, a.n_groups, a.d.ngpt,
                        seeded ? a.cover : nullptr);
}

template <typename R>
OpticsInT<R> lw_optics_in(const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
                          const void* tropo_lower, const void* col_dry, const void* jeta1, const void* feta1,
                          const void* cmix1, const void* jeta2, const void* feta2, const void* cmix2,
                          const void* minor_scaling) {
  return OpticsInT<R>{(const int*)jtemp, (const R*)ftemp, (const int*)jpress, (const R*)fpress,
                      (const unsigned char*)tropo_lower, (const R*)col_dry,
                      (const int*)jeta1, (const R*)feta1, (const R*)cmix1,
                      (const int*)jeta2, (const R*)feta2, (const R*)cmix2,
                      (const R*)minor_scaling, nullptr};
}

template <typename R>
TablesT<R> lw_tables(const void* kmajor, const void* pfrac, const void* kminor, const void* gpt2band,
                     const void* minor_start, const void* minor_list, const void* minor_kbase,
                     const void* minor_band) {
  return TablesT<R>{(const R*)kmajor, (const R*)pfrac, (const R*)kminor, (const int*)gpt2band,
                    (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                    (const int*)minor_band};
}

}  // namespace rrtmgp

// f32: clear, or composed with clouds (a given mask, or McICA from the seed)
// and aerosols. cg and ag of the shared all-sky argument list are not read.
extern "C" int rrtmgp_lw_clear_mega(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kmajor, const void* pfrac, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* plk_lay, const void* plk_lev, const void* plk_sfc, const void* sfc_emis,
    const void* inc_flux,
    const void* ctau, const void* cssa, const void* cg, const void* cmask, const void* cld_frac,
    const void* atau, const void* assa, const void* ag, const void* amask,
    void* trans_s, void* sup_s, void* flux_up, void* flux_dn, void* cover, void* partials, void* cover_part,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib,
    int cloud, int aero, int mask_mode, unsigned seed_hi, unsigned seed_lo, long long col_offset,
    int group, int n_groups, float ds, float i2f, void* stream) {
  using namespace rrtmgp;
  const LwArgs<float> a{
      lw_optics_in<float>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2, feta2,
                          cmix2, minor_scaling),
      lw_tables<float>(kmajor, pfrac, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib},
      AllSkyIn{(const float*)ctau, (const float*)cssa, (const float*)cg, (const unsigned char*)cmask,
               (const float*)cld_frac, Key2x32{seed_hi, seed_lo}, col_offset,
               (const float*)atau, (const float*)assa, (const float*)ag, (const unsigned char*)amask},
      (const float*)plk_lay, (const float*)plk_lev, (const float*)plk_sfc, (const float*)sfc_emis,
      (const float*)inc_flux, (float*)trans_s, (float*)sup_s, (float*)flux_up, (float*)flux_dn,
      (float*)cover, ds, i2f, group, n_groups, (float*)partials, (int*)cover_part};
  const cudaStream_t s = (cudaStream_t)stream;
#define RRTMGP_LW(C, A, M) launch_lw<float, C, A, M>(a, s)
  cudaError_t err;
  if (!cloud) {
    err = aero ? RRTMGP_LW(false, true, MASK_NONE) : RRTMGP_LW(false, false, MASK_NONE);
  } else if (mask_mode == MASK_SEED) {
    err = aero ? RRTMGP_LW(true, true, MASK_SEED) : RRTMGP_LW(true, false, MASK_SEED);
  } else {
    err = aero ? RRTMGP_LW(true, true, MASK_GIVEN) : RRTMGP_LW(true, false, MASK_GIVEN);
  }
#undef RRTMGP_LW
  return (int)err;
}

// f64: clear sky (the solve of the TPU's double-f32 kernel), every real
// argument and the scratch in f64.
extern "C" int rrtmgp_lw_clear_mega_f64(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kmajor, const void* pfrac, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* plk_lay, const void* plk_lev, const void* plk_sfc, const void* sfc_emis,
    const void* inc_flux, void* trans_s, void* sup_s, void* flux_up, void* flux_dn, void* partials,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib,
    int group, int n_groups, double ds, double i2f, void* stream) {
  using namespace rrtmgp;
  const LwArgs<double> a{
      lw_optics_in<double>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2,
                           feta2, cmix2, minor_scaling),
      lw_tables<double>(kmajor, pfrac, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib},
      AllSkyIn{},
      (const double*)plk_lay, (const double*)plk_lev, (const double*)plk_sfc, (const double*)sfc_emis,
      (const double*)inc_flux, (double*)trans_s, (double*)sup_s, (double*)flux_up, (double*)flux_dn,
      nullptr, ds, i2f, group, n_groups, (double*)partials, nullptr};
  return (int)launch_lw<double, false, false, MASK_NONE>(a, (cudaStream_t)stream);
}
