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
//   the in-block sums; so are a column's sums when they would not fit the
//   block's shared memory). The layer loop runs
//   top-down in registers: a level source needs the Planck fractions of both
//   adjacent layers, so the downward radiance crosses layer l+1 when layer l's
//   fraction is known, one step behind the optics, as in the TPU kernel. Only
//   the upward sweep needs a second pass, over (trans, src_up) scratch, each
//   thread's slots addressed from a pointer to its (col, g) plus l x ncol x
//   ngpt. Level sums are warp shuffles into per-warp shared-memory slots
//   added in a fixed order at the end: deterministic, no atomics.
//
//   What a column's g-points share is staged in shared memory by chunks of
//   LW_CHUNK layers (gather.cuh): the block copies chunk k+1's inputs with
//   asynchronous copies (cp.async) while it computes chunk k, then forms
//   each (layer, band)'s table corner offsets and weights once, so a
//   thread's layer step reads them, the band Planck values, the minor
//   scalings and the cloud and aerosol absorption from shared memory
//   instead of ~20 dependent global loads; each interval's band and kminor
//   base are staged once per block. Shared memory does not grow with nlay.
//   Tables are read in g-point-fastest layouts, so one band's threads read
//   neighbouring addresses. Top-down is also the McICA recurrence's
//   direction, so in seed mode the mask is drawn inline (mcica.cuh) and the
//   column's cloud cover counted with a ballot; clouds and aerosols add
//   their absorbing optical depth under their masks. The real type, cloud,
//   aerosol and mask mode are template parameters: the clear f32 variant
//   carries none of the composition's code. The optics keep the operation
//   order of common.cuh's helpers, so the bits are those of the other
//   kernels'. Nothing of the TPU blocking is kept: no one-hot contraction,
//   no bf16 hi/lo split or double-f32 arithmetic, no table windows, no
//   column padding.
#include "allsky.cuh"
#include "common.cuh"
#include "gather.cuh"

namespace rrtmgp {

// Layers of one staged chunk.
constexpr int LW_CHUNK = 8;

// Shared memory of one block (gather.cuh ChunkLayout).
template <typename R, bool CLOUD, bool AERO, int MASK>
using LwLayout = ChunkLayout<R, LW_CHUNK, false, CLOUD, AERO, MASK>;

template <typename R, bool CLOUD, bool AERO, int MASK, bool SPLIT>
__global__ void lw_clear_mega_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d, int n_minor, AllSkyIn as,
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
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol, nbnd = d.nbnd;
  const size_t sums_bytes = SPLIT ? 0 : sizeof(R) * 2 * nlev * (blockDim.x >> 5);
  const LwLayout<R, CLOUD, AERO, MASK> lay(sums_bytes, nbnd, n_minor);
  int* count32 = reinterpret_cast<int*>(smem_raw + sums_bytes);
  StagedCol<R>* s_col = reinterpret_cast<StagedCol<R>*>(smem_raw + lay.cols);
  StagedBand<R>* s_band = reinterpret_cast<StagedBand<R>*>(smem_raw + lay.bands);
  R* s_cabs = reinterpret_cast<R*>(smem_raw + lay.cabs);
  R* s_aabs = reinterpret_cast<R*>(smem_raw + lay.aabs);
  int* mband = reinterpret_cast<int*>(smem_raw + lay.mband);
  int* mkbase = mband + n_minor;
  const auto sums = level_sums<R, SPLIT>(smem, partials, nlev);
  const R one = R(1), two = R(2);
  const size_t lay_plane = (size_t)nlay * ncol, lev_plane = (size_t)nlev * ncol;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_chunks = (nlay + LW_CHUNK - 1) / LW_CHUNK;

  // chunk k holds layers top(k), top(k) - 1, ..., slot j = top(k) - l
  auto chunk_top = [&](int k) { return nlay - 1 - k * LW_CHUNK; };
  auto chunk_len = [&](int k) { return min(LW_CHUNK, chunk_top(k) + 1); };
  // chunk k's raw buffer: its reals, then its 4-byte words
  auto raw_of = [&](int k) { return reinterpret_cast<R*>(smem_raw + ((k & 1) ? lay.raw1 : lay.raw0)); };
  auto raw_words = [&](int k) { return reinterpret_cast<int*>(raw_of(k) + lay.n_reals); };
  // the asynchronous copies of chunk k's inputs
  auto copy_chunk = [&](int k) {
    R* rr = raw_of(k);
    int* rw = raw_words(k);
    const int top = chunk_top(k), n = chunk_len(k), nb = n * nbnd;
    for (int e = tid; e < n; e += nthr) {
      const size_t lc = (size_t)(top - e) * ncol + col;
      cp_async<sizeof(R)>(rr + lay.ft + e, in.ftemp + lc);
      cp_async<sizeof(R)>(rr + lay.fp + e, in.fpress + lc);
      cp_async<sizeof(R)>(rr + lay.cd + e, in.col_dry + lc);
      cp_async<4>(rw + lay.jt + e, in.jtemp + lc);
      cp_async<4>(rw + lay.jp + e, in.jpress + lc);
      cp_async<4>(rw + lay.lower + e, byte_word(in.tropo_lower + lc));
      if constexpr (AERO) cp_async<4>(rw + lay.amask + e, byte_word(as.amask + lc));
      if constexpr (MASK == MASK_SEED) cp_async<4>(rw + lay.cfrac + e, as.cld_frac + lc);
    }
    for (int e = tid; e < nb; e += nthr) {
      const int j = e / nbnd, b = e - j * nbnd, l = top - j;
      const size_t lcb = ((size_t)l * ncol + col) * nbnd + b;
      cp_async<sizeof(R)>(rr + lay.fe1 + e, in.feta1 + lcb);
      cp_async<sizeof(R)>(rr + lay.fe2 + e, in.feta2 + lcb);
      cp_async<sizeof(R)>(rr + lay.cm1 + e, in.cmix1 + lcb);
      cp_async<sizeof(R)>(rr + lay.cm2 + e, in.cmix2 + lcb);
      cp_async<4>(rw + lay.je1 + e, in.jeta1 + lcb);
      cp_async<4>(rw + lay.je2 + e, in.jeta2 + lcb);
      cp_async<sizeof(R)>(rr + lay.play + e, plk_lay + b * lay_plane + (size_t)l * ncol + col);
      cp_async<sizeof(R)>(rr + lay.plev + e, plk_lev + b * lev_plane + (size_t)(l + 1) * ncol + col);
      if constexpr (CLOUD) {
        cp_async<4>(rr + lay.ctau + e, as.ctau + lcb);
        cp_async<4>(rr + lay.cssa + e, as.cssa + lcb);
      }
      if constexpr (AERO) {
        const size_t ab = ((size_t)l * nbnd + b) * ncol + col;
        cp_async<4>(rr + lay.atau + e, as.atau + ab);
        cp_async<4>(rr + lay.assa + e, as.assa + ab);
      }
    }
    for (int e = tid; e < n_minor * n; e += nthr) {
      const int i = e / n, j = e - i * n;
      cp_async<sizeof(R)>(rr + lay.scal + i * LW_CHUNK + j,
                          in.minor_scaling + i * lay_plane + (size_t)(top - j) * ncol + col);
    }
  };
  // chunk k's raw inputs -> its staged offsets, weights and absorption
  auto transform = [&](int k) {
    const R* rr = raw_of(k);
    const int* rw = raw_words(k);
    const int top = chunk_top(k), n = chunk_len(k), nb = n * nbnd;
    for (int j = tid; j < n; j += nthr) {
      const size_t lc = (size_t)(top - j) * ncol + col;
      set_col(rr[lay.ft + j], rr[lay.fp + j], rr[lay.cd + j],
              word_byte((unsigned)rw[lay.lower + j], in.tropo_lower + lc) != 0, s_col[j]);
      if constexpr (AERO) s_col[j].aero = word_byte((unsigned)rw[lay.amask + j], as.amask + lc) != 0;
    }
    for (int e = tid; e < nb; e += nthr) {
      const int j = e / nbnd;
      set_band<R, false>(d, rw[lay.jt + j], rw[lay.jp + j], false, rw[lay.je1 + e], rw[lay.je2 + e],
                         rr[lay.fe1 + e], rr[lay.fe2 + e], rr[lay.cm1 + e], rr[lay.cm2 + e], s_band[e]);
      if constexpr (CLOUD) {
        const R t = rr[lay.ctau + e];
        s_cabs[e] = t - rr[lay.cssa + e] * t;
      }
      if constexpr (AERO) {
        const R t = rr[lay.atau + e];
        s_aabs[e] = t - rr[lay.assa + e] * t;
      }
    }
  };

  for (int i = tid; i < n_minor; i += nthr) {
    mband[i] = __ldg(tb.minor_band + i);
    mkbase[i] = __ldg(tb.minor_kbase + i);
  }
  copy_chunk(0);

  GptMeta meta{0, {0, 0}, {0, 0}};
  if (active) meta = gpt_meta(tb.gpt2band, tb.minor_start, d.ngpt, g);
  const int band = meta.band;
  const int se = d.ngpt, sp = d.ntemp * d.neta * d.ngpt;
  const R* kmajor = tb.kmajor + g;
  const R* pfrac_t = tb.second + g;
  const R* kminor = tb.kminor + g;
  const size_t lstride = (size_t)ncol * d.ngpt;
  R* trans_p = trans_s + (size_t)col * d.ngpt + g;
  R* sup_p = sup_s + (size_t)col * d.ngpt + g;

  R i_dn = R(0);
  if (active && inc_flux != nullptr) i_dn = inc_flux[(size_t)col * d.ngpt + g] / i2f;
  sums.add(1, nlay, i_dn);

  Key2x32 ck{0u, 0u};
  if constexpr (MASK == MASK_SEED) ck = mcica_column_key(as.seed, as.col_offset + col);
  McicaCarry carry;
  bool any_cloud = false;
  // state of the layer above (the previous, higher iteration)
  R pf_above = R(0), trans_above = R(0), fact_above = R(0), lay_above = R(0);
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait_all();
    __syncthreads();  // chunk k's copies have landed; chunk k-1's steps are done
    transform(k);
    if (k + 1 < n_chunks) copy_chunk(k + 1);
    __syncthreads();  // chunk k is staged
    const R* rr = raw_of(k);
    const int* rw = raw_words(k);
    const int top = chunk_top(k), n = chunk_len(k);
    for (int j = 0; j < n; ++j) {
      const int l = top - j;
      if (active) {
        const StagedCol<R>& c = s_col[j];
        const StagedBand<R>* bands = s_band + j * nbnd;
        const StagedBand<R>& b = bands[band];
        const R pf = staged_planck_fraction(pfrac_t, sp, se, c, b);
        R tau = r_max(staged_tau_major(kmajor, sp, se, c, b) +
                          staged_tau_minor(kminor, tb.minor_list, d.ncontrib, meta, c, bands, rr + lay.scal + j,
                                           LW_CHUNK, mband, mkbase),
                      R(0));
        if constexpr (CLOUD) {
          bool m;
          if constexpr (MASK == MASK_SEED) {
            m = carry.step(mcica_uniform(ck, (uint32_t)l * (uint32_t)d.ngpt + (uint32_t)g),
                           __int_as_float(rw[lay.cfrac + j]));
            any_cloud = any_cloud || m;
          } else {
            m = __ldg(as.cmask + ((size_t)l * ncol + col) * d.ngpt + g) != 0;
          }
          if (m) tau += s_cabs[j * nbnd + band];
        }
        if constexpr (AERO) {
          if (c.aero) tau += s_aabs[j * nbnd + band];
        }

        const R tau_loc = tau * ds;
        const R trans = r_exp(-tau_loc);
        const R fact = clough_factor(tau_loc, trans);
        const R lay_val = rr[lay.play + j * nbnd + band] * pf;
        // level l+1: geometric mean of the adjacent fractions; at the top the
        // neighbour is the layer's own
        const R lev_above = rr[lay.plev + j * nbnd + band] * (l < nlay - 1 ? r_sqrt(pf * pf_above) : pf);
        const R src_up = (one - trans) * lev_above + two * fact * (lay_val - lev_above);
        if (l < nlay - 1) {
          // the radiance crosses layer l+1, whose bottom level is now known
          const R src_dn = (one - trans_above) * lev_above + two * fact_above * (lay_above - lev_above);
          i_dn = trans_above * i_dn + src_dn;
        }
        trans_p[l * lstride] = trans;
        sup_p[l * lstride] = src_up;
        pf_above = pf;
        trans_above = trans;
        fact_above = fact;
        lay_above = lay_val;
      }
      if (l < nlay - 1) sums.add(1, l + 1, i_dn);
    }
  }
  if constexpr (MASK == MASK_SEED) {
    const int n = block_count(any_cloud, count32);
    if (threadIdx.x == 0) {
      if constexpr (SPLIT) {
        cover_part[(size_t)col * gridDim.y + blockIdx.y] = n;
      } else {
        cover[col] = (float)n / (float)d.ngpt;
      }
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
    if (active) i_up = trans_p[l * lstride] * i_up + sup_p[l * lstride];
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
  int n_minor;
  AllSkyIn as;
  const R *plk_lay, *plk_lev, *plk_sfc, *sfc_emis, *inc_flux;
  R *trans_s, *sup_s, *flux_up, *flux_dn;
  float* cover;
  R ds, i2f;
  int group, n_groups;  // the host's launch plan (ops/_launch.py gpoint_plan)
  bool in_block;        // the plan's: the level sums in the block
  R* partials;          // (2, nlev, ncol, column's warps) unless in_block
  int* cover_part;      // (ncol, n_groups), seed mode unless in_block
};

// Shared memory of a block whose level sums take sums_bytes.
template <typename R, bool CLOUD, bool AERO, int MASK>
size_t lw_smem(size_t sums_bytes, int nbnd, int n_minor) {
  return LwLayout<R, CLOUD, AERO, MASK>(sums_bytes, nbnd, n_minor).stage_end;
}

template <typename R, bool CLOUD, bool AERO, int MASK>
cudaError_t launch_lw(const LwArgs<R>& a, cudaStream_t stream) {
  // one block per column with the sums in the block where they fit; else
  // the sums (of a column over n_groups >= 1 blocks) completed by
  // finish_level_sums
  const bool in_block = a.in_block;
  const size_t sums_bytes = in_block ? sizeof(R) * 2 * (a.d.nlay + 1) * (a.group / 32) : 0;
  const size_t smem = lw_smem<R, CLOUD, AERO, MASK>(sums_bytes, a.d.nbnd, a.n_minor);
  if (a.d.ncol == 0) return cudaGetLastError();
  auto kernel = in_block ? lw_clear_mega_kernel<R, CLOUD, AERO, MASK, false>
                         : lw_clear_mega_kernel<R, CLOUD, AERO, MASK, true>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)a.d.ncol, (unsigned)a.n_groups), a.group, smem, stream>>>(
      a.in, a.tb, a.d, a.n_minor, a.as, a.plk_lay, a.plk_lev, a.plk_sfc, a.sfc_emis, a.inc_flux, a.trans_s, a.sup_s,
      a.flux_up, a.flux_dn, a.cover, in_block ? nullptr : a.partials, a.cover_part, a.ds, a.i2f);
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
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor,
    int cloud, int aero, int mask_mode, unsigned seed_hi, unsigned seed_lo, long long col_offset,
    int group, int n_groups, int in_block, float ds, float i2f, void* stream) {
  using namespace rrtmgp;
  const LwArgs<float> a{
      lw_optics_in<float>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2, feta2,
                          cmix2, minor_scaling),
      lw_tables<float>(kmajor, pfrac, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib}, n_minor,
      AllSkyIn{(const float*)ctau, (const float*)cssa, (const float*)cg, (const unsigned char*)cmask,
               (const float*)cld_frac, Key2x32{seed_hi, seed_lo}, col_offset,
               (const float*)atau, (const float*)assa, (const float*)ag, (const unsigned char*)amask},
      (const float*)plk_lay, (const float*)plk_lev, (const float*)plk_sfc, (const float*)sfc_emis,
      (const float*)inc_flux, (float*)trans_s, (float*)sup_s, (float*)flux_up, (float*)flux_dn,
      (float*)cover, ds, i2f, group, n_groups, in_block != 0, (float*)partials, (int*)cover_part};
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
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor,
    int group, int n_groups, int in_block, double ds, double i2f, void* stream) {
  using namespace rrtmgp;
  const LwArgs<double> a{
      lw_optics_in<double>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2,
                           feta2, cmix2, minor_scaling),
      lw_tables<double>(kmajor, pfrac, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib}, n_minor,
      AllSkyIn{},
      (const double*)plk_lay, (const double*)plk_lev, (const double*)plk_sfc, (const double*)sfc_emis,
      (const double*)inc_flux, (double*)trans_s, (double*)sup_s, (double*)flux_up, (double*)flux_dn,
      nullptr, ds, i2f, group, n_groups, in_block != 0, (double*)partials, nullptr};
  return (int)launch_lw<double, false, false, MASK_NONE>(a, (cudaStream_t)stream);
}

// The shared memory a block of lw_clear_mega needs besides its in-block
// level sums (the host's launch plan adds those): the McICA count, the
// staging area, and 16 bytes of alignment.
extern "C" long long rrtmgp_lw_clear_mega_staged(int nbnd, int n_minor, int cloud, int aero, int mask_mode, int f64) {
  using namespace rrtmgp;
  size_t bytes;
  if (f64) {
    bytes = lw_smem<double, false, false, MASK_NONE>(0, nbnd, n_minor);
  } else if (!cloud) {
    bytes = aero ? lw_smem<float, false, true, MASK_NONE>(0, nbnd, n_minor)
                 : lw_smem<float, false, false, MASK_NONE>(0, nbnd, n_minor);
  } else if (mask_mode == MASK_SEED) {
    bytes = aero ? lw_smem<float, true, true, MASK_SEED>(0, nbnd, n_minor)
                 : lw_smem<float, true, false, MASK_SEED>(0, nbnd, n_minor);
  } else {
    bytes = aero ? lw_smem<float, true, true, MASK_GIVEN>(0, nbnd, n_minor)
                 : lw_smem<float, true, false, MASK_GIVEN>(0, nbnd, n_minor);
  }
  return (long long)(bytes + 16);
}

namespace rrtmgp {

// The most threads a block of lw_clear_mega's instance `variant` may
// have, both level-sum variants (the launch plan's limit; errors.cu
// rrtmgp_max_threads): variant = cloud | aero << 1 | mask_mode << 2 |
// f64 << 4.
cudaError_t lw_clear_mega_max_threads(int variant, int* threads) {
#define RRTMGP_MT(R, C, A, M) \
  max_threads(threads, lw_clear_mega_kernel<R, C, A, M, false>, lw_clear_mega_kernel<R, C, A, M, true>)
  const bool cloud = variant & 1, aero = variant & 2;
  if (variant >> 4 & 1) return RRTMGP_MT(double, false, false, MASK_NONE);
  if (!cloud)
    return aero ? RRTMGP_MT(float, false, true, MASK_NONE) : RRTMGP_MT(float, false, false, MASK_NONE);
  if ((variant >> 2 & 3) == MASK_SEED)
    return aero ? RRTMGP_MT(float, true, true, MASK_SEED) : RRTMGP_MT(float, true, false, MASK_SEED);
  return aero ? RRTMGP_MT(float, true, true, MASK_GIVEN) : RRTMGP_MT(float, true, false, MASK_GIVEN);
#undef RRTMGP_MT
}

}  // namespace rrtmgp
