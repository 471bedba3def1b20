// Whole SW two-stream solve in one kernel, clear or all-sky, f32 or f64.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _sw_mega_kernel (wrapper
//   sw_clear_mega): gas optics with Rayleigh scattering, the McICA cloud
//   mask, cloud and aerosol composition (band properties delta-scaled by the
//   caller), the PIFM / Meador-Weaver layer coefficients with their energy
//   clamps, the direct beam, the adding recurrence and the g-point sums.
//   The f64 clear-sky solve, which the JAX package leaves to XLA, is this
//   kernel instantiated for double, as lw_clear_mega.cu builds its f64
//   solve: f64 tables, inputs, state, level sums and fluxes.
//
// Bound on this card: at 32768 columns x 60 layers x 224 g-points each
//   (layer, column, g-point) reads 12 table values (8 kmajor + 4 Rayleigh,
//   plus 4 kminor per covering minor interval) from tables that stay in L2,
//   does ~150 flops with three exp, one sqrt and two divides: ~1 ms at the
//   card's f32 rate; its inputs and outputs are ~0.1 GB. What it costs
//   beyond: the adding method's state in device memory, which the passes
//   write, read and rewrite: all-sky 64 bytes a point (28.2 GB, 8.4 ms at
//   3.35 TB/s at this size), clear sky 48 (21.1 GB, 6.3 ms). Measured on an
//   NVIDIA H100 80GB HBM3 at 700 W (PERF.md): clear 12.6-12.9 ms, of which
//   the optics pass alone took ~7 before the recompute; all-sky (McICA seed
//   + aerosols, 75748 columns) 37.8-38.0. In f64 the state moves twice the
//   bytes (42.3 GB clear at this size, 12.6 ms) and each point's ~5 exp, 2
//   sqrt and ~10 divides are software sequences at half the f32 rate.
//
// Design: one block per column, one thread per g-point (up to 1024; more
//   spread a column over several blocks of the host's launch plan, the level
//   partials completed in warp order by finish_level_sums, the same bits, as
//   are a column's sums when they would not fit the block's shared memory).
//   The optics loop runs top-down, which is also the direct beam's
//   direction: the beam rides in a register (beam *= exp(-tau/mu0) per
//   layer). The state lives in device memory, four (nlay, ncol, ngpt)
//   arrays, each thread's slots addressed from a pointer to its (col, g) by
//   layer, in one of the two layouts of sw_twostream.cuh:
//   - all-sky: the coefficients, already multiplied by the beam at the top
//     of their layer (Rdir * beam, Tdir * beam, Rdif, Tdif), which the
//     bottom-up adding pass overwrites with what the top-down flux pass
//     needs (sw_adding_and_fluxes);
//   - clear sky: tau, ssa and the beam at each layer's top, and the adding
//     and flux passes compute the coefficients again as sw_2stream_reduced.cu
//     does (sw_recomputed_passes: the albedo over the beam's slot, the
//     source in the fourth array, each pass reading a layer ahead).
//   Both give the same bits. The recomputed passes move 48 bytes a point
//   against 64 and take the coefficients' arithmetic off the optics pass:
//   clear 17.2-17.7 -> 13.1-13.4 ms; all-sky they would need a fifth array
//   for g and took 46.4-46.7 ms against 37.8-38.0 (PERF.md). The TPU
//   kernel keeps its state in VMEM; here a block's whole state in shared
//   memory (one warp of g-points a block) and the bottom layers of it beside
//   a full block of g-points were both slower than device memory at full
//   width (PERF.md).
//
//   What a column's g-points share is staged in shared memory by chunks of
//   SW_CHUNK layers, as lw_clear_mega.cu stages it (gather.cuh ChunkLayout):
//   the block copies chunk k+1's inputs with asynchronous copies (cp.async)
//   while it computes chunk k, then forms each (layer, band)'s kmajor and
//   Rayleigh corner offsets, kminor rows and eta weights once (set_band
//   with the troposphere side's Rayleigh corners), so a thread's layer step
//   reads them, the weights, col_dry and the Rayleigh column amount, the
//   minor scalings and, all-sky, the cloud and aerosol band properties, the
//   aerosol flag and the cloud fraction from shared memory instead of ~20
//   dependent global loads with 64-bit offsets; each interval's band and
//   kminor base are staged once per block. The aerosol properties are
//   (nlay, nbnd, ncol): a chunk's are 4-byte copies strided by ncol. Chunks
//   of 4 and 16 layers ran within 2% of 8 (PERF.md). The optics keep
//   common.cuh's operation order (tau = max(major + minor + ray, 0), ssa =
//   ray / tau, then allsky.cuh's increments), so every output has the bits
//   of the unstaged kernel. mu0 guarded by eps enters only the beam
//   transmittance; the coefficients see the raw mu0. Night columns are
//   zeroed by the caller. All-sky: top-down is the McICA recurrence's
//   direction, so in seed mode the mask is drawn inline (mcica.cuh, uniform
//   l * ngpt + g, layers in the same order) and the column's cloud cover
//   counted after the loop. The real type, cloud, aerosol, mask mode and the
//   split of a column are template parameters: the clear variant is the
//   clear-sky kernel, with g = 0 folded in; the double build is clear sky
//   only (the composition's inputs are f32).
#include "allsky.cuh"
#include "common.cuh"
#include "gather.cuh"
#include "sw_twostream.cuh"

namespace rrtmgp {

// Layers of one staged chunk.
constexpr int SW_CHUNK = 8;

// Shared memory of one block (gather.cuh ChunkLayout).
template <typename R, bool CLOUD, bool AERO, int MASK>
using SwLayout = ChunkLayout<R, SW_CHUNK, true, CLOUD, AERO, MASK>;

template <typename R, bool CLOUD, bool AERO, int MASK, bool SPLIT>
__global__ void sw_clear_mega_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d, int n_minor, AllSkyIn as,
                                     const R* __restrict__ mu0_col,   // (ncol,)
                                     const R* __restrict__ toa_gpt,   // (ncol, ngpt)
                                     const R* __restrict__ alb_dir,   // (nbnd, ncol)
                                     const R* __restrict__ alb_dif,   // (nbnd, ncol)
                                     const R* __restrict__ inc_dif,   // (ncol, ngpt) or null
                                     R* __restrict__ s0,              // 4 x (nlay, ncol, ngpt): the state
                                     R* __restrict__ s1,
                                     R* __restrict__ s2,
                                     R* __restrict__ s3,
                                     R* __restrict__ partials,        // SPLIT: (3, nlev, ncol, column's warps)
                                     int* __restrict__ cover_part,    // SPLIT, MASK_SEED: (ncol, groups)
                                     R* __restrict__ flux_up,         // 3 x (nlev, ncol)
                                     R* __restrict__ flux_dn,
                                     R* __restrict__ flux_dir,
                                     float* __restrict__ cover) {     // (ncol,), MASK_SEED
  // the composition's inputs (AllSkyIn, the increments) are f32
  static_assert(std::is_same<R, float>::value || (!CLOUD && !AERO && MASK == MASK_NONE),
                "the f64 build is clear sky only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay, nlev = d.nlay + 1, ncol = d.ncol, nbnd = d.nbnd;
  const size_t sums_bytes = SPLIT ? 0 : sizeof(R) * 3 * nlev * (blockDim.x >> 5);
  const SwLayout<R, CLOUD, AERO, MASK> lay(sums_bytes, nbnd, n_minor);
  int* count32 = reinterpret_cast<int*>(smem_raw + sums_bytes);
  StagedCol<R>* s_col = reinterpret_cast<StagedCol<R>*>(smem_raw + lay.cols);
  StagedBand<R>* s_band = reinterpret_cast<StagedBand<R>*>(smem_raw + lay.bands);
  int* mband = reinterpret_cast<int*>(smem_raw + lay.mband);
  int* mkbase = mband + n_minor;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const size_t lay_plane = (size_t)nlay * ncol;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_chunks = (nlay + SW_CHUNK - 1) / SW_CHUNK;

  // chunk k holds layers top(k), top(k) - 1, ..., slot j = top(k) - l
  auto chunk_top = [&](int k) { return nlay - 1 - k * SW_CHUNK; };
  auto chunk_len = [&](int k) { return min(SW_CHUNK, chunk_top(k) + 1); };
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
      cp_async<sizeof(R)>(rr + lay.ray + e, in.ray_factor + lc);
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
      if constexpr (CLOUD) {
        cp_async<4>(rr + lay.ctau + e, as.ctau + lcb);
        cp_async<4>(rr + lay.cssa + e, as.cssa + lcb);
        cp_async<4>(rr + lay.cg + e, as.cg + lcb);
      }
      if constexpr (AERO) {
        // (nlay, nbnd, ncol): a column's values are ncol apart
        const size_t ab = ((size_t)l * nbnd + b) * ncol + col;
        cp_async<4>(rr + lay.atau + e, as.atau + ab);
        cp_async<4>(rr + lay.assa + e, as.assa + ab);
        cp_async<4>(rr + lay.ag + e, as.ag + ab);
      }
    }
    for (int e = tid; e < n_minor * n; e += nthr) {
      const int i = e / n, j = e - i * n;
      cp_async<sizeof(R)>(rr + lay.scal + i * SW_CHUNK + j,
                          in.minor_scaling + i * lay_plane + (size_t)(top - j) * ncol + col);
    }
  };
  // chunk k's raw inputs -> its staged offsets and weights
  auto transform = [&](int k) {
    const R* rr = raw_of(k);
    const int* rw = raw_words(k);
    const int top = chunk_top(k), n = chunk_len(k), nb = n * nbnd;
    for (int j = tid; j < n; j += nthr) {
      const size_t lc = (size_t)(top - j) * ncol + col;
      set_col(rr[lay.ft + j], rr[lay.fp + j], rr[lay.cd + j],
              word_byte((unsigned)rw[lay.lower + j], in.tropo_lower + lc) != 0, s_col[j]);
      s_col[j].ray = rr[lay.ray + j];
      if constexpr (AERO) s_col[j].aero = word_byte((unsigned)rw[lay.amask + j], as.amask + lc) != 0;
    }
    for (int e = tid; e < nb; e += nthr) {
      const int j = e / nbnd;
      const bool lower = word_byte((unsigned)rw[lay.lower + j], in.tropo_lower + (size_t)(top - j) * ncol + col) != 0;
      set_band<R, true>(d, rw[lay.jt + j], rw[lay.jp + j], lower, rw[lay.je1 + e], rw[lay.je2 + e],
                        rr[lay.fe1 + e], rr[lay.fe2 + e], rr[lay.cm1 + e], rr[lay.cm2 + e], s_band[e]);
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
  const R* rayl = tb.second + g;
  const R* kminor = tb.kminor + g;
  // the state layout: clear sky stores tau, ssa and the beam at each
  // layer's top (RECOMPUTE: the later passes compute the coefficients
  // again); all-sky stores Rdir * beam, Tdir * beam, Rdif and Tdif
  constexpr bool RECOMPUTE = !CLOUD && !AERO;
  // this thread's (col, g) in the four state arrays; layer l at [l * lstride]
  const size_t lstride = (size_t)ncol * d.ngpt, g0 = (size_t)col * d.ngpt + g;
  R *p0 = s0 + g0, *p1 = s1 + g0, *p2 = s2 + g0, *p3 = s3 + g0;
  const R mu0 = __ldg(mu0_col + col);
  const R mu0_safe = r_max(mu0, r_eps<R>());

  // phase 1, top-down: optics (+ coefficients) to the state, beam in a
  // register
  const R beam_toa = active ? __ldg(toa_gpt + g0) * mu0 : R(0);
  R beam = beam_toa;
  sums.add(SW_DIR, nlay, beam);
  Key2x32 ck{0u, 0u};
  if constexpr (MASK == MASK_SEED) ck = mcica_column_key(as.seed, as.col_offset + col);
  McicaCarry carry;
  bool any_cloud = false;
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
        const R tau_ray = staged_tau_rayleigh(rayl, se, c, b);
        R tau = r_max(staged_tau_major(kmajor, sp, se, c, b) +
                          staged_tau_minor(kminor, tb.minor_list, d.ncontrib, meta, c, bands, rr + lay.scal + j,
                                           SW_CHUNK, mband, mkbase) +
                          tau_ray,
                      R(0));
        R ssa = tau > R(0) ? tau_ray / tau : R(0);
        R gg = R(0);
        const int e = j * nbnd + band;
        if constexpr (CLOUD) {
          bool m;
          if constexpr (MASK == MASK_SEED) {
            m = carry.step(mcica_uniform(ck, (uint32_t)l * (uint32_t)d.ngpt + (uint32_t)g),
                           __int_as_float(rw[lay.cfrac + j]));
            any_cloud = any_cloud || m;
          } else {
            m = __ldg(as.cmask + ((size_t)l * ncol + col) * d.ngpt + g) != 0;
          }
          if (m) increment_2stream(tau, ssa, gg, rr[lay.ctau + e], rr[lay.cssa + e], rr[lay.cg + e]);
        }
        if constexpr (AERO) {
          if (c.aero) increment_2stream(tau, ssa, gg, rr[lay.atau + e], rr[lay.assa + e], rr[lay.ag + e]);
        }
        const R T0 = r_exp(-tau / mu0_safe);
        const size_t s = (size_t)l * lstride;
        if constexpr (RECOMPUTE) {
          p0[s] = tau;
          p1[s] = ssa;
          p2[s] = beam;
        } else {
          R Rdir, Tdir, Rdif, Tdif;
          sw_coeffs(tau, ssa, gg, mu0, T0, Rdir, Tdir, Rdif, Tdif);
          p0[s] = Rdir * beam;
          p1[s] = Tdir * beam;
          p2[s] = Rdif;
          p3[s] = Tdif;
        }
        beam *= T0;
      }
      sums.add(SW_DIR, l, beam);
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

  // phases 2 and 3: bottom-up adding, top-down diffuse flux, level sums
  if constexpr (RECOMPUTE) {
    sw_recomputed_passes(d, sums, col, active, band, mu0, mu0_safe, beam_toa, beam, alb_dir, alb_dif, inc_dif, g0,
                         lstride, p0, p1, p2, p3, flux_up, flux_dn, flux_dir);
  } else {
    sw_adding_and_fluxes(d, sums, col, g, active, band, beam, alb_dir, alb_dif, inc_dif, p0, p1, p2, p3, flux_up,
                         flux_dn, flux_dir);
  }
}

// The arguments of one launch, shared by the f32 and f64 entry points.
template <typename R>
struct SwArgs {
  OpticsInT<R> in;
  TablesT<R> tb;
  Dims d;
  int n_minor;
  AllSkyIn as;
  const R *mu0, *toa_gpt, *alb_dir, *alb_dif, *inc_dif;
  R* state[4];
  R *flux_up, *flux_dn, *flux_dir;
  float* cover;
  int group, n_groups;  // the host's launch plan (ops/_launch.py gpoint_plan)
  bool in_block;        // the plan's: the level sums in the block
  R* partials;          // (3, nlev, ncol, column's warps) unless in_block
  int* cover_part;      // (ncol, n_groups), seed mode unless in_block
};

// Shared memory of a block whose level sums take sums_bytes.
template <typename R, bool CLOUD, bool AERO, int MASK>
size_t sw_smem(size_t sums_bytes, int nbnd, int n_minor) {
  return SwLayout<R, CLOUD, AERO, MASK>(sums_bytes, nbnd, n_minor).stage_end;
}

template <typename R, bool CLOUD, bool AERO, int MASK>
cudaError_t launch_sw(const SwArgs<R>& a, cudaStream_t stream) {
  const bool in_block = a.in_block;
  const size_t sums_bytes = in_block ? sizeof(R) * 3 * (a.d.nlay + 1) * (a.group / 32) : 0;
  const size_t smem = sw_smem<R, CLOUD, AERO, MASK>(sums_bytes, a.d.nbnd, a.n_minor);
  if (a.d.ncol == 0) return cudaGetLastError();
  auto kernel = in_block ? sw_clear_mega_kernel<R, CLOUD, AERO, MASK, false>
                         : sw_clear_mega_kernel<R, CLOUD, AERO, MASK, true>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)a.d.ncol, (unsigned)a.n_groups), a.group, smem, stream>>>(
      a.in, a.tb, a.d, a.n_minor, a.as, a.mu0, a.toa_gpt, a.alb_dir, a.alb_dif, a.inc_dif, a.state[0], a.state[1],
      a.state[2], a.state[3], in_block ? nullptr : a.partials, a.cover_part, a.flux_up, a.flux_dn, a.flux_dir,
      a.cover);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return err;
  const bool seeded = MASK == MASK_SEED;
  return finish_sums<R>(stream, a.partials, 3, a.d.nlay + 1, a.d.ncol, a.n_groups * a.group / 32, SUMS_SW, R(1),
                        a.flux_up, a.flux_dn, a.flux_dir, seeded ? a.cover_part : nullptr, a.n_groups, a.d.ngpt,
                        seeded ? a.cover : nullptr);
}

template <typename R>
OpticsInT<R> sw_optics_in(const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
                          const void* tropo_lower, const void* col_dry, const void* jeta1, const void* feta1,
                          const void* cmix1, const void* jeta2, const void* feta2, const void* cmix2,
                          const void* minor_scaling, const void* ray_factor) {
  return OpticsInT<R>{(const int*)jtemp, (const R*)ftemp, (const int*)jpress, (const R*)fpress,
                      (const unsigned char*)tropo_lower, (const R*)col_dry,
                      (const int*)jeta1, (const R*)feta1, (const R*)cmix1,
                      (const int*)jeta2, (const R*)feta2, (const R*)cmix2,
                      (const R*)minor_scaling, (const R*)ray_factor};
}

template <typename R>
TablesT<R> sw_tables(const void* kmajor, const void* rayl, const void* kminor, const void* gpt2band,
                     const void* minor_start, const void* minor_list, const void* minor_kbase,
                     const void* minor_band) {
  return TablesT<R>{(const R*)kmajor, (const R*)rayl, (const R*)kminor, (const int*)gpt2band,
                    (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                    (const int*)minor_band};
}

}  // namespace rrtmgp

// f32: clear, or composed with clouds (a given mask, or McICA from the seed)
// and aerosols. s0..s3: the state, four (nlay, ncol, ngpt) f32 arrays.
// group, n_groups, in_block: the host's launch plan (ops/_launch.py
// gpoint_plan, with the staged bytes of rrtmgp_sw_clear_mega_staged);
// partials (3, nlev, ncol, column's warps) and, in seed mode, cover_part
// (ncol, n_groups) int32 unless in_block, else null.
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
    void* s0, void* s1, void* s2, void* s3, void* partials, void* cover_part,
    void* flux_up, void* flux_dn, void* flux_dir, void* cover,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor,
    int cloud, int aero, int mask_mode, unsigned seed_hi, unsigned seed_lo, long long col_offset,
    int group, int n_groups, int in_block, void* stream) {
  using namespace rrtmgp;
  const SwArgs<float> a{
      sw_optics_in<float>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2, feta2,
                          cmix2, minor_scaling, ray_factor),
      sw_tables<float>(kmajor, rayl, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib}, n_minor,
      AllSkyIn{(const float*)ctau, (const float*)cssa, (const float*)cg, (const unsigned char*)cmask,
               (const float*)cld_frac, Key2x32{seed_hi, seed_lo}, col_offset,
               (const float*)atau, (const float*)assa, (const float*)ag, (const unsigned char*)amask},
      (const float*)mu0, (const float*)toa_gpt, (const float*)alb_dir, (const float*)alb_dif, (const float*)inc_dif,
      {(float*)s0, (float*)s1, (float*)s2, (float*)s3},
      (float*)flux_up, (float*)flux_dn, (float*)flux_dir, (float*)cover,
      group, n_groups, in_block != 0, (float*)partials, (int*)cover_part};
  const cudaStream_t s = (cudaStream_t)stream;
#define RRTMGP_SW(C, A, M) launch_sw<float, C, A, M>(a, s)
  cudaError_t err;
  if (!cloud) {
    err = aero ? RRTMGP_SW(false, true, MASK_NONE) : RRTMGP_SW(false, false, MASK_NONE);
  } else if (mask_mode == MASK_SEED) {
    err = aero ? RRTMGP_SW(true, true, MASK_SEED) : RRTMGP_SW(true, false, MASK_SEED);
  } else {
    err = aero ? RRTMGP_SW(true, true, MASK_GIVEN) : RRTMGP_SW(true, false, MASK_GIVEN);
  }
#undef RRTMGP_SW
  return (int)err;
}

// f64: clear sky, every real argument, the state and the fluxes in f64;
// partials (3, nlev, ncol, column's warps) f64 unless in_block, else null.
extern "C" int rrtmgp_sw_clear_mega_f64(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* ray_factor,
    const void* kmajor, const void* rayl, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    const void* mu0, const void* toa_gpt, const void* alb_dir, const void* alb_dif, const void* inc_dif,
    void* s0, void* s1, void* s2, void* s3, void* partials, void* flux_up, void* flux_dn, void* flux_dir,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor,
    int group, int n_groups, int in_block, void* stream) {
  using namespace rrtmgp;
  const SwArgs<double> a{
      sw_optics_in<double>(jtemp, ftemp, jpress, fpress, tropo_lower, col_dry, jeta1, feta1, cmix1, jeta2,
                           feta2, cmix2, minor_scaling, ray_factor),
      sw_tables<double>(kmajor, rayl, kminor, gpt2band, minor_start, minor_list, minor_kbase, minor_band),
      Dims{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib}, n_minor,
      AllSkyIn{},
      (const double*)mu0, (const double*)toa_gpt, (const double*)alb_dir, (const double*)alb_dif,
      (const double*)inc_dif,
      {(double*)s0, (double*)s1, (double*)s2, (double*)s3},
      (double*)flux_up, (double*)flux_dn, (double*)flux_dir, nullptr,
      group, n_groups, in_block != 0, (double*)partials, nullptr};
  return (int)launch_sw<double, false, false, MASK_NONE>(a, (cudaStream_t)stream);
}

// The shared memory a block of sw_clear_mega needs besides its in-block
// level sums (the host's launch plan adds those): the McICA count, the
// staging area, and 16 bytes of alignment.
extern "C" long long rrtmgp_sw_clear_mega_staged(int nbnd, int n_minor, int cloud, int aero, int mask_mode, int f64) {
  using namespace rrtmgp;
  size_t bytes;
  if (f64) {
    bytes = sw_smem<double, false, false, MASK_NONE>(0, nbnd, n_minor);
  } else if (!cloud) {
    bytes = aero ? sw_smem<float, false, true, MASK_NONE>(0, nbnd, n_minor)
                 : sw_smem<float, false, false, MASK_NONE>(0, nbnd, n_minor);
  } else if (mask_mode == MASK_SEED) {
    bytes = aero ? sw_smem<float, true, true, MASK_SEED>(0, nbnd, n_minor)
                 : sw_smem<float, true, false, MASK_SEED>(0, nbnd, n_minor);
  } else {
    bytes = aero ? sw_smem<float, true, true, MASK_GIVEN>(0, nbnd, n_minor)
                 : sw_smem<float, true, false, MASK_GIVEN>(0, nbnd, n_minor);
  }
  return (long long)(bytes + 16);
}

namespace rrtmgp {

// The most threads a block of sw_clear_mega's instance `variant` may have, both
// level-sum variants (the launch plan's limit; errors.cu
// rrtmgp_max_threads): variant = cloud | aero << 1 | mask_mode << 2 |
// f64 << 4.
cudaError_t sw_clear_mega_max_threads(int variant, int* threads) {
#define RRTMGP_MT(R, C, A, M) \
  max_threads(threads, sw_clear_mega_kernel<R, C, A, M, false>, sw_clear_mega_kernel<R, C, A, M, true>)
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
