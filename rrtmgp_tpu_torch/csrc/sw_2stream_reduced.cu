// SW two-stream sweeps from materialized optics: fluxes summed over g-points
// or kept per g-point.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _sw_sweep_reduced_kernel and
//   _sw_sweep_reduced_stream_kernel (wrapper sw_2stream_pallas_reduced; the
//   two TPU kernels compute one function, blocked or streamed to fit VMEM;
//   here PER_GPT = false) and _sw_sweep_kernel (wrapper sw_2stream_pallas;
//   PER_GPT = true, see the end of Design):
//   the direct beam from the top, the PIFM / Meador-Weaver layer coefficients
//   with their energy clamps, the adding recurrence from the surface, the
//   diffuse flux from the top, and the g-point sums of up, down and direct
//   flux at every level. The asymmetry g is optional: a null pointer is the
//   clear-sky case g = 0 (the TPU kernel's has_g=False), which saves reading
//   one (nlay, ncol, ngpt) tensor.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 224
//   g-points tau and ssa are 2 x 1.76 GB (g a third), the outputs 24 MB:
//   1.1 ms at 3.35 TB/s (1.6 ms with g). The design's four scratch arrays
//   add 4 x 1.76 GB written, read and rewritten by the adding pass and read
//   again by the flux pass: ~28 GB in all, ~8 ms. Three exp, one sqrt and
//   two divides per point.
//
// Design: the SW megakernel's passes (sw_twostream.cuh) with the optics read
//   instead of computed: one block per column, one thread per g-point (more
//   than 1024: a column's g-points over several blocks of the host's launch
//   plan, the level sums completed by finish_level_sums), the beam in a
//   register top-down, the coefficients to four scratch arrays in device
//   memory, then the shared adding and flux passes of sw_twostream.cuh, which
//   rewrite the scratch in place (no (nlev, ncol, ngpt) albedo and source
//   arrays) and write the level sums. Scratch in device memory rather than
//   shared memory: three values per level and thread would be 164 KB for a
//   224-thread block, one block per SM, and the sweep is latency-bound like
//   the megakernel, which needs the occupancy. The coefficient function is
//   the megakernel's, so the two paths agree to rounding; mu0 guarded by eps
//   enters only the beam transmittance. Night columns (mu0 <= 0) give finite
//   or non-finite values that the caller replaces by zeros. The real type
//   and has_g are template parameters (the entry points build f32). Nothing
//   of the TPU kernels' structure is kept: no column blocks, no lane
//   padding, no streaming ring buffer.
//   PER_GPT, a third template parameter, is the same kernel without the
//   g-point sums: mu0 and the albedos come per g-point, (ncol, ngpt), as the
//   TPU function takes them, each thread stores its beam per level in the
//   top-down pass and its up and down flux in the flux pass, (nlev, ncol,
//   ngpt) each, and no shared memory is used. At 32768 x 60 x 224 its outputs are 3 x 1.79
//   GB beside 3 x 1.76 GB of inputs: 10.7 GB, 3.2 ms at 3.35 TB/s.
#include "common.cuh"
#include "sw_twostream.cuh"

namespace rrtmgp {

template <typename R, bool HAS_G, bool PER_GPT, bool SPLIT>
__global__ void sw_2stream_reduced_kernel(const R* __restrict__ tau,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ ssa,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ gasym,      // (nlay, ncol, ngpt), HAS_G
                                          const R* __restrict__ mu0_col,    // (ncol,); PER_GPT (ncol, ngpt)
                                          const R* __restrict__ toa_gpt,    // (ncol, ngpt)
                                          const R* __restrict__ alb_dir,    // (nbnd, ncol); PER_GPT (ncol, ngpt)
                                          const R* __restrict__ alb_dif,    // (nbnd, ncol); PER_GPT (ncol, ngpt)
                                          const int* __restrict__ gpt2band,  // (ngpt,); PER_GPT unused
                                          const R* __restrict__ inc_dif,    // (ncol, ngpt) or null
                                          R* __restrict__ s_rdir,           // 4 x (nlay, ncol, ngpt)
                                          R* __restrict__ s_tdir,
                                          R* __restrict__ s_rdif,
                                          R* __restrict__ s_tdif,
                                          R* __restrict__ flux_up,          // 3 x (nlev, ncol); PER_GPT (nlev, ncol, ngpt)
                                          R* __restrict__ flux_dn,
                                          R* __restrict__ flux_dir,
                                          R* __restrict__ partials,         // null: sums in the block
                                          Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlay + 1);
  const size_t g0 = (size_t)col * d.ngpt + g;
  // this thread's state: layer l at [l * stride]
  const size_t stride = (size_t)d.ncol * d.ngpt;
  R *rdir = s_rdir + g0, *tdir = s_tdir + g0, *rdif = s_rdif + g0, *tdif = s_tdif + g0;
  int band = 0;
  R mu0;
  if constexpr (PER_GPT) {
    mu0 = active ? __ldg(mu0_col + (size_t)col * d.ngpt + g) : R(1);
  } else {
    band = active ? __ldg(gpt2band + g) : 0;
    mu0 = __ldg(mu0_col + col);
  }
  const R mu0_safe = r_max(mu0, r_eps<R>());

  // top-down: coefficients to scratch, beam in a register; the beam of each
  // level goes to the level sum or, per g-point, to flux_dir
  R beam = active ? __ldg(toa_gpt + (size_t)col * d.ngpt + g) * mu0 : R(0);
  if constexpr (PER_GPT) {
    if (active) flux_dir[((size_t)nlay * d.ncol + col) * d.ngpt + g] = beam;
  } else {
    sums.add(SW_DIR, nlay, beam);
  }
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const size_t s = ((size_t)l * d.ncol + col) * d.ngpt + g;
      const R t = __ldg(tau + s);
      const R T0 = r_exp(-t / mu0_safe);
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, __ldg(ssa + s), HAS_G ? __ldg(gasym + s) : R(0), mu0, T0, Rdir, Tdir, Rdif, Tdif);
      rdir[l * stride] = Rdir * beam;
      tdir[l * stride] = Tdir * beam;
      rdif[l * stride] = Rdif;
      tdif[l * stride] = Tdif;
      beam *= T0;
      if constexpr (PER_GPT) flux_dir[s] = beam;  // level l: the same offset as layer l
    }
    if constexpr (!PER_GPT) sums.add(SW_DIR, l, beam);
  }

  sw_adding_and_fluxes<PER_GPT>(d, sums, col, g, active, band, beam, alb_dir, alb_dif, inc_dif, rdir, tdir, rdif,
                                tdif, flux_up, flux_dn, flux_dir);
}

// group, n_groups, in_block: the host's launch plan; partials (3, nlev, ncol,
// column's warps) unless in_block (summed variant), else null.
template <typename R, bool HAS_G, bool PER_GPT>
cudaError_t launch_sw_reduced(const Dims& d, int group, int n_groups, bool in_block, cudaStream_t stream, const R* tau,
                              const R* ssa, const R* gasym, const R* mu0, const R* toa_gpt, const R* alb_dir,
                              const R* alb_dif, const int* gpt2band, const R* inc_dif, R* s_rdir, R* s_tdir,
                              R* s_rdif, R* s_tdif, R* up, R* dn, R* dir, R* partials) {
  const MegaLaunch m = group_launch<R>(d, PER_GPT ? 0 : 3, group, n_groups, in_block);
  auto kernel = in_block ? sw_2stream_reduced_kernel<R, HAS_G, PER_GPT, false>
                         : sw_2stream_reduced_kernel<R, HAS_G, PER_GPT, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(tau, ssa, gasym, mu0, toa_gpt, alb_dir, alb_dif, gpt2band,
                                              inc_dif, s_rdir, s_tdir, s_rdif, s_tdif, up, dn, dir,
                                              in_block ? nullptr : partials, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || PER_GPT || in_block) return err;
  return finish_sums<R>(stream, partials, 3, d.nlay + 1, d.ncol, n_groups * group / 32, SUMS_SW, R(1), up, dn, dir);
}

}  // namespace rrtmgp

// f32; gasym null = asymmetry 0, inc_dif null = no incident diffuse flux.
#define RRTMGP_SWR(G, P)                                                                                       \
  launch_sw_reduced<float, G, P>(d, group, n_groups, in_block, (cudaStream_t)stream, (const float*)tau, (const float*)ssa, \
                                 (const float*)gasym, (const float*)mu0, (const float*)toa_gpt,                \
                                 (const float*)alb_dir, (const float*)alb_dif, (const int*)gpt2band,           \
                                 (const float*)inc_dif, (float*)s_rdir, (float*)s_tdir, (float*)s_rdif,        \
                                 (float*)s_tdif, (float*)flux_up, (float*)flux_dn, (float*)flux_dir,       \
                                 (float*)partials)

// Summed over g-points: mu0 (ncol,), albedos (nbnd, ncol) with gpt2band,
// fluxes (nlev, ncol). group, n_groups, in_block: the launch plan; partials
// (3, nlev, ncol, column's warps) unless in_block, else null.
extern "C" int rrtmgp_sw_2stream_reduced(const void* tau, const void* ssa, const void* gasym, const void* mu0,
                                         const void* toa_gpt, const void* alb_dir, const void* alb_dif,
                                         const void* gpt2band, const void* inc_dif, void* s_rdir, void* s_tdir,
                                         void* s_rdif, void* s_tdif, void* flux_up, void* flux_dn,
                                         void* flux_dir, void* partials, int nlay, int ncol, int ngpt, int nbnd,
                                         int group, int n_groups, int in_block, void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  return (int)(gasym != nullptr ? RRTMGP_SWR(true, false) : RRTMGP_SWR(false, false));
}

// Per g-point: mu0 and albedos (ncol, ngpt), fluxes (nlev, ncol, ngpt).
extern "C" int rrtmgp_sw_2stream_gpt(const void* tau, const void* ssa, const void* gasym, const void* mu0,
                                     const void* toa_gpt, const void* alb_dir, const void* alb_dif,
                                     const void* inc_dif, void* s_rdir, void* s_tdir, void* s_rdif,
                                     void* s_tdif, void* flux_up, void* flux_dn, void* flux_dir, int nlay,
                                     int ncol, int ngpt, int group, int n_groups, void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, 0, 0, 0, 0};
  const bool in_block = n_groups == 1;  // no level sums
  const void* gpt2band = nullptr;
  void* partials = nullptr;
  return (int)(gasym != nullptr ? RRTMGP_SWR(true, true) : RRTMGP_SWR(false, true));
}
#undef RRTMGP_SWR
