// SW two-stream sweep of the two-kernel path: from materialized optics to
// fluxes summed over g-points.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _sw_sweep_reduced_kernel and
//   _sw_sweep_reduced_stream_kernel (wrapper sw_2stream_pallas_reduced; the
//   two TPU kernels compute one function, blocked or streamed to fit VMEM):
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
// Design: the SW megakernel (sw_clear_mega.cu) with the optics read instead
//   of computed: one block per column, one thread per g-point, the beam in a
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
//   and has_g are template parameters (the entry point builds f32). Nothing
//   of the TPU kernels' structure is kept: no column blocks, no lane
//   padding, no streaming ring buffer.
#include "common.cuh"
#include "sw_twostream.cuh"

namespace rrtmgp {

template <typename R, bool HAS_G>
__global__ void sw_2stream_reduced_kernel(const R* __restrict__ tau,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ ssa,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ gasym,      // (nlay, ncol, ngpt), HAS_G
                                          const R* __restrict__ mu0_col,    // (ncol,)
                                          const R* __restrict__ toa_gpt,    // (ncol, ngpt)
                                          const R* __restrict__ alb_dir,    // (nbnd, ncol)
                                          const R* __restrict__ alb_dif,    // (nbnd, ncol)
                                          const int* __restrict__ gpt2band,  // (ngpt,)
                                          const R* __restrict__ inc_dif,    // (ncol, ngpt) or null
                                          R* __restrict__ s_rdir,           // 4 x (nlay, ncol, ngpt)
                                          R* __restrict__ s_tdir,
                                          R* __restrict__ s_rdif,
                                          R* __restrict__ s_tdif,
                                          R* __restrict__ flux_up,          // 3 x (nlev, ncol)
                                          R* __restrict__ flux_dn,
                                          R* __restrict__ flux_dir,
                                          Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = threadIdx.x;
  const bool active = g < d.ngpt;
  const int nlay = d.nlay;
  const LevelSumsT<R> sums{reinterpret_cast<R*>(smem_raw), nlay + 1, (int)(blockDim.x >> 5)};
  const int band = active ? __ldg(gpt2band + g) : 0;
  const R mu0 = __ldg(mu0_col + col);
  const R mu0_safe = r_max(mu0, r_eps<R>());

  // top-down: coefficients to scratch, beam in a register
  R beam = active ? __ldg(toa_gpt + (size_t)col * d.ngpt + g) * mu0 : R(0);
  sums.add(SW_DIR, nlay, beam);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const size_t s = ((size_t)l * d.ncol + col) * d.ngpt + g;
      const R t = __ldg(tau + s);
      const R T0 = r_exp(-t / mu0_safe);
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, __ldg(ssa + s), HAS_G ? __ldg(gasym + s) : R(0), mu0, T0, Rdir, Tdir, Rdif, Tdif);
      s_rdir[s] = Rdir * beam;
      s_tdir[s] = Tdir * beam;
      s_rdif[s] = Rdif;
      s_tdif[s] = Tdif;
      beam *= T0;
    }
    sums.add(SW_DIR, l, beam);
  }

  sw_adding_and_fluxes(d, sums, col, g, active, band, beam, alb_dir, alb_dif, inc_dif,
                       s_rdir, s_tdir, s_rdif, s_tdif, flux_up, flux_dn, flux_dir);
}

template <typename R, bool HAS_G>
cudaError_t launch_sw_reduced(const Dims& d, cudaStream_t stream, const R* tau, const R* ssa, const R* gasym,
                              const R* mu0, const R* toa_gpt, const R* alb_dir, const R* alb_dif,
                              const int* gpt2band, const R* inc_dif, R* s_rdir, R* s_tdir, R* s_rdif,
                              R* s_tdif, R* up, R* dn, R* dir) {
  const MegaLaunch m = mega_launch<R>(d, 3);
  auto kernel = sw_2stream_reduced_kernel<R, HAS_G>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(tau, ssa, gasym, mu0, toa_gpt, alb_dir, alb_dif, gpt2band,
                                              inc_dif, s_rdir, s_tdir, s_rdif, s_tdif, up, dn, dir, d);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32; gasym null = asymmetry 0, inc_dif null = no incident diffuse flux.
extern "C" int rrtmgp_sw_2stream_reduced(const void* tau, const void* ssa, const void* gasym, const void* mu0,
                                         const void* toa_gpt, const void* alb_dir, const void* alb_dif,
                                         const void* gpt2band, const void* inc_dif, void* s_rdir, void* s_tdir,
                                         void* s_rdif, void* s_tdif, void* flux_up, void* flux_dn,
                                         void* flux_dir, int nlay, int ncol, int ngpt, int nbnd, void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
#define RRTMGP_SWR(G)                                                                                          \
  launch_sw_reduced<float, G>(d, s, (const float*)tau, (const float*)ssa, (const float*)gasym,                 \
                              (const float*)mu0, (const float*)toa_gpt, (const float*)alb_dir,                 \
                              (const float*)alb_dif, (const int*)gpt2band, (const float*)inc_dif,              \
                              (float*)s_rdir, (float*)s_tdir, (float*)s_rdif, (float*)s_tdif,                  \
                              (float*)flux_up, (float*)flux_dn, (float*)flux_dir)
  const cudaError_t err = gasym != nullptr ? RRTMGP_SWR(true) : RRTMGP_SWR(false);
#undef RRTMGP_SWR
  return (int)err;
}
