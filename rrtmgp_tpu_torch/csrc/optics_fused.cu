// Materialized gas optics: tau and the Planck fraction (LW) or the Rayleigh
// single-scattering albedo (SW) per (layer, column, g-point), written to
// device memory for the sweeps of the two-kernel path and for any caller that
// needs the optics as tensors.
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _optics_fused_kernel (wrapper
//   optics_fused): major-species tau by (pressure, temperature, eta)
//   interpolation scaled by col_dry, minor-gas tau per covering interval,
//   then LW: tau clamped at 0 and the Planck fraction; SW: tau with Rayleigh
//   clamped at 0 and ssa = Rayleigh / tau where tau > 0, else 0.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points the two outputs are 2 x 2.01 GB (SW, 224 g-points: 2 x 1.76 GB)
//   against ~0.2 GB of inputs: ~1.3 ms at 3.35 TB/s. Each point reads 16 (LW)
//   or 12 (SW) table values plus 4 kminor values per covering minor interval
//   from tables that stay in L2, and does ~60 operations: expected limit, as
//   for the megakernels' optics loops, the latency of dependent table
//   loads through L1/L2 (cell indices, then table values, then the
//   minor-interval chain), with the stores behind it.
//
// Design: one thread per (layer, column, g-point), the g-point fastest, so a
//   warp reads neighbouring entries of the g-point-fastest tables, broadcasts
//   the per-(layer, column) inputs, and writes 128 contiguous bytes per
//   output. 64-bit offsets throughout (5.0e8 points per output). The device
//   code is the optics of the megakernels' layer loops (common.cuh:
//   load_cell, tau_major, tau_minor, planck_fraction, tau_rayleigh), in the
//   same operation order, so the two-kernel path and the megakernels see the
//   same optics to the last bit. The real type and the spectral range are
//   template parameters. Nothing of the TPU kernel's structure is kept: no
//   one-hot contraction, no bf16 hi/lo tables, no windows, no scalar pack, no
//   128-lane g-point padding.
#include "common.cuh"

namespace rrtmgp {

template <typename R, bool SW>
__global__ void optics_fused_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d,
                                    R* __restrict__ tau_out,      // (nlay, ncol, ngpt)
                                    R* __restrict__ second_out) { // (nlay, ncol, ngpt)
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t lc = idx / d.ngpt;
  const int g = (int)(idx - lc * d.ngpt);
  const int l = (int)(lc / d.ncol);
  const int col = (int)(lc - (size_t)l * d.ncol);
  const CellT<R> c = load_cell(in, d, l, col, __ldg(tb.gpt2band + g));
  const R gas = tau_major(tb, d, c, g) + tau_minor(in, tb, d, c, g);
  if constexpr (SW) {
    const R ray = tau_rayleigh(in, tb, d, c, g);
    const R tau = r_max(gas + ray, R(0));
    tau_out[idx] = tau;
    second_out[idx] = tau > R(0) ? ray / tau : R(0);
  } else {
    tau_out[idx] = r_max(gas, R(0));
    second_out[idx] = planck_fraction(tb, d, c, g);
  }
}

template <typename R, bool SW>
cudaError_t launch_optics_fused(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d, R* tau, R* second,
                                cudaStream_t stream) {
  // 128 threads a block: at 62-72 registers a thread that is 7 blocks per SM
  // where 256-thread blocks fit 3, and the kernel waits on load latency
  // (measured on an H100 at 32768 x 60: LW 9.9 ms against 14.6, SW 8.6
  // against 10.1; 64-thread blocks the same, launch bounds that force fewer
  // registers spill and lose)
  const int threads = 128;
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffull) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    optics_fused_kernel<R, SW><<<(unsigned)blocks, threads, 0, stream>>>(in, tb, d, tau, second);
  }
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. `second` is the Planck-fraction table (LW) or the Rayleigh table (SW);
// ray_factor is read only when shortwave != 0.
extern "C" int rrtmgp_optics_fused(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* ray_factor,
    const void* kmajor, const void* second, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    void* tau_out, void* second_out,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int shortwave,
    void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, (const float*)ray_factor};
  const Tables tb{(const float*)kmajor, (const float*)second, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = shortwave
                              ? launch_optics_fused<float, true>(in, tb, d, (float*)tau_out, (float*)second_out, s)
                              : launch_optics_fused<float, false>(in, tb, d, (float*)tau_out, (float*)second_out, s);
  return (int)err;
}
