// Minor-gas optical depth per (layer, column, g-point): the minor part of the
// unfused gas optics.
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _minor_merged_kernel (wrapper
//   interp_minor_merged): per minor interval covering a g-point, a
//   (temperature, eta) interpolation of its kminor rows at the eta data of
//   the interval's band, times the interval's scaling, summed over the
//   intervals. The TPU kernel merges both troposphere sides per g-point
//   group, with scalings that are zero off their side; this kernel walks only
//   the cell's own side of the interval index (KernelTables.minor_start /
//   minor_list): the other side's scalings are zero, so the function is the
//   same.
//
// Bound on this card: device memory for the output. At 32768 columns x 60
//   layers x 256 g-points it writes 2.01 GB (SW, 224 g-points: 1.76 GB) and
//   reads the per-(layer, column) scalings and eta data (~0.5 GB): ~0.8 ms at
//   3.35 TB/s. Each covering interval costs a chain of dependent loads (index
//   entry, scaling and eta data, then 4 kminor values from L2) and ~14
//   operations: expected limit, the load latency of that chain.
//
// Design: one thread per (layer, column, g-point), the g-point fastest, as
//   optics_fused.cu, and the same device code: load_cell and tau_minor of
//   common.cuh, so that this output equals optics_fused's minor part bit for
//   bit (the same intervals in the same order from 0). No g-point limit.
//   64-bit offsets throughout. Nothing of the TPU kernel's structure is
//   kept: no scalar pack, no one-hot contraction, no bf16 hi/lo tables, no
//   per-group g-point padding.
#include "common.cuh"

namespace rrtmgp {

template <typename R>
__global__ void interp_minor_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d,
                                    R* __restrict__ out) {  // (nlay, ncol, ngpt)
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t lc = idx / d.ngpt;
  const int g = (int)(idx - lc * d.ngpt);
  const int l = (int)(lc / d.ncol);
  const int col = (int)(lc - (size_t)l * d.ncol);
  const CellT<R> c = load_cell(in, d, l, col, __ldg(tb.gpt2band + g));
  out[idx] = tau_minor(in, tb, d, c, g);
}

template <typename R>
cudaError_t launch_interp_minor(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d, R* out,
                                cudaStream_t stream) {
  // 128 threads a block, as optics_fused.cu: a latency-bound gather
  const int threads = 128;
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffull) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    interp_minor_kernel<R><<<(unsigned)blocks, threads, 0, stream>>>(in, tb, d, out);
  }
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. The arguments are optics_fused's without ray_factor and the tables
// of kmajor and the second table, which this kernel does not read.
extern "C" int rrtmgp_interp_minor(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    void* out, int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, nullptr};
  const Tables tb{nullptr, nullptr, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  return (int)launch_interp_minor<float>(in, tb, d, (float*)out, (cudaStream_t)stream);
}
