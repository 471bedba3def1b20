// Generic (pressure, temperature, eta) table interpolation per (layer,
// column, g-point): the table reads of the unfused gas optics, one table at a
// time (kmajor with col_mix, the Planck fraction, the Rayleigh table).
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _full_kernel (wrapper
//   interp_pt_eta) and _windowed_kernel (wrapper interp_pt_eta_windowed):
//   out = sum over the two temperature nodes of the temperature weight times
//   (pressure- and eta-interpolated table value x that node's col_mix). One
//   kernel covers both: the windowed variant computes the same function on a
//   per-layer table window, and the port reads whole tables from L2, so there
//   is no window to choose or to guard.
//
// Bound on this card: device memory for the output. At 32768 columns x 60
//   layers x 256 g-points it writes 2.01 GB (SW, 224 g-points: 1.76 GB) and
//   reads ~0.8 GB of per-(layer, column, band) inputs: ~0.8 ms at 3.35 TB/s.
//   Each point reads 8 table values (4 when the pressure weight is 0 past
//   the table's last slab) from a table that stays in L2 and does ~25
//   operations: expected limit, as for optics_fused.cu, the latency of the
//   dependent loads (cell indices, then table values), not the bytes.
//
// Design: one thread per (layer, column, g-point), the g-point fastest, as
//   optics_fused.cu: a warp reads neighbouring entries of the g-point-fastest
//   table, broadcasts the per-(layer, column) inputs and writes 128
//   contiguous bytes. No g-point limit (nothing is sized by the g-point
//   count). 64-bit offsets throughout (5.0e8 points per output). The
//   arithmetic is interp_p_eta of common.cuh in the same order, then the
//   temperature blend of tau_major before its col_dry, so that
//   kmajor x col_dry here equals optics_fused's major tau bit for bit; without
//   col_mix the factor is 1, which leaves every value as planck_fraction and
//   tau_rayleigh compute it. A table of npress pressure slabs is never read
//   past its last slab: the node above it (the Rayleigh table's side 1 with
//   fpress = 0) has weight 0 and contributes fpress * 0. Nothing of the TPU
//   kernel's structure is kept: no one-hot contraction, no bf16 hi/lo
//   table split, no window, no 128-lane g-point padding.
#include "common.cuh"

namespace rrtmgp {

// Per-(layer, column) and per-(layer, column, band) inputs of one call.
template <typename R>
struct InterpInT {
  const int* jtemp;
  const R* ftemp;
  const int* jpress;  // pressure slab of the lower node
  const R* fpress;
  const int* jeta1;
  const R* feta1;
  const R* cmix1;  // null: no col_mix (a factor of 1)
  const int* jeta2;
  const R* feta2;
  const R* cmix2;
};

// Pressure blend of table[jp][it][e][g] and table[jp+1][it][e][g]; the
// second is read only where slab jp+1 exists.
template <typename R>
__device__ __forceinline__ R p_blend(const R* t, const Dims& d, int npress, int jp, R omfp, R fp, int it, int e,
                                     int g) {
  const R hi = jp + 1 < npress ? tab(t, d, jp + 1, it, e, g) : R(0);
  return omfp * tab(t, d, jp, it, e, g) + fp * hi;
}

template <typename R>
__global__ void interp_pt_eta_kernel(const R* __restrict__ table,  // (npress, ntemp, neta, ngpt)
                                     InterpInT<R> in, const int* __restrict__ gpt2band, Dims d, int npress,
                                     R* __restrict__ out) {  // (nlay, ncol, ngpt)
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t lc = idx / d.ngpt;
  const int g = (int)(idx - lc * d.ngpt);
  const int jt = __ldg(in.jtemp + lc), jp = __ldg(in.jpress + lc);
  const R ft = __ldg(in.ftemp + lc), fp = __ldg(in.fpress + lc);
  const size_t lcb = lc * d.nbnd + __ldg(gpt2band + g);
  const int je1 = __ldg(in.jeta1 + lcb), je2 = __ldg(in.jeta2 + lcb);
  const R fe1 = __ldg(in.feta1 + lcb), fe2 = __ldg(in.feta2 + lcb);
  const R cm1 = in.cmix1 ? __ldg(in.cmix1 + lcb) : R(1);
  const R cm2 = in.cmix2 ? __ldg(in.cmix2 + lcb) : R(1);
  const R omfp = R(1) - fp;
  R a = p_blend(table, d, npress, jp, omfp, fp, jt, je1, g);
  R b = p_blend(table, d, npress, jp, omfp, fp, jt, je1 + 1, g);
  const R v0 = a * (R(1) - fe1) + b * fe1;
  a = p_blend(table, d, npress, jp, omfp, fp, jt + 1, je2, g);
  b = p_blend(table, d, npress, jp, omfp, fp, jt + 1, je2 + 1, g);
  const R v1 = a * (R(1) - fe2) + b * fe2;
  out[idx] = (R(1) - ft) * (v0 * cm1) + ft * (v1 * cm2);
}

template <typename R>
cudaError_t launch_interp_pt_eta(const R* table, const InterpInT<R>& in, const int* gpt2band, const Dims& d,
                                 int npress, R* out, cudaStream_t stream) {
  // 128 threads a block, as optics_fused.cu: a latency-bound gather
  const int threads = 128;
  const size_t total = (size_t)d.nlay * d.ncol * d.ngpt;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffull) return cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    interp_pt_eta_kernel<R><<<(unsigned)blocks, threads, 0, stream>>>(table, in, gpt2band, d, npress, out);
  }
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. cmix1 / cmix2 may both be null (no col_mix).
extern "C" int rrtmgp_interp_pt_eta(
    const void* table, const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* jeta1, const void* feta1, const void* cmix1, const void* jeta2, const void* feta2,
    const void* cmix2, const void* gpt2band, void* out,
    int nlay, int ncol, int ngpt, int nbnd, int npress, int ntemp, int neta, void* stream) {
  using namespace rrtmgp;
  const InterpInT<float> in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                            (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                            (const int*)jeta2, (const float*)feta2, (const float*)cmix2};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, 0};
  return (int)launch_interp_pt_eta<float>((const float*)table, in, (const int*)gpt2band, d, npress, (float*)out,
                                          (cudaStream_t)stream);
}
