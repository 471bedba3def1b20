// McICA export: the uniforms and the cloud mask the megakernels draw in seed
// mode, written to device memory.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _mcica_export_kernel (wrapper
//   mcica_mask_export), which replays the TPU kernels' in-kernel stream. This
//   kernel calls the same device functions (mcica.cuh) as lw2_mega.cu and
//   sw_clear_mega.cu, so what it writes is exactly the mask they use.
//
// Bound on this card: device memory. Each (layer, column, g-point) costs two
//   threefry blocks (~2 x 100 integer operations) and writes 8 bytes; at
//   75748 columns x 60 layers x 256 g-points that is 9.3 GB of writes
//   (~2.8 ms at 3.35 TB/s) against ~1e12 integer operations (~30 ms at the
//   card's ~34 Tops/s of 32-bit integer throughput): the integer arithmetic
//   bounds it, as it bounds the in-kernel samplers.
//
// Design: one block per column, one thread per g-point (more than 1024: a
//   column over several blocks of the host's launch plan); the column key is
//   computed once per thread, the layer loop runs top-down carrying the
//   recurrence in registers. Outputs (nlay, ncol, ngpt) f32, mask as 0/1.
#include "common.cuh"
#include "mcica.cuh"

namespace rrtmgp {

__global__ void mcica_export_kernel(const float* __restrict__ cld_frac,  // (nlay, ncol)
                                    float* __restrict__ u_out,           // (nlay, ncol, ngpt)
                                    float* __restrict__ m_out,           // (nlay, ncol, ngpt)
                                    int nlay, int ncol, int ngpt, Key2x32 seed, long long col_offset) {
  const int col = blockIdx.x;
  const int g = blockIdx.y * blockDim.x + threadIdx.x;  // gridDim.y > 1 past 1024 g-points
  if (g >= ngpt) return;
  const Key2x32 ck = mcica_column_key(seed, col_offset + col);
  McicaCarry carry;
  for (int l = nlay - 1; l >= 0; --l) {
    const float u = mcica_uniform(ck, (uint32_t)l * (uint32_t)ngpt + (uint32_t)g);
    const bool m = carry.step(u, __ldg(cld_frac + (size_t)l * ncol + col));
    const size_t s = ((size_t)l * ncol + col) * ngpt + g;
    u_out[s] = u;
    m_out[s] = m ? 1.f : 0.f;
  }
}

}  // namespace rrtmgp

// group, n_groups: the host's launch plan (ops/_launch.py gpoint_plan).
extern "C" int rrtmgp_mcica_export(const void* cld_frac, void* u_out, void* m_out, int nlay, int ncol,
                                   int ngpt, int group, int n_groups, unsigned seed_hi, unsigned seed_lo,
                                   long long col_offset, void* stream) {
  using namespace rrtmgp;
  if (ncol > 0) {
    mcica_export_kernel<<<dim3((unsigned)ncol, (unsigned)n_groups), group, 0, (cudaStream_t)stream>>>(
        (const float*)cld_frac, (float*)u_out, (float*)m_out, nlay, ncol, ngpt, Key2x32{seed_hi, seed_lo},
        col_offset);
  }
  return (int)cudaGetLastError();
}

namespace rrtmgp {

// The most threads a block of mcica_export may have (errors.cu
// rrtmgp_max_threads); variant is 0.
cudaError_t mcica_export_max_threads(int, int* threads) { return max_threads(threads, mcica_export_kernel); }

}  // namespace rrtmgp
