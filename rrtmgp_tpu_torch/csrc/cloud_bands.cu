// Cloud band optics: tau, ssa and g per (layer, column, band) from the
// liquid and ice effective radii and water paths, delta-scaled for the SW.
//
// Replaces: no TPU kernel. The JAX package computes cloud optics in XLA
//   (rrtmgp_tpu/ops/cloud_optics.py, a one-hot product over the radius
//   grid), with no pallas_call. The port computed it in plain torch
//   (ops/cloud_optics.py cloud_optics_bands, then delta_scale): ~85-99
//   launches a wave, with (3, nlay, ncol, nbnd) gathers of the tables for
//   each phase. This kernel is one launch a wave.
//
// Bound on this card: device memory by bytes. Per (layer, column) it reads
//   4 floats and writes 3 x nbnd floats: 208 B at 16 bands (LW), 184 B at 14
//   (SW); at 60 x 75748 that is 0.945 / 0.836 GB, 0.28 / 0.25 ms at
//   3.35 TB/s. The tables are 2 x 3 x nsize x nbnd floats (9.6 KB at 25
//   sizes and 16 bands).
//
// Design: as many blocks as fit the SMs at once stage the liquid table and
//   the chosen roughness of the ice table in shared memory, then loop over
//   chunks of blockDim.x (layer, column) points. Each chunk has two phases:
//   (1) a thread a point reads the point's four fields once and forms each
//   phase's radius index and weight once, into shared memory; (2) the
//   chunk's (point, band) elements are one contiguous run of each output,
//   and consecutive threads take consecutive elements, so every store of a
//   warp is 128 contiguous bytes. A thread a point writing its nbnd floats
//   itself would store 32 lines a warp instruction; and a thread a point
//   reading the tables would hit the same bank from 16 points at once.
//
// Numerics: the plain chain's expressions in its order, op by op
//   (-fmad=false), under torch's CUDA rules, so the outputs equal the plain
//   chain's on the card bit for bit: the grid step (rad_upr - rad_lwr) /
//   (nsize - 1) multiplies by the f32 reciprocal, as torch does for a tensor
//   over a Python number; every other division is IEEE, as torch's over a
//   tensor; maxima and minima pass NaN on as torch.maximum / minimum do.
#include "common.cuh"

namespace rrtmgp {

// torch.maximum / torch.minimum on CUDA
template <typename real>
__device__ __forceinline__ real t_max(real a, real b) {
  return a != a ? a : (b != b ? b : r_max(a, b));
}
template <typename real>
__device__ __forceinline__ real t_min(real a, real b) {
  return a != a ? a : (b != b ? b : r_min(a, b));
}
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }

struct CloudArgs {
  const void* liq;        // (3, nsize_liq, nbnd)
  const void* ice;        // (3, nsize_ice, nbnd, nrgh)
  const void* rad_bounds[4];  // 0-dim: liquid lower, upper, ice lower, upper
  const void* field[4];   // (nlay, ncol) rows ld[k] apart: r_eff_liq, r_eff_ice, path_liq, path_ice
  long long ld[4];
  void* out[3];           // (nlay, ncol, nbnd) contiguous: tau, ssa, g
  int nlay, ncol, nbnd, nsize[2], nrgh, rgh;
};

template <bool DELTA_SCALE, typename real>
__global__ void cloud_bands_kernel(CloudArgs a) {
  extern __shared__ __align__(16) unsigned char cloud_staged[];
  real* tab = reinterpret_cast<real*>(cloud_staged);
  const int nb = a.nbnd, T = blockDim.x;
  const int nsize[2] = {a.nsize[0], a.nsize[1]};
  real* tab_ph[2] = {tab, tab + 3 * nsize[0] * nb};
  real* fac_s = tab + 3 * nb * (nsize[0] + nsize[1]);  // (2, T)
  real* fc1_s = fac_s + 2 * T;
  real* path_s = fc1_s + 2 * T;
  int* loc_s = reinterpret_cast<int*>(path_s + 2 * T);

  const real* liq = static_cast<const real*>(a.liq);
  const real* ice = static_cast<const real*>(a.ice);
  for (int i = threadIdx.x; i < 3 * nsize[0] * nb; i += T) tab_ph[0][i] = __ldg(liq + i);
  for (int i = threadIdx.x; i < 3 * nsize[1] * nb; i += T) {
    tab_ph[1][i] = __ldg(ice + (long long)i * a.nrgh + a.rgh);
  }
  real lwr[2], upr[2], dr[2];
#pragma unroll
  for (int ph = 0; ph < 2; ++ph) {
    lwr[ph] = __ldg(static_cast<const real*>(a.rad_bounds[2 * ph]));
    upr[ph] = __ldg(static_cast<const real*>(a.rad_bounds[2 * ph + 1]));
    // torch: a tensor over a Python number multiplies by its reciprocal
    dr[ph] = (upr[ph] - lwr[ph]) * (real(1) / real(nsize[ph] - 1));
  }
  const real eps = r_eps<real>();
  real* out_tau = static_cast<real*>(a.out[0]);
  real* out_ssa = static_cast<real*>(a.out[1]);
  real* out_g = static_cast<real*>(a.out[2]);
  __syncthreads();

  const long long n = (long long)a.nlay * a.ncol;
  // the element stride of phase 2, as (points, bands)
  const int dp = T / nb, db = T - dp * nb;
  for (long long base = (long long)blockIdx.x * T; base < n; base += (long long)gridDim.x * T) {
    const int np = (int)(n - base < T ? n - base : T);

    // (1) a thread a point: each phase's index and weight on the radius grid
    if (threadIdx.x < np) {
      const long long i = base + threadIdx.x;
      const long long l = i / a.ncol, c = i - l * a.ncol;
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const real re = __ldg(static_cast<const real*>(a.field[ph]) + l * a.ld[ph] + c);
        const real path = __ldg(static_cast<const real*>(a.field[2 + ph]) + l * a.ld[2 + ph] + c);
        const real re_c = t_min(t_max(re, lwr[ph]), upr[ph]);
        const real x = re_c - lwr[ph];
        // torch clamps the floor in floating point, then truncates; the
        // conversion here saturates, so clamping the integer is the same
        const int loc = min(max((int)r_floor(x / dr[ph]), 0), nsize[ph] - 2);
        const real fac = (x - real(loc) * dr[ph]) / dr[ph];
        fac_s[ph * T + threadIdx.x] = fac;
        fc1_s[ph * T + threadIdx.x] = real(1) - fac;
        path_s[ph * T + threadIdx.x] = path;
        loc_s[ph * T + threadIdx.x] = loc;
      }
    }
    __syncthreads();

    // (2) a thread an element (point p, band b) of the chunk's output run
    const long long o0 = base * nb;
    int p = threadIdx.x / nb, b = threadIdx.x - p * nb;
    for (int j = threadIdx.x; j < np * nb; j += T) {
      real tau_ph[2], ts_ph[2], tsg_ph[2];
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int ns = nsize[ph];
        const real fac = fac_s[ph * T + p], fc1 = fc1_s[ph * T + p], path = path_s[ph * T + p];
        const real* t = tab_ph[ph] + loc_s[ph * T + p] * nb + b;
        const real ext = fc1 * t[0] + fac * t[nb];
        const real ssa = fc1 * t[ns * nb] + fac * t[ns * nb + nb];
        const real asy = fc1 * t[2 * ns * nb] + fac * t[2 * ns * nb + nb];
        const real tau = t_max(ext * path, real(0));
        const real ts = ssa * tau;
        const real tsg = asy * ts;
        const bool active = path > eps;
        tau_ph[ph] = active ? tau : real(0);
        ts_ph[ph] = active ? ts : real(0);
        tsg_ph[ph] = active ? tsg : real(0);
      }
      const real tau = tau_ph[0] + tau_ph[1];
      const real ssa_sum = ts_ph[0] + ts_ph[1];
      const real g = (tsg_ph[0] + tsg_ph[1]) / t_max(ssa_sum, eps);
      const real ssa = ssa_sum / t_max(tau, eps);
      if constexpr (DELTA_SCALE) {
        const real f = g * g;
        const real wf = ssa * f;
        const real one_wf = real(1) - wf;
        out_tau[o0 + j] = one_wf * tau;
        out_ssa[o0 + j] = (ssa - wf) / t_max(one_wf, eps);
        out_g[o0 + j] = (g - f) / t_max(real(1) - f, eps);
      } else {
        out_tau[o0 + j] = tau;
        out_ssa[o0 + j] = ssa;
        out_g[o0 + j] = g;
      }
      p += dp;
      b += db;
      if (b >= nb) {
        b -= nb;
        ++p;
      }
    }
    __syncthreads();
  }
}

constexpr int kCloudThreads = 256;

// Shared memory of a block: the two tables, then per point of a chunk each
// phase's weight, its complement and its path, then each phase's index.
template <typename real>
size_t cloud_smem(int nbnd, int nsize_liq, int nsize_ice) {
  return sizeof(real) * (size_t)(3 * nbnd * (nsize_liq + nsize_ice) + 6 * kCloudThreads) +
         sizeof(int) * 2 * kCloudThreads;
}

template <bool DELTA_SCALE>
cudaError_t launch_cloud_bands(const CloudArgs& a, cudaStream_t stream) {
  auto kernel = cloud_bands_kernel<DELTA_SCALE, float>;
  const size_t smem = cloud_smem<float>(a.nbnd, a.nsize[0], a.nsize[1]);
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCloudThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n = (long long)a.nlay * a.ncol;
  const long long need = (n + kCloudThreads - 1) / kCloudThreads;
  const unsigned blocks = (unsigned)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  kernel<<<blocks, kCloudThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// The liquid table (3, nsize_liq, nbnd), the ice table (3, nsize_ice, nbnd,
// nrgh) and the roughness index rgh into its last axis; the radius bounds
// (0-dim: liquid lower, upper, ice lower, upper); the fields r_eff_liq,
// r_eff_ice, path_liq, path_ice (nlay, ncol), rows ld_* elements apart;
// the outputs tau, ssa, g (nlay, ncol, nbnd) contiguous; then nlay, ncol,
// nbnd, nsize_liq, nsize_ice, nrgh, rgh, delta_scale and the stream. f32.
extern "C" int rrtmgp_cloud_bands(const void* liq, const void* ice, const void* liq_lwr, const void* liq_upr,
                                  const void* ice_lwr, const void* ice_upr, const void* r_liq, const void* r_ice,
                                  const void* path_liq, const void* path_ice, void* tau, void* ssa, void* g,
                                  long long ld_r_liq, long long ld_r_ice, long long ld_path_liq,
                                  long long ld_path_ice, int nlay, int ncol, int nbnd, int nsize_liq,
                                  int nsize_ice, int nrgh, int rgh, int delta_scale, void* stream) {
  using namespace rrtmgp;
  const CloudArgs a{liq, ice, {liq_lwr, liq_upr, ice_lwr, ice_upr}, {r_liq, r_ice, path_liq, path_ice},
                    {ld_r_liq, ld_r_ice, ld_path_liq, ld_path_ice}, {tau, ssa, g},
                    nlay, ncol, nbnd, {nsize_liq, nsize_ice}, nrgh, rgh};
  if ((long long)nlay * ncol == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(delta_scale ? launch_cloud_bands<true>(a, s) : launch_cloud_bands<false>(a, s));
}

// Dynamic shared memory of one f32 cloud_bands block: the tables and the
// chunk's point records.
extern "C" long long rrtmgp_cloud_bands_smem(int nbnd, int nsize_liq, int nsize_ice) {
  return (long long)rrtmgp::cloud_smem<float>(nbnd, nsize_liq, nsize_ice);
}
