// Band Planck emission: linear interpolation of totplnk in temperature.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _planck_band_t_kernel (wrapper
//   planck_band_pallas_t) and _planck_band_w_kernel (wrapper
//   planck_band_windowed). One kernel covers both: without the TPU's
//   one-hot contraction there is no table window to choose, and no
//   in-window flag to return.
//
// Bound on this card: device memory. Each output value costs one table
//   pair from a table of a few KB (L1/L2 resident), ~10 flops, and a 4-byte
//   store; the temperature is read once per band thread but from cache after
//   the first. At 60 layers x 32768 columns x 16 bands it writes 126 MB for
//   the layers, ~40 us at 3.35 TB/s.
//
// Design: one thread per (band, point), band-major, so consecutive threads
//   write consecutive addresses of the (nbnd, N) output. f32 throughout, no
//   hi/lo split. j = clip(floor((t - t_min)/dt), 0, n_t-2), f = clip(loc - j,
//   0, 1): outside the grid the end values are returned.
#include <cuda_runtime.h>

namespace rrtmgp {

__global__ void planck_band_kernel(const float* __restrict__ t,   // (n,)
                                   const float* __restrict__ tp,  // (n_t, nbnd)
                                   float* __restrict__ out,       // (nbnd, n)
                                   long long n, int nbnd, int n_t, float t_min, float t_delta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * nbnd) return;
  const int b = (int)(idx / n);
  const long long i = idx - (long long)b * n;
  const float loc = (__ldg(t + i) - t_min) / t_delta;
  const float j = fminf(fmaxf(floorf(loc), 0.f), (float)(n_t - 2));
  const float f = fminf(fmaxf(loc - j, 0.f), 1.f);
  const int jj = (int)j;
  out[idx] = __ldg(tp + (size_t)jj * nbnd + b) * (1.f - f) + __ldg(tp + (size_t)(jj + 1) * nbnd + b) * f;
}

}  // namespace rrtmgp

extern "C" int rrtmgp_planck_band(const void* t, const void* totplnk, void* out, long long n, int nbnd,
                                  int n_t, float t_min, float t_delta, void* stream) {
  const int threads = 256;
  const long long total = n * nbnd;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    rrtmgp::planck_band_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)t, (const float*)totplnk, (float*)out, n, nbnd, n_t, t_min, t_delta);
  }
  return (int)cudaGetLastError();
}
