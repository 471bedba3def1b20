// Band Planck emission: linear interpolation of totplnk in temperature, in
// two output layouts: bands leading (nbnd, N) for the megakernels, rows
// leading (N, nbnd) for the sweep of the two-kernel path.
//
// Replaces: rrtmgp_tpu/ops/pallas_mega.py, _planck_band_t_kernel (wrapper
//   planck_band_pallas_t) and _planck_band_w_kernel (wrapper
//   planck_band_windowed). One kernel covers both: without the TPU's
//   one-hot contraction there is no table window to choose, and no
//   in-window flag to return. And rrtmgp_tpu/ops/pallas_interp.py,
//   _planck_band_kernel (wrapper planck_band_pallas): the same function with
//   the output (N, nbnd), planck_band_rows_kernel below. It is a kernel of
//   its own because the write pattern differs: the sweep
//   (lw_noscat_banded.cu) reads (nlay, ncol, nbnd), so that the bands of one
//   column lie side by side for the threads of its block.
//
// Bound on this card: device memory. Each output value costs one table
//   pair from a table of a few KB (L1/L2 resident), ~10 flops, and a 4-byte
//   store; the temperature is read once per band thread but from cache after
//   the first. At 60 layers x 32768 columns x 16 bands it writes 126 MB for
//   the layers, ~40 us at 3.35 TB/s.
//
// Design: one thread per (band, point), band-major, so consecutive threads
//   write consecutive addresses of the (nbnd, N) output; the rows kernel one
//   thread per (point, band), band fastest, for the same reason (the 16
//   threads of a point share its temperature load). The working
//   precision throughout (one instantiation for f32, one for f64, 8-byte
//   stores), no hi/lo split. j = clip(floor((t - t_min)/dt), 0, n_t-2), f = clip(loc - j,
//   0, 1): outside the grid the end values are returned.
#include <cuda_runtime.h>

namespace rrtmgp {

__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ double clip(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }
__device__ __forceinline__ float floor_r(float x) { return floorf(x); }
__device__ __forceinline__ double floor_r(double x) { return floor(x); }

// totplnk (n_t, nbnd) interpolated at temperature t for band b.
template <typename R>
__device__ __forceinline__ R planck_interp(R t, const R* __restrict__ tp, int b, int nbnd, int n_t, R t_min,
                                           R t_delta) {
  const R loc = (t - t_min) / t_delta;
  const R j = clip(floor_r(loc), R(0), (R)(n_t - 2));
  const R f = clip(loc - j, R(0), R(1));
  const int jj = (int)j;
  return __ldg(tp + (size_t)jj * nbnd + b) * (R(1) - f) + __ldg(tp + (size_t)(jj + 1) * nbnd + b) * f;
}

template <typename R>
__global__ void planck_band_kernel(const R* __restrict__ t,   // (n,)
                                   const R* __restrict__ tp,  // (n_t, nbnd)
                                   R* __restrict__ out,       // (nbnd, n)
                                   long long n, int nbnd, int n_t, R t_min, R t_delta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * nbnd) return;
  const int b = (int)(idx / n);
  const long long i = idx - (long long)b * n;
  out[idx] = planck_interp(__ldg(t + i), tp, b, nbnd, n_t, t_min, t_delta);
}

template <typename R>
__global__ void planck_band_rows_kernel(const R* __restrict__ t,   // (n,)
                                        const R* __restrict__ tp,  // (n_t, nbnd)
                                        R* __restrict__ out,       // (n, nbnd)
                                        long long n, int nbnd, int n_t, R t_min, R t_delta) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * nbnd) return;
  const long long i = idx / nbnd;
  const int b = (int)(idx - i * nbnd);
  out[idx] = planck_interp(__ldg(t + i), tp, b, nbnd, n_t, t_min, t_delta);
}

template <typename R, bool ROWS = false>
int launch_planck_band(const void* t, const void* totplnk, void* out, long long n, int nbnd, int n_t,
                       R t_min, R t_delta, void* stream) {
  const int threads = 256;
  const long long total = n * nbnd;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    auto kernel = planck_band_kernel<R>;
    if constexpr (ROWS) kernel = planck_band_rows_kernel<R>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const R*)t, (const R*)totplnk, (R*)out, n, nbnd, n_t, t_min, t_delta);
  }
  return (int)cudaGetLastError();
}

}  // namespace rrtmgp

extern "C" int rrtmgp_planck_band(const void* t, const void* totplnk, void* out, long long n, int nbnd,
                                  int n_t, float t_min, float t_delta, void* stream) {
  return rrtmgp::launch_planck_band<float>(t, totplnk, out, n, nbnd, n_t, t_min, t_delta, stream);
}

extern "C" int rrtmgp_planck_band_f64(const void* t, const void* totplnk, void* out, long long n, int nbnd,
                                      int n_t, double t_min, double t_delta, void* stream) {
  return rrtmgp::launch_planck_band<double>(t, totplnk, out, n, nbnd, n_t, t_min, t_delta, stream);
}

// Rows layout: out is (n, nbnd).
extern "C" int rrtmgp_planck_band_rows(const void* t, const void* totplnk, void* out, long long n, int nbnd,
                                       int n_t, float t_min, float t_delta, void* stream) {
  return rrtmgp::launch_planck_band<float, true>(t, totplnk, out, n, nbnd, n_t, t_min, t_delta, stream);
}
