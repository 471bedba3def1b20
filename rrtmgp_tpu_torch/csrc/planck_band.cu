// Band Planck emission: linear interpolation of totplnk in temperature, in
// two output layouts: bands leading (nbnd, N) for the megakernels, rows
// leading (N, nbnd) for the sweep of the two-kernel path. One launch takes
// every temperature set of a solve (layers, levels, surface: up to three).
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
//   pair from a table of a few KB, two multiplies and an add, and a 4-byte
//   store (8 in f64); each temperature is read once. The clear cell's three
//   sets (32768 columns x 60 layers, 61 levels and the surface, 16 bands)
//   write 256 MB, ~80 us at 3.35 TB/s.
//
// Design: the sets travel by value (PlanckSets); set k owns the blocks
//   start[k] .. start[k+1]-1 (ops/_launch.py sets_plan), each block `span`
//   consecutive points of it, looped over, so that a block stages the table
//   once for many points. The table is staged in shared memory transposed,
//   (nbnd, n_t) with an odd row stride, so that one band's gathers in a warp
//   fall on adjacent words. A thread forms a point's index and weights
//   once (32-bit, no integer division) and then loops over the bands:
//   bands leading, a thread per point, a warp stores 128 contiguous bytes a
//   band; rows, four threads per point (blockDim.x = ceil(nbnd / 4)), each
//   with four bands in one float4 store, a warp storing 8 whole rows (512
//   contiguous bytes at 16 bands). The expressions and their order are the
//   per-output kernel's: j = clip(floor((t - t_min)/dt), 0, n_t-2), f =
//   clip(loc - j, 0, 1), v = T[j](1 - f) + T[j+1] f with an IEEE divide and
//   -fmad=false, so the bits are the same; outside the grid the end values.
//   The working precision throughout (f32, and f64 for the bands-leading
//   kernel), no hi/lo split.
#include <cuda_runtime.h>

#include <cstdint>

namespace rrtmgp {

constexpr int kPlanckSets = 3;       // temperature sets of one launch
constexpr int kPlanckThreads = 256;  // threads of a block

__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ double clip(double x, double lo, double hi) { return fmin(fmax(x, lo), hi); }
__device__ __forceinline__ float floor_r(float x) { return floorf(x); }
__device__ __forceinline__ double floor_r(double x) { return floor(x); }

// The sets of one launch: set k's temperatures (n[k],), its output, and its
// first block; start[kPlanckSets] is the grid. An unused set has n = 0 and
// start = the grid.
template <typename R>
struct PlanckSets {
  const R* t[kPlanckSets];
  R* out[kPlanckSets];
  int n[kPlanckSets];
  int start[kPlanckSets + 1];
};

// This block's set and its points [first, first + count).
template <typename R>
struct PlanckBlock {
  const R* t;
  R* out;
  int n, first, count;
};

template <typename R>
__device__ __forceinline__ PlanckBlock<R> planck_block(const PlanckSets<R>& s, int span) {
  const int b = (int)blockIdx.x;
  const int k = b >= s.start[2] ? 2 : b >= s.start[1] ? 1 : 0;  // the last set that starts at or before b
  PlanckBlock<R> p;
  p.t = k == 0 ? s.t[0] : k == 1 ? s.t[1] : s.t[2];
  p.out = k == 0 ? s.out[0] : k == 1 ? s.out[1] : s.out[2];
  p.n = k == 0 ? s.n[0] : k == 1 ? s.n[1] : s.n[2];
  p.first = (b - (k == 0 ? s.start[0] : k == 1 ? s.start[1] : s.start[2])) * span;
  p.count = min(span, p.n - p.first);
  return p;
}

// totplnk (n_t, nbnd) into shared memory as (nbnd, ld): thread i copies
// band i % nbnd of rows i / nbnd, i / nbnd + rows, ... (one division a
// thread), reading consecutive words.
template <typename R>
__device__ __forceinline__ void stage_table(R* table, const R* __restrict__ tp, int nbnd, int n_t, int ld) {
  const int threads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int rows = threads / nbnd;
  const int j0 = tid / nbnd, b = tid - j0 * nbnd;
  if (j0 < rows)
    for (int j = j0; j < n_t; j += rows) table[b * ld + j] = __ldg(tp + j * nbnd + b);
  __syncthreads();
}

// One temperature's node and weights: formed once, used for every band.
template <typename R>
struct PlanckPoint {
  int j;
  R f, g;  // g = 1 - f
};

template <typename R>
__device__ __forceinline__ PlanckPoint<R> planck_point(R t, int n_t, R t_min, R t_delta) {
  const R loc = (t - t_min) / t_delta;
  const R j = clip(floor_r(loc), R(0), (R)(n_t - 2));
  const R f = clip(loc - j, R(0), R(1));
  return {(int)j, f, R(1) - f};
}

// One band's value from its staged row.
template <typename R>
__device__ __forceinline__ R planck_value(const R* row, const PlanckPoint<R>& p) {
  return row[p.j] * p.g + row[p.j + 1] * p.f;
}

extern __shared__ __align__(16) unsigned char planck_smem[];

template <typename R>
__global__ void __launch_bounds__(kPlanckThreads)
    planck_band_kernel(PlanckSets<R> sets, const R* __restrict__ tp, int nbnd, int n_t, int ld, int span,
                       R t_min, R t_delta) {
  R* table = reinterpret_cast<R*>(planck_smem);
  const PlanckBlock<R> blk = planck_block(sets, span);
  stage_table(table, tp, nbnd, n_t, ld);
  for (int i = (int)threadIdx.x; i < blk.count; i += blockDim.x) {
    const int point = blk.first + i;
    const PlanckPoint<R> p = planck_point(__ldg(blk.t + point), n_t, t_min, t_delta);
    R* o = blk.out + point;  // (nbnd, n): band b at o + b n
    for (int b = 0; b < nbnd; ++b, o += blk.n) *o = planck_value(table + b * ld, p);
  }
}

// Rows: thread (q, y) writes bands 4q .. 4q+3 of points first + y, first +
// y + blockDim.y, ...; VEC (nbnd a multiple of 4, every output 16-byte
// aligned) as one float4.
template <bool VEC>
__global__ void __launch_bounds__(kPlanckThreads)
    planck_band_rows_kernel(PlanckSets<float> sets, const float* __restrict__ tp, int nbnd, int n_t, int ld,
                            int span, float t_min, float t_delta) {
  float* table = reinterpret_cast<float*>(planck_smem);
  const PlanckBlock<float> blk = planck_block(sets, span);
  stage_table(table, tp, nbnd, n_t, ld);
  const int b0 = 4 * (int)threadIdx.x;
  const float* row = table + b0 * ld;
  for (int i = (int)threadIdx.y; i < blk.count; i += blockDim.y) {
    const int point = blk.first + i;
    const PlanckPoint<float> p = planck_point(__ldg(blk.t + point), n_t, t_min, t_delta);
    float* o = blk.out + (int64_t)point * nbnd + b0;
    if constexpr (VEC) {
      float4 v;
      v.x = planck_value(row, p);
      v.y = planck_value(row + ld, p);
      v.z = planck_value(row + 2 * ld, p);
      v.w = planck_value(row + 3 * ld, p);
      *reinterpret_cast<float4*>(o) = v;
    } else {
      for (int b = 0; b < 4 && b0 + b < nbnd; ++b) o[b] = planck_value(row + b * ld, p);
    }
  }
}

template <typename R>
PlanckSets<R> planck_sets(const void* t0, const void* t1, const void* t2, void* out0, void* out1, void* out2,
                          int n0, int n1, int n2, int start1, int start2, int grid) {
  PlanckSets<R> s;
  s.t[0] = (const R*)t0, s.t[1] = (const R*)t1, s.t[2] = (const R*)t2;
  s.out[0] = (R*)out0, s.out[1] = (R*)out1, s.out[2] = (R*)out2;
  s.n[0] = n0, s.n[1] = n1, s.n[2] = n2;
  s.start[0] = 0, s.start[1] = start1, s.start[2] = start2, s.start[3] = grid;
  return s;
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The table's row stride in shared memory: n_t made odd.
inline int planck_ld(int n_t) { return n_t | 1; }

template <typename R>
int launch_planck_band(const void* totplnk, const PlanckSets<R>& sets, int span, int nbnd, int n_t, R t_min,
                       R t_delta, void* stream) {
  const int grid = sets.start[kPlanckSets];
  if (grid == 0) return 0;
  const int ld = planck_ld(n_t);
  const size_t smem = (size_t)nbnd * ld * sizeof(R);
  auto kernel = planck_band_kernel<R>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kPlanckThreads, smem, (cudaStream_t)stream>>>(sets, (const R*)totplnk, nbnd, n_t, ld, span,
                                                               t_min, t_delta);
  return (int)cudaGetLastError();
}

int launch_planck_band_rows(const void* totplnk, const PlanckSets<float>& sets, int span, int nbnd, int n_t,
                            float t_min, float t_delta, void* stream) {
  const int grid = sets.start[kPlanckSets];
  if (grid == 0) return 0;
  const int ld = planck_ld(n_t);
  const size_t smem = (size_t)nbnd * ld * sizeof(float);
  const int quads = (nbnd + 3) / 4;
  const dim3 block(quads, kPlanckThreads / quads);
  bool vec = nbnd % 4 == 0;
  for (int k = 0; k < kPlanckSets; ++k) vec = vec && (uintptr_t)sets.out[k] % 16 == 0;
  auto kernel = vec ? planck_band_rows_kernel<true> : planck_band_rows_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(sets, (const float*)totplnk, nbnd, n_t, ld, span, t_min,
                                                      t_delta);
  return (int)cudaGetLastError();
}

}  // namespace rrtmgp

// Each entry point takes the table, up to three sets (temperatures, outputs,
// sizes; null and 0 where unused), the plan (the first block of sets 1 and
// 2, the grid, the points of a block), the table's dims and grid.
extern "C" int rrtmgp_planck_band(const void* totplnk, const void* t0, const void* t1, const void* t2, void* out0,
                                  void* out1, void* out2, int n0, int n1, int n2, int start1, int start2, int grid,
                                  int span, int nbnd, int n_t, float t_min, float t_delta, void* stream) {
  const auto sets = rrtmgp::planck_sets<float>(t0, t1, t2, out0, out1, out2, n0, n1, n2, start1, start2, grid);
  return rrtmgp::launch_planck_band<float>(totplnk, sets, span, nbnd, n_t, t_min, t_delta, stream);
}

extern "C" int rrtmgp_planck_band_f64(const void* totplnk, const void* t0, const void* t1, const void* t2,
                                      void* out0, void* out1, void* out2, int n0, int n1, int n2, int start1,
                                      int start2, int grid, int span, int nbnd, int n_t, double t_min,
                                      double t_delta, void* stream) {
  const auto sets = rrtmgp::planck_sets<double>(t0, t1, t2, out0, out1, out2, n0, n1, n2, start1, start2, grid);
  return rrtmgp::launch_planck_band<double>(totplnk, sets, span, nbnd, n_t, t_min, t_delta, stream);
}

// Rows layout: each out is (n, nbnd).
extern "C" int rrtmgp_planck_band_rows(const void* totplnk, const void* t0, const void* t1, const void* t2,
                                       void* out0, void* out1, void* out2, int n0, int n1, int n2, int start1,
                                       int start2, int grid, int span, int nbnd, int n_t, float t_min,
                                       float t_delta, void* stream) {
  const auto sets = rrtmgp::planck_sets<float>(t0, t1, t2, out0, out1, out2, n0, n1, n2, start1, start2, grid);
  return rrtmgp::launch_planck_band_rows(totplnk, sets, span, nbnd, n_t, t_min, t_delta, stream);
}
