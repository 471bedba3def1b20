// Device helpers shared by the megakernels (lw_clear_mega.cu,
// sw_clear_mega.cu, lw2_mega.cu) and the kernels of the two-kernel path
// (optics_fused.cu, interp_pt_eta.cu, interp_minor.cu, lw_noscat_banded.cu,
// sw_2stream_reduced.cu): the
// per-(layer, column) gas-optics inputs, table interpolation for one g-point,
// the Clough source factor, and deterministic per-level g-point sums.
//
// Every real-valued type is a template parameter R (float by default, double
// for the f64 instantiations); the unsuffixed names (OpticsIn, Tables, Cell,
// LevelSums) are the float ones. Constants and math functions go through the
// small overloads below, so an instantiation has no step of another
// precision in its value path.
//
// Layouts (reals of type R, C order):
//   per (layer, column)          (nlay, ncol)
//   per (layer, column, band)    (nlay, ncol, nbnd)
//   minor scaling                (n_minor, nlay, ncol)
//   kmajor, planck fraction      (npress+1, ntemp, neta, ngpt)
//   rayleigh                     (2, ntemp, neta, ngpt)
//   kminor                       (ntemp, neta, ncontrib)
//   scratch                      (nlay, ncol, ngpt)
#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace rrtmgp {

// Machine epsilon and the math functions of the working precision.
template <typename R> __host__ __device__ constexpr R r_eps();
template <> __host__ __device__ constexpr float r_eps<float>() { return FLT_EPSILON; }
template <> __host__ __device__ constexpr double r_eps<double>() { return DBL_EPSILON; }
// sqrt(r_eps), the floor of k^2 in the SW two-stream coefficients
template <typename R> __host__ __device__ constexpr R r_sqrt_eps();
template <> __host__ __device__ constexpr float r_sqrt_eps<float>() { return 3.4526698300124393e-4f; }
template <> __host__ __device__ constexpr double r_sqrt_eps<double>() { return 1.4901161193847656e-8; }
__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double r_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }

// Gas-optics inputs of one solve (ops/mega_inputs.py MegaInputs).
template <typename R>
struct OpticsInT {
  const int* jtemp;
  const R* ftemp;
  const int* jpress;
  const R* fpress;
  const unsigned char* tropo_lower;
  const R* col_dry;
  const int* jeta1;
  const R* feta1;
  const R* cmix1;
  const int* jeta2;
  const R* feta2;
  const R* cmix2;
  const R* minor_scaling;
  const R* ray_factor;  // SW only
};
using OpticsIn = OpticsInT<float>;

// One lookup's tables (ops/mega_inputs.py KernelTables).
template <typename R>
struct TablesT {
  const R* kmajor;
  const R* second;  // planck fraction (LW) or rayleigh (SW)
  const R* kminor;
  const int* gpt2band;
  const int* minor_start;  // (2, ngpt+1)
  const int* minor_list;
  const int* minor_kbase;
  const int* minor_band;
};
using Tables = TablesT<float>;

struct Dims {
  int nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib;
};

// Interpolation state of one (layer, column) for the band of one g-point.
template <typename R>
struct CellT {
  size_t lc;  // layer * ncol + column
  int jt, jp, je1, je2;
  R ft, fp, fe1, fe2, cm1, cm2, col_dry;
  bool lower;
};
using Cell = CellT<float>;

template <typename R>
__device__ __forceinline__ CellT<R> load_cell(const OpticsInT<R>& in, const Dims& d, int l, int col, int band) {
  CellT<R> c;
  c.lc = (size_t)l * d.ncol + col;
  c.jt = __ldg(in.jtemp + c.lc);
  c.ft = __ldg(in.ftemp + c.lc);
  c.jp = __ldg(in.jpress + c.lc);
  c.fp = __ldg(in.fpress + c.lc);
  c.lower = __ldg(in.tropo_lower + c.lc) != 0;
  c.col_dry = __ldg(in.col_dry + c.lc);
  const size_t lcb = c.lc * d.nbnd + band;
  c.je1 = __ldg(in.jeta1 + lcb);
  c.fe1 = __ldg(in.feta1 + lcb);
  c.cm1 = __ldg(in.cmix1 + lcb);
  c.je2 = __ldg(in.jeta2 + lcb);
  c.fe2 = __ldg(in.feta2 + lcb);
  c.cm2 = __ldg(in.cmix2 + lcb);
  return c;
}

// table[p][t][e][g] of a (*, ntemp, neta, ngpt) table
template <typename R>
__device__ __forceinline__ R tab(const R* t, const Dims& d, int p, int it, int e, int g) {
  return __ldg(t + (((size_t)p * d.ntemp + it) * d.neta + e) * d.ngpt + g);
}

// Pressure/eta interpolation of a (npress+1, ntemp, neta, ngpt) table at the
// two temperature nodes of a cell: v0 at jtemp (eta data 1), v1 at jtemp+1
// (eta data 2). The temperature blend is left to the caller.
template <typename R>
__device__ __forceinline__ void interp_p_eta(const R* t, const Dims& d, const CellT<R>& c, int g, R& v0, R& v1) {
  const R omfp = R(1) - c.fp;
  R a = omfp * tab(t, d, c.jp, c.jt, c.je1, g) + c.fp * tab(t, d, c.jp + 1, c.jt, c.je1, g);
  R b = omfp * tab(t, d, c.jp, c.jt, c.je1 + 1, g) + c.fp * tab(t, d, c.jp + 1, c.jt, c.je1 + 1, g);
  v0 = a * (R(1) - c.fe1) + b * c.fe1;
  a = omfp * tab(t, d, c.jp, c.jt + 1, c.je2, g) + c.fp * tab(t, d, c.jp + 1, c.jt + 1, c.je2, g);
  b = omfp * tab(t, d, c.jp, c.jt + 1, c.je2 + 1, g) + c.fp * tab(t, d, c.jp + 1, c.jt + 1, c.je2 + 1, g);
  v1 = a * (R(1) - c.fe2) + b * c.fe2;
}

// Major-species optical depth of g-point g (before the minor gases).
template <typename R>
__device__ __forceinline__ R tau_major(const TablesT<R>& tb, const Dims& d, const CellT<R>& c, int g) {
  R v0, v1;
  interp_p_eta(tb.kmajor, d, c, g, v0, v1);
  return ((R(1) - c.ft) * (v0 * c.cm1) + c.ft * (v1 * c.cm2)) * c.col_dry;
}

// Minor-gas optical depth of g-point g: the intervals of the cell's
// troposphere side that cover g (the other side's scalings are zero).
template <typename R>
__device__ __forceinline__ R tau_minor(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d,
                                       const CellT<R>& c, int g) {
  const int side = c.lower ? 0 : 1;
  const int* start = tb.minor_start + side * (d.ngpt + 1);
  const size_t plane = (size_t)d.nlay * d.ncol;
  R tau = R(0);
  for (int k = __ldg(start + g), k1 = __ldg(start + g + 1); k < k1; ++k) {
    const int i = __ldg(tb.minor_list + k);
    const R s = __ldg(in.minor_scaling + (size_t)i * plane + c.lc);
    const size_t lcb = c.lc * d.nbnd + __ldg(tb.minor_band + i);
    const int je1 = __ldg(in.jeta1 + lcb), je2 = __ldg(in.jeta2 + lcb);
    const R fe1 = __ldg(in.feta1 + lcb), fe2 = __ldg(in.feta2 + lcb);
    const R* k0 = tb.kminor + __ldg(tb.minor_kbase + i) + g;
    const size_t nc = d.ncontrib;
    const size_t r1 = (size_t)c.jt * d.neta, r2 = (size_t)(c.jt + 1) * d.neta;
    const R v1 = (R(1) - fe1) * __ldg(k0 + (r1 + je1) * nc) + fe1 * __ldg(k0 + (r1 + je1 + 1) * nc);
    const R v2 = (R(1) - fe2) * __ldg(k0 + (r2 + je2) * nc) + fe2 * __ldg(k0 + (r2 + je2 + 1) * nc);
    tau += ((R(1) - c.ft) * v1 + c.ft * v2) * s;
  }
  return tau;
}

// Planck fraction of g-point g (LW: tb.second is the Planck-fraction table).
template <typename R>
__device__ __forceinline__ R planck_fraction(const TablesT<R>& tb, const Dims& d, const CellT<R>& c, int g) {
  R v0, v1;
  interp_p_eta(tb.second, d, c, g, v0, v1);
  return (R(1) - c.ft) * v0 + c.ft * v1;
}

// Rayleigh optical depth of g-point g (SW: tb.second is the Rayleigh table):
// (troposphere side, temperature, eta) interpolation times the Rayleigh
// column amount.
template <typename R>
__device__ __forceinline__ R tau_rayleigh(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d,
                                          const CellT<R>& c, int g) {
  const int side = c.lower ? 0 : 1;
  const R r0 = tab(tb.second, d, side, c.jt, c.je1, g) * (R(1) - c.fe1) +
               tab(tb.second, d, side, c.jt, c.je1 + 1, g) * c.fe1;
  const R r1 = tab(tb.second, d, side, c.jt + 1, c.je2, g) * (R(1) - c.fe2) +
               tab(tb.second, d, side, c.jt + 1, c.je2 + 1, g) * c.fe2;
  return ((R(1) - c.ft) * r0 + c.ft * r1) * __ldg(in.ray_factor + c.lc);
}

// Clough et al. (1992) linear-in-tau source factor (1 - trans) / tau - trans
// for the slant optical depth tau_loc with trans = exp(-tau_loc); below
// 100 eps its three-term series, where the closed form cancels.
template <typename R>
__device__ __forceinline__ R clough_factor(R tau_loc, R trans) {
  return tau_loc > R(100) * r_eps<R>()
             ? (R(1) - trans) / tau_loc - trans
             : tau_loc * (R(0.5) + tau_loc * (R(-1) / R(3) + tau_loc * R(0.125)));
}

// Per-level g-point sums for one column (one block). Each warp reduces with
// shuffles and its lane 0 writes the warp's partial into its own shared
// slot; finish() adds the warps in a fixed order. No atomics, so the sums
// are the same on every run.
template <typename R>
struct LevelSumsT {
  R* smem;  // [nf][nlev][nwarps]
  int nlev, nwarps;

  __device__ __forceinline__ void add(int f, int lev, R v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) smem[((size_t)f * nlev + lev) * nwarps + (threadIdx.x >> 5)] = v;
  }

  // sum of field f at level lev, after a __syncthreads()
  __device__ __forceinline__ R total(int f, int lev) const {
    const R* p = smem + ((size_t)f * nlev + lev) * nwarps;
    R s = R(0);
    for (int w = 0; w < nwarps; ++w) s += p[w];
    return s;
  }
};
using LevelSums = LevelSumsT<float>;

// Launch shape shared by the megakernels: one block per column, one thread
// per g-point rounded up to whole warps, nf per-level fields of per-warp
// partial sums of type R in dynamic shared memory. Any ngpt: the idle
// threads of the last warp add zeros.
struct MegaLaunch {
  dim3 grid, block;
  size_t smem;
};

template <typename R = float>
inline MegaLaunch mega_launch(const Dims& d, int nf) {
  MegaLaunch m;
  const int threads = (d.ngpt + 31) / 32 * 32;
  m.grid = dim3((unsigned)d.ncol);
  m.block = dim3((unsigned)threads);
  m.smem = (size_t)nf * (d.nlay + 1) * (threads / 32) * sizeof(R);
  return m;
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace rrtmgp
