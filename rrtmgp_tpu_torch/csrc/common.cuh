// Device helpers shared by the clear-sky megakernels (lw_clear_mega.cu,
// sw_clear_mega.cu): the per-(layer, column) gas-optics inputs, table
// interpolation for one g-point, and deterministic per-level g-point sums.
//
// Layouts (all f32 unless noted, C order):
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

// Gas-optics inputs of one solve (ops/mega_inputs.py MegaInputs).
struct OpticsIn {
  const int* jtemp;
  const float* ftemp;
  const int* jpress;
  const float* fpress;
  const unsigned char* tropo_lower;
  const float* col_dry;
  const int* jeta1;
  const float* feta1;
  const float* cmix1;
  const int* jeta2;
  const float* feta2;
  const float* cmix2;
  const float* minor_scaling;
  const float* ray_factor;  // SW only
};

// One lookup's tables (ops/mega_inputs.py KernelTables).
struct Tables {
  const float* kmajor;
  const float* second;  // planck fraction (LW) or rayleigh (SW)
  const float* kminor;
  const int* gpt2band;
  const int* minor_start;  // (2, ngpt+1)
  const int* minor_list;
  const int* minor_kbase;
  const int* minor_band;
};

struct Dims {
  int nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib;
};

// Interpolation state of one (layer, column) for the band of one g-point.
struct Cell {
  size_t lc;  // layer * ncol + column
  int jt, jp, je1, je2;
  float ft, fp, fe1, fe2, cm1, cm2, col_dry;
  bool lower;
};

__device__ __forceinline__ Cell load_cell(const OpticsIn& in, const Dims& d, int l, int col, int band) {
  Cell c;
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
__device__ __forceinline__ float tab(const float* t, const Dims& d, int p, int it, int e, int g) {
  return __ldg(t + (((size_t)p * d.ntemp + it) * d.neta + e) * d.ngpt + g);
}

// Pressure/eta interpolation of a (npress+1, ntemp, neta, ngpt) table at the
// two temperature nodes of a cell: v0 at jtemp (eta data 1), v1 at jtemp+1
// (eta data 2). The temperature blend is left to the caller.
__device__ __forceinline__ void interp_p_eta(const float* t, const Dims& d, const Cell& c, int g,
                                             float& v0, float& v1) {
  const float omfp = 1.f - c.fp;
  float a = omfp * tab(t, d, c.jp, c.jt, c.je1, g) + c.fp * tab(t, d, c.jp + 1, c.jt, c.je1, g);
  float b = omfp * tab(t, d, c.jp, c.jt, c.je1 + 1, g) + c.fp * tab(t, d, c.jp + 1, c.jt, c.je1 + 1, g);
  v0 = a * (1.f - c.fe1) + b * c.fe1;
  a = omfp * tab(t, d, c.jp, c.jt + 1, c.je2, g) + c.fp * tab(t, d, c.jp + 1, c.jt + 1, c.je2, g);
  b = omfp * tab(t, d, c.jp, c.jt + 1, c.je2 + 1, g) + c.fp * tab(t, d, c.jp + 1, c.jt + 1, c.je2 + 1, g);
  v1 = a * (1.f - c.fe2) + b * c.fe2;
}

// Major-species optical depth of g-point g (before the minor gases).
__device__ __forceinline__ float tau_major(const Tables& tb, const Dims& d, const Cell& c, int g) {
  float v0, v1;
  interp_p_eta(tb.kmajor, d, c, g, v0, v1);
  return ((1.f - c.ft) * (v0 * c.cm1) + c.ft * (v1 * c.cm2)) * c.col_dry;
}

// Minor-gas optical depth of g-point g: the intervals of the cell's
// troposphere side that cover g (the other side's scalings are zero).
__device__ __forceinline__ float tau_minor(const OpticsIn& in, const Tables& tb, const Dims& d,
                                           const Cell& c, int g) {
  const int side = c.lower ? 0 : 1;
  const int* start = tb.minor_start + side * (d.ngpt + 1);
  const size_t plane = (size_t)d.nlay * d.ncol;
  float tau = 0.f;
  for (int k = __ldg(start + g), k1 = __ldg(start + g + 1); k < k1; ++k) {
    const int i = __ldg(tb.minor_list + k);
    const float s = __ldg(in.minor_scaling + (size_t)i * plane + c.lc);
    const size_t lcb = c.lc * d.nbnd + __ldg(tb.minor_band + i);
    const int je1 = __ldg(in.jeta1 + lcb), je2 = __ldg(in.jeta2 + lcb);
    const float fe1 = __ldg(in.feta1 + lcb), fe2 = __ldg(in.feta2 + lcb);
    const float* k0 = tb.kminor + __ldg(tb.minor_kbase + i) + g;
    const size_t nc = d.ncontrib;
    const size_t r1 = (size_t)c.jt * d.neta, r2 = (size_t)(c.jt + 1) * d.neta;
    const float v1 = (1.f - fe1) * __ldg(k0 + (r1 + je1) * nc) + fe1 * __ldg(k0 + (r1 + je1 + 1) * nc);
    const float v2 = (1.f - fe2) * __ldg(k0 + (r2 + je2) * nc) + fe2 * __ldg(k0 + (r2 + je2 + 1) * nc);
    tau += ((1.f - c.ft) * v1 + c.ft * v2) * s;
  }
  return tau;
}

// Per-level g-point sums for one column (one block). Each warp reduces with
// shuffles and its lane 0 writes the warp's partial into its own shared
// slot; finish() adds the warps in a fixed order. No atomics, so the sums
// are the same on every run.
struct LevelSums {
  float* smem;  // [nf][nlev][nwarps]
  int nlev, nwarps;

  __device__ __forceinline__ void add(int f, int lev, float v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) smem[((size_t)f * nlev + lev) * nwarps + (threadIdx.x >> 5)] = v;
  }

  // sum of field f at level lev, after a __syncthreads()
  __device__ __forceinline__ float total(int f, int lev) const {
    const float* p = smem + ((size_t)f * nlev + lev) * nwarps;
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += p[w];
    return s;
  }
};

// Launch shape shared by the megakernels: one block per column, one thread
// per g-point rounded up to whole warps, nf per-level fields of per-warp
// partial sums in dynamic shared memory.
struct MegaLaunch {
  dim3 grid, block;
  size_t smem;
};

inline MegaLaunch mega_launch(const Dims& d, int nf) {
  MegaLaunch m;
  const int threads = (d.ngpt + 31) / 32 * 32;
  m.grid = dim3((unsigned)d.ncol);
  m.block = dim3((unsigned)threads);
  m.smem = (size_t)nf * (d.nlay + 1) * (threads / 32) * sizeof(float);
  return m;
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace rrtmgp
