// Device helpers shared by the megakernels (lw_clear_mega.cu,
// sw_clear_mega.cu, lw2_mega.cu) and the kernels of the two-kernel path
// (optics_fused.cu, interp_pt_eta.cu, interp_minor.cu, lw_noscat_banded.cu,
// sw_2stream_reduced.cu): the per-(layer, column) gas-optics inputs, table
// interpolation for one g-point (sw_clear_mega, lw2_mega; lw_clear_mega,
// optics_fused, interp_pt_eta and interp_minor stage it, gather.cuh), the
// Clough source factor, deterministic per-level g-point sums in a block or
// across the blocks of a column, and the launch shapes.
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
#include <initializer_list>
#include <type_traits>
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

  // this lane's value v as its warp's partial of field f at level lev
  __device__ __forceinline__ void put(int f, int lev, R v) const {
    smem[((size_t)f * nlev + lev) * nwarps + (threadIdx.x >> 5)] = v;
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

// The same sums when a column's g-points span several blocks (grid (ncol,
// groups), from the host's launch plan): each warp's partial goes to its
// slot of a device buffer [nf][nlev][ncol][column's warps], and
// finish_level_sums adds a column's slots in warp order after the kernel.
// Warp w of a column holds g-points 32w..32w+31 either way and the warps are
// added in the order 0, 1, ..., so the sums have the bits of LevelSumsT.
template <typename R>
struct LevelPartialsT {
  R* part;
  int nlev;

  __device__ __forceinline__ void add(int f, int lev, R v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) {
      const size_t col_warps = (size_t)gridDim.y * (blockDim.x >> 5);
      part[(((size_t)f * nlev + lev) * gridDim.x + blockIdx.x) * col_warps + blockIdx.y * (blockDim.x >> 5) +
           (threadIdx.x >> 5)] = v;
    }
  }

  __device__ __forceinline__ void put(int f, int lev, R v) const {
    const size_t col_warps = (size_t)gridDim.y * (blockDim.x >> 5);
    part[(((size_t)f * nlev + lev) * gridDim.x + blockIdx.x) * col_warps + blockIdx.y * (blockDim.x >> 5) +
         (threadIdx.x >> 5)] = v;
  }
};

// K level sums at once, v[k] of field f0 + k * fstride at level lev (K <=
// 4), by a transposed warp reduction: over lane bit 4 each half of the
// warp keeps half the fields and swaps the other half with its partner
// lane (one shuffle per field kept), for K > 2 the same over bit 3, then a
// butterfly over the remaining bits; field k's warp total ends in the
// lanes of its group, whose first lane stores it. Each total is add()'s
// sum tree (lanes combined over bit 4, then 3, 2, 1, 0; float addition
// commutes), so the sums have add()'s bits with 5 or 6 shuffles in place
// of 5 K. K = 1 is add().
template <int K, typename S, typename R>
__device__ __forceinline__ void add_fields(const S& sums, int f0, int fstride, int lev, const R (&v)[K]) {
  static_assert(K >= 1 && K <= 4, "add_fields takes 1 to 4 fields");
  if constexpr (K == 1) {
    sums.add(f0, lev, v[0]);
  } else {
    constexpr int P = K <= 2 ? 2 : 4;  // the fields, padded to a power of two
    const int lane = threadIdx.x & 31;
    R a[P];
#pragma unroll
    for (int k = 0; k < P; ++k) a[k] = k < K ? v[k] : R(0);
    {  // over bit 4: the lower half keeps fields [0, P/2), the upper [P/2, P)
      const bool upper = (lane & 16) != 0;
#pragma unroll
      for (int j = 0; j < P / 2; ++j) {
        const R send = upper ? a[j] : a[j + P / 2];
        const R keep = upper ? a[j + P / 2] : a[j];
        a[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
    }
    if constexpr (P == 4) {  // over bit 3: each quarter keeps one of its half's two fields
      const bool upper = (lane & 8) != 0;
      const R send = upper ? a[0] : a[1];
      const R keep = upper ? a[1] : a[0];
      a[0] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
    for (int bit = 16 / P; bit > 0; bit >>= 1) a[0] += __shfl_xor_sync(0xffffffffu, a[0], bit);
    const int k = P == 2 ? lane >> 4 : ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1);
    if ((lane & (32 / P - 1)) == 0 && k < K) sums.put(f0 + k * fstride, lev, a[0]);
  }
}

// The sums of a kernel that runs in-block (SPLIT false: one block per
// column, shared memory `smem`) or across blocks (SPLIT true: `partials`).
template <typename R, bool SPLIT>
using SumsOf = typename std::conditional<SPLIT, LevelPartialsT<R>, LevelSumsT<R>>::type;

template <typename R, bool SPLIT>
__device__ __forceinline__ SumsOf<R, SPLIT> level_sums(R* smem, R* partials, int nlev) {
  if constexpr (SPLIT) {
    return LevelPartialsT<R>{partials, nlev};
  } else {
    return LevelSumsT<R>{smem, nlev, (int)(blockDim.x >> 5)};
  }
}

// This thread's g-point: one block per column, or a column over gridDim.y
// blocks.
template <bool SPLIT>
__device__ __forceinline__ int gpoint() {
  return SPLIT ? (int)(blockIdx.y * blockDim.x + threadIdx.x) : (int)threadIdx.x;
}

// What finish_level_sums writes, per (level, column): each field's total
// (SUMS_PLAIN), times `scale` (SUMS_SCALED), or the SW fluxes from the
// SW_UP / SW_DN_DIF / SW_DIR totals (SUMS_SW: up, diffuse + direct down,
// direct), each as the in-block epilogue of the kernels writes it.
enum SumsEpilogue { SUMS_PLAIN = 0, SUMS_SCALED = 1, SUMS_SW = 2 };

// Completes the partials of nf <= 3 fields, [nf][nlev][ncol][nw], in warp
// order into out[f] (nlev, ncol); with `cover`, also the McICA cloud cover
// of each column from its blocks' counts cover_part (ncol, n_groups),
// integers added in any order.
template <typename R>
__global__ void finish_level_sums(const R* __restrict__ part, int nf, int nlev, int ncol, int nw, int epi, R scale,
                                  R* __restrict__ out0, R* __restrict__ out1, R* __restrict__ out2,
                                  const int* __restrict__ cover_part, int n_groups, int ngpt,
                                  float* __restrict__ cover) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)nlev * ncol) return;
  const int lev = (int)(idx / ncol), col = (int)(idx - (size_t)lev * ncol);
  auto total = [&](int f) {
    const R* p = part + (((size_t)f * nlev + lev) * ncol + col) * nw;
    R s = R(0);
    for (int w = 0; w < nw; ++w) s += p[w];
    return s;
  };
  if (epi == SUMS_SW) {
    const R dir = total(2);
    out0[idx] = total(0);
    out1[idx] = total(1) + dir;
    out2[idx] = dir;
  } else {
    R* out[3] = {out0, out1, out2};
    for (int f = 0; f < nf; ++f) out[f][idx] = epi == SUMS_SCALED ? total(f) * scale : total(f);
  }
  if (cover != nullptr && lev == 0) {
    int n = 0;
    for (int b = 0; b < n_groups; ++b) n += cover_part[(size_t)col * n_groups + b];
    cover[col] = (float)n / (float)ngpt;
  }
}

template <typename R>
inline cudaError_t finish_sums(cudaStream_t stream, const R* part, int nf, int nlev, int ncol, int nw, int epi,
                               R scale, R* out0, R* out1, R* out2, const int* cover_part = nullptr,
                               int n_groups = 0, int ngpt = 0, float* cover = nullptr) {
  const size_t n = (size_t)nlev * ncol;
  if (n == 0) return cudaGetLastError();
  const int threads = 256;
  finish_level_sums<R><<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, nf, nlev, ncol, nw, epi, scale, out0, out1, out2, cover_part, n_groups, ngpt, cover);
  return cudaGetLastError();
}

// The most quadrature angles one launch of the LW no-scattering sweeps
// takes (lw_noscat_banded.cu, lw_noscat_sources.cu).
constexpr int MAX_ANGLES = 4;

// The quadrature of one launch: each angle's secant and pi x weight.
template <typename R>
struct AnglesT {
  R ds[MAX_ANGLES], i2f[MAX_ANGLES];
};

// The quadrature from host arrays of nang floats, secants and pi x weights;
// false unless 1 <= nang <= MAX_ANGLES.
inline bool host_angles(int nang, const void* ds, const void* i2f, AnglesT<float>& ang) {
  if (nang < 1 || nang > MAX_ANGLES) return false;
  ang = AnglesT<float>{};
  for (int k = 0; k < nang; ++k) {
    ang.ds[k] = ((const float*)ds)[k];
    ang.i2f[k] = ((const float*)i2f)[k];
  }
  return true;
}

// Completes the device partials of a launch over nang angles, (2 nang,
// nlev, ncol, nw): angle k's up and down fields (2k, 2k + 1) into its
// (nlev, ncol) slab of flux_up and flux_dn, scaled by its pi x weight, one
// finish_level_sums per angle.
inline cudaError_t finish_angle_sums(cudaStream_t stream, const float* partials, int nang, int nlev, int ncol, int nw,
                                     const AnglesT<float>& ang, float* flux_up, float* flux_dn) {
  const size_t field = (size_t)nlev * ncol * nw, level_plane = (size_t)nlev * ncol;
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < nang && err == cudaSuccess; ++k) {
    err = finish_sums<float>(stream, partials + 2 * k * field, 2, nlev, ncol, nw, SUMS_SCALED, ang.i2f[k],
                             flux_up + k * level_plane, flux_dn + k * level_plane, nullptr);
  }
  return err;
}

// Launch shape shared by the megakernels: one block per column, one thread
// per g-point rounded up to whole warps, nf per-level fields of per-warp
// partial sums of type R in dynamic shared memory. Any ngpt up to 1024: the
// idle threads of the last warp add zeros.
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

// Shared memory of a block of `group` threads that keeps `n` levels or
// layers of two reals a thread (the per-g-point sweeps' bottom state:
// sw_2stream_gpt's albedo and source, lw_noscat_gpt's transmittance and
// upward source; ops/rte_kernels.py BOTTOM_STATE_BYTES a level and thread).
template <typename R>
inline size_t bottom_state_bytes(int n, int group) { return 2 * sizeof(R) * (size_t)n * group; }

// The launch of the host's plan (ops/_launch.py gpoint_plan): with the sums
// in the block (one group), mega_launch; else a column's g-points over
// n_groups blocks of `group` threads (whole warps), grid (ncol, n_groups),
// g = blockIdx.y * group + threadIdx.x, the level sums in device memory.
// `smem` is added to what the in-block sums take.
template <typename R = float>
inline MegaLaunch group_launch(const Dims& d, int nf, int group, int n_groups, bool in_block, size_t smem = 0) {
  if (in_block) {
    MegaLaunch m = mega_launch<R>(d, nf);
    m.smem += smem;
    return m;
  }
  MegaLaunch m;
  m.grid = dim3((unsigned)d.ncol, (unsigned)n_groups);
  m.block = dim3((unsigned)group);
  m.smem = smem;
  return m;
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The most threads a block of each of `kernels` may have on the current
// device (cudaFuncAttributes.maxThreadsPerBlock: the device's limit, or
// fewer where a kernel's registers do not fit more), the smallest of them:
// the host plans a launch that may run either variant of a kernel (its
// level sums in the block or split) with this (ops/_launch.py gpoint_plan).
template <typename... K>
inline cudaError_t max_threads(int* threads, K... kernels) {
  int least = 1 << 30;
  for (const void* k : {(const void*)kernels...}) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, k);
    if (err != cudaSuccess) return err;
    least = a.maxThreadsPerBlock < least ? a.maxThreadsPerBlock : least;
  }
  *threads = least;
  return cudaSuccess;
}

}  // namespace rrtmgp
