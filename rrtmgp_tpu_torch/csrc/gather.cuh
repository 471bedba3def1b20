// The gas-optics table gather of the kernels redesigned around it
// (optics_fused.cu, lw_clear_mega.cu, sw_clear_mega.cu, interp_pt_eta.cu,
// interp_minor.cu): a block stages the interpolation inputs of the cells it
// computes in shared memory once, with the table offsets already formed,
// and every thread, one per g-point, reads them from there. The arithmetic
// is common.cuh's (tau_major, tau_minor, tau_rayleigh, and interp_p_eta with
// the temperature blend for the Planck fraction, as lw2_mega forms it) in
// the same operation order, so the optics have the same bits; only where an
// operand comes from differs.
//
// Per staged (layer, column), StagedCol: the temperature and pressure
// weights with their complements, col_dry, the troposphere side and, SW,
// the Rayleigh column amount. Per staged (layer, column, band),
// StagedBand: the two 32-bit corner offsets of a (npress+1, ntemp, neta,
// ngpt) table, (jp, jt, je1) and (jp, jt+1, je2); the two kminor rows
// jt*neta+je1 and (jt+1)*neta+je2; SW the two Rayleigh corners (side, jt,
// je1) and (side, jt+1, je2); and the eta weights with their complements
// and the column mixing ratios. The other corners of a table are fixed
// strides (+ngpt for eta+1, +ntemp*neta*ngpt for p+1), so a point's
// sixteen gathers are one add each. 32-bit offsets need tables of fewer
// than 2^31 elements; the host checks (ops/_launch.py check_table_size).
//
// The megakernels (lw_clear_mega.cu, sw_clear_mega.cu) keep a block per
// column and stage its layers by chunks, double-buffered with asynchronous
// copies (cp_async, ChunkLayout); the tile kernels (optics_fused.cu,
// interp_pt_eta.cu, interp_minor.cu) stage a layer of a column tile.
#pragma once

#include "allsky.cuh"
#include "common.cuh"

namespace rrtmgp {

template <typename R>
struct StagedCol {
  R ft, omft, fp, omfp, col_dry, ray;
  int lower;
  int aero;  // the layer carries aerosol (lw_clear_mega)
};

template <typename R>
struct StagedBand {
  int b1, b2;  // kmajor-shaped table corners
  int m1, m2;  // kminor rows
  int r1, r2;  // Rayleigh table corners (SW)
  R fe1, omfe1, fe2, omfe2, cm1, cm2;
};

// A staged (layer, column) from its inputs.
template <typename R>
__device__ __forceinline__ void set_col(R ft, R fp, R col_dry, bool lower, StagedCol<R>& s) {
  s.ft = ft;
  s.omft = R(1) - ft;
  s.fp = fp;
  s.omfp = R(1) - fp;
  s.col_dry = col_dry;
  s.lower = lower;
}

// A staged (layer, column, band) from its inputs; SW adds the Rayleigh
// corners of the troposphere side.
template <typename R, bool SW>
__device__ __forceinline__ void set_band(const Dims& d, int jt, int jp, bool lower, int je1, int je2, R fe1, R fe2,
                                         R cm1, R cm2, StagedBand<R>& s) {
  s.b1 = ((jp * d.ntemp + jt) * d.neta + je1) * d.ngpt;
  s.b2 = ((jp * d.ntemp + jt + 1) * d.neta + je2) * d.ngpt;
  s.m1 = jt * d.neta + je1;
  s.m2 = (jt + 1) * d.neta + je2;
  if constexpr (SW) {
    const int side = lower ? 0 : 1;
    s.r1 = ((side * d.ntemp + jt) * d.neta + je1) * d.ngpt;
    s.r2 = ((side * d.ntemp + jt + 1) * d.neta + je2) * d.ngpt;
  }
  s.fe1 = fe1;
  s.omfe1 = R(1) - fe1;
  s.fe2 = fe2;
  s.omfe2 = R(1) - fe2;
  s.cm1 = cm1;
  s.cm2 = cm2;
}

// An asynchronous copy of N bytes (4, 8 or 16) from device to shared memory.
template <int N>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(gmem_src), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A byte of a (nlay, ncol) byte array through the aligned 4-byte word that
// holds it (cp.async copies 4, 8 or 16 bytes): the word lies in the
// tensor's allocation, which starts 4-byte aligned.
__device__ __forceinline__ const void* byte_word(const unsigned char* p) {
  return (const void*)((size_t)p & ~(size_t)3);
}

__device__ __forceinline__ int word_byte(unsigned w, const unsigned char* p) {
  return (int)((w >> (8 * ((size_t)p & 3))) & 0xffu);
}

// Shared memory of a megakernel block that stages its column by chunks of
// CHUNK layers (lw_clear_mega.cu: SW false; sw_clear_mega.cu: SW true), in
// bytes from the start: the in-block level sums (none when they go to
// device memory), 32 ints for the McICA cover count, two raw chunks (what
// cp.async copies: reals, then 4-byte words), one staged chunk (CHUNK
// StagedCol and CHUNK x nbnd StagedBand; LW then each (layer, band)'s cloud
// and aerosol absorption), and each interval's band and kminor base.
// Nothing grows with nlay. A raw chunk holds the gas-optics inputs both
// megakernels read (per layer ft, fp, col_dry; per (layer, band) fe1, fe2,
// cm1, cm2; per (interval, layer) the minor scalings; words: per layer jt,
// jp, per (layer, band) je1, je2, per layer the troposphere flag's word),
// then each kernel's own: SW the Rayleigh amount per layer, LW the band
// Planck values at the layer and its bottom level per (layer, band); with
// clouds and aerosols their tau and ssa (SW also g) per (layer, band), the
// aerosol flag's word and, in seed mode, the cloud fraction per layer. A
// field a variant does not read takes no room.
template <typename R, int CHUNK, bool SW, bool CLOUD, bool AERO, int MASK>
struct ChunkLayout {
  int ft, fp, cd, fe1, fe2, cm1, cm2, scal, ray, play, plev, ctau, cssa, cg, atau, assa, ag;  // in reals
  int n_reals;
  int jt, jp, je1, je2, lower, amask, cfrac;  // in words
  size_t raw_bytes, raw0, raw1, cols, bands, cabs, aabs, mband, stage_end;

  __host__ __device__ ChunkLayout(size_t sums_bytes, int nbnd, int n_minor) {
    const int C = CHUNK, CB = CHUNK * nbnd;
    int r = 0;
    ft = r; r += C;
    fp = r; r += C;
    cd = r; r += C;
    fe1 = r; r += CB;
    fe2 = r; r += CB;
    cm1 = r; r += CB;
    cm2 = r; r += CB;
    scal = r; r += n_minor * C;
    ray = r; r += SW ? C : 0;
    play = r; r += SW ? 0 : CB;
    plev = r; r += SW ? 0 : CB;
    ctau = r; r += CLOUD ? CB : 0;
    cssa = r; r += CLOUD ? CB : 0;
    cg = r; r += SW && CLOUD ? CB : 0;
    atau = r; r += AERO ? CB : 0;
    assa = r; r += AERO ? CB : 0;
    ag = r; r += SW && AERO ? CB : 0;
    n_reals = r;
    int w = 0;
    jt = w; w += C;
    jp = w; w += C;
    je1 = w; w += CB;
    je2 = w; w += CB;
    lower = w; w += C;
    amask = w; w += AERO ? C : 0;
    cfrac = w; w += MASK == MASK_SEED ? C : 0;
    raw_bytes = align16((size_t)r * sizeof(R) + (size_t)w * 4);
    raw0 = align16(sums_bytes + 32 * sizeof(int));
    raw1 = raw0 + raw_bytes;
    cols = raw1 + raw_bytes;
    bands = align16(cols + sizeof(StagedCol<R>) * C);
    cabs = bands + sizeof(StagedBand<R>) * CB;
    aabs = cabs + (!SW && CLOUD ? sizeof(R) * CB : 0);
    mband = align16(aabs + (!SW && AERO ? sizeof(R) * CB : 0));
    stage_end = mband + sizeof(int) * 2 * n_minor;
  }

  __host__ __device__ static size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }
};

// Shared memory of a block of the tile kernels that compute the minor
// gases (optics_fused.cu, interp_minor.cu): the staged bands and columns
// of the tile, the minor scalings, and each interval's band and kminor
// base.
template <typename R>
struct OpticsSmem {
  size_t bands, cols, scal, meta, total;
  __host__ __device__ OpticsSmem(int tile, int nbnd, int n_minor) {
    bands = 0;
    cols = bands + sizeof(StagedBand<R>) * tile * nbnd;
    scal = cols + sizeof(StagedCol<R>) * tile;
    meta = scal + sizeof(R) * n_minor * tile;
    total = meta + sizeof(int) * 2 * n_minor;
  }
};

// Stages the minor scalings of the tile's nc columns from (layer, column)
// offset lc0 (stride `tile` between intervals) and each interval's band and
// kminor base; the block's threads share the work.
template <typename R>
__device__ __forceinline__ void stage_minor(const R* minor_scaling, const int* minor_band, const int* minor_kbase,
                                            size_t plane, size_t lc0, int nc, int tile, int n_minor, R* scal,
                                            int* mband, int* mkbase) {
  for (int e = threadIdx.x; e < n_minor * nc; e += blockDim.x) {
    const int i = e / nc;
    scal[i * tile + (e - i * nc)] = __ldg(minor_scaling + i * plane + lc0 + (e - i * nc));
  }
  for (int i = threadIdx.x; i < n_minor; i += blockDim.x) {
    mband[i] = __ldg(minor_band + i);
    mkbase[i] = __ldg(minor_kbase + i);
  }
}

// A thread's per-g-point metadata, read once: its band and, per
// troposphere side, its range of minor_list.
struct GptMeta {
  int band, k0[2], k1[2];
};

__device__ __forceinline__ GptMeta gpt_meta(const int* gpt2band, const int* minor_start, int ngpt, int g) {
  GptMeta m;
  m.band = __ldg(gpt2band + g);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    m.k0[side] = __ldg(minor_start + side * (ngpt + 1) + g);
    m.k1[side] = __ldg(minor_start + side * (ngpt + 1) + g + 1);
  }
  return m;
}

// interp_p_eta of common.cuh from staged offsets: v0 at (jp, jt, je1), v1 at
// (jp, jt+1, je2), each blended in p then eta.
template <typename R>
__device__ __forceinline__ void staged_p_eta(const R* t, int sp, int se, const StagedCol<R>& c,
                                             const StagedBand<R>& b, R& v0, R& v1) {
  const R* p1 = t + b.b1;
  const R* p2 = t + b.b2;
  R a = c.omfp * __ldg(p1) + c.fp * __ldg(p1 + sp);
  R bb = c.omfp * __ldg(p1 + se) + c.fp * __ldg(p1 + se + sp);
  v0 = a * b.omfe1 + bb * b.fe1;
  a = c.omfp * __ldg(p2) + c.fp * __ldg(p2 + sp);
  bb = c.omfp * __ldg(p2 + se) + c.fp * __ldg(p2 + se + sp);
  v1 = a * b.omfe2 + bb * b.fe2;
}

// staged_p_eta for a table of npress slabs whose node above the cell's may
// lie past the last slab (interp_pt_eta.cu: the Rayleigh table read at side
// 1 with fpress = 0): without `above` the upper node is not read and
// enters as fp * 0.
template <typename R>
__device__ __forceinline__ void staged_p_eta_bounded(const R* t, int sp, int se, const StagedCol<R>& c,
                                                     const StagedBand<R>& b, bool above, R& v0, R& v1) {
  const R* p1 = t + b.b1;
  const R* p2 = t + b.b2;
  R a = c.omfp * __ldg(p1) + c.fp * (above ? __ldg(p1 + sp) : R(0));
  R bb = c.omfp * __ldg(p1 + se) + c.fp * (above ? __ldg(p1 + se + sp) : R(0));
  v0 = a * b.omfe1 + bb * b.fe1;
  a = c.omfp * __ldg(p2) + c.fp * (above ? __ldg(p2 + sp) : R(0));
  bb = c.omfp * __ldg(p2 + se) + c.fp * (above ? __ldg(p2 + se + sp) : R(0));
  v1 = a * b.omfe2 + bb * b.fe2;
}

// tau_major of common.cuh; `t` is kmajor advanced to the thread's g-point.
template <typename R>
__device__ __forceinline__ R staged_tau_major(const R* t, int sp, int se, const StagedCol<R>& c,
                                              const StagedBand<R>& b) {
  R v0, v1;
  staged_p_eta(t, sp, se, c, b, v0, v1);
  return (c.omft * (v0 * b.cm1) + c.ft * (v1 * b.cm2)) * c.col_dry;
}

// The Planck fraction: interp_p_eta of the Planck-fraction table `t` (at
// the thread's g-point), blended in temperature.
template <typename R>
__device__ __forceinline__ R staged_planck_fraction(const R* t, int sp, int se, const StagedCol<R>& c,
                                                    const StagedBand<R>& b) {
  R v0, v1;
  staged_p_eta(t, sp, se, c, b, v0, v1);
  return c.omft * v0 + c.ft * v1;
}

// tau_rayleigh of common.cuh; `t` the Rayleigh table at the thread's
// g-point.
template <typename R>
__device__ __forceinline__ R staged_tau_rayleigh(const R* t, int se, const StagedCol<R>& c, const StagedBand<R>& b) {
  const R r0 = __ldg(t + b.r1) * b.omfe1 + __ldg(t + b.r1 + se) * b.fe1;
  const R r1 = __ldg(t + b.r2) * b.omfe2 + __ldg(t + b.r2 + se) * b.fe2;
  return (c.omft * r0 + c.ft * r1) * c.ray;
}

// tau_minor of common.cuh: the intervals of the cell's side that cover the
// thread's g-point. `bands` are the cell's staged bands, `scaling` its
// staged minor scalings (stride `sstride` between intervals), `kminor` the
// table at the thread's g-point; each interval's band and kminor base come
// from shared memory (mband, mkbase).
template <typename R>
__device__ __forceinline__ R staged_tau_minor(const R* kminor, const int* minor_list, int ncontrib, const GptMeta& m,
                                              const StagedCol<R>& c, const StagedBand<R>* bands, const R* scaling,
                                              int sstride, const int* mband, const int* mkbase) {
  const int side = c.lower ? 0 : 1;
  R tau = R(0);
  for (int k = m.k0[side], k1 = m.k1[side]; k < k1; ++k) {
    const int i = __ldg(minor_list + k);
    const R s = scaling[i * sstride];
    const StagedBand<R>& b = bands[mband[i]];
    const R* k0 = kminor + mkbase[i];
    const R v1 = b.omfe1 * __ldg(k0 + b.m1 * ncontrib) + b.fe1 * __ldg(k0 + (b.m1 + 1) * ncontrib);
    const R v2 = b.omfe2 * __ldg(k0 + b.m2 * ncontrib) + b.fe2 * __ldg(k0 + (b.m2 + 1) * ncontrib);
    tau += (c.omft * v1 + c.ft * v2) * s;
  }
  return tau;
}

}  // namespace rrtmgp
