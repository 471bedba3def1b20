// LW two-stream sweep from materialized optics and level sources: fluxes
// summed over g-points.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _lw_2stream_reduced_kernel (wrapper
//   lw_2stream_pallas_reduced): from tau, ssa, g per (layer, column, g-point)
//   and the level Planck sources per (level, column, g-point), the
//   Meador-Weaver diffuse reflectance and transmittance, the Toon
//   linear-in-tau layer sources, the Shonk-Hogan adding recurrence from the
//   surface, the diffuse flux from the top, and the g-point sums of up and
//   down flux at every level.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points tau, ssa and g are 3 x 2.01 GB, the level sources 2.05 GB, the
//   outputs 16 MB: 8.1 GB, 2.4 ms at 3.35 TB/s. The design below reads the
//   four inputs twice and writes and reads (alb, src) checkpoints every
//   LW2_CHUNK levels: 16 + 16 + 16 / LW2_CHUNK bytes a point, 34 at chunks
//   of 8 (17.1 GB, 5.1 ms at 3.35 TB/s), against the 48 of storing the
//   albedo and source of every layer (24.2 GB). Four exp, two sqrt and five
//   divides per point (the coefficients twice), as before: at ~200
//   instructions a point the issue rate bounds it near the bytes.
//
// Design: one block per column, one thread per g-point (past the kernel's
//   block limit, a column over several blocks, the sums completed by
//   finish_level_sums), the LW two-stream megakernel's recurrence
//   (lw2_mega.cu), kept a chunk of LW2_CHUNK layers at a time. The TPU
//   kernel keeps a column block's coefficients and adding state in VMEM and
//   reads its inputs once; a 60 x 256 column of that state (307 KB) is more
//   than a block's shared memory, so here the state is checkpointed and
//   replayed. The bottom-up pass computes each layer's coefficients and
//   carries the adding recurrence in registers, storing (alb, src) only at
//   the bottom level of each chunk, the checkpoints, in device memory
//   (ceil(nlay / LW2_CHUNK) levels). The top-down pass walks the chunks from
//   the top: it replays a chunk's bottom-up recurrence from its checkpoint,
//   the same expressions in the same order, keeping per layer alb, src, td
//   = Tdif * denom and sc = denom * (Rdif * src + src_dn) in the block's
//   shared memory (4 x LW2_CHUNK words a thread, Lw2Chunk), then runs the
//   chunk's flux recurrence from there, folded as the megakernel folds it.
//   The top chunk is the one the bottom-up pass ends on: it is not replayed.
//   So every output has the bits of storing every layer's albedo and
//   source, and of the megakernel route on equal optics and sources. Kept
//   in registers, the chunk state (unrolled, 64-80 registers a thread, 24
//   warps an SM) made the kernel slower than storing every layer's albedo
//   and source at 40 registers; in shared memory it runs at 40 registers,
//   its loop not unrolled, each layer's inputs read a layer ahead as K15
//   reads them (PERF.md, PR 12). The coefficient function is
//   lw_twostream.cuh's. The emissivity is band-valued, (nbnd, ncol), read
//   through gpt2band, as the solves hold it; the surface source is per
//   g-point. Level sums are deterministic per-warp partials (common.cuh).
//   The real type is a template parameter (the entry point builds f32).
//   Nothing of the TPU kernel's structure is kept: no DMA ring, no column
//   blocks, no lane or column padding.
#include "common.cuh"
#include "lw_twostream.cuh"

namespace rrtmgp {

// Layers of one chunk: the checkpoint spacing and the depth of the state the
// top-down pass keeps in shared memory (ops/rte_kernels.py LW2_CHUNK).
constexpr int LW2_CHUNK = 8;

// The checkpoint levels of a column of nlay layers.
__host__ __device__ inline int lw2_checkpoints(int nlay) { return (nlay + LW2_CHUNK - 1) / LW2_CHUNK; }

// Shared memory of a block of `group` threads besides its level sums: each
// thread's chunk state (ops/rte_kernels.py LW2_STATE_BYTES a thread).
inline size_t lw2_chunk_bytes(int group) { return sizeof(float) * 4 * LW2_CHUNK * (size_t)group; }

// A thread's chunk state in shared memory, [4][LW2_CHUNK][blockDim.x]: per
// layer j of the chunk its albedo and source below it (q = 0, 1) and the
// flux pass's folded factors td and sc (q = 2, 3).
template <typename R>
struct Lw2Chunk {
  R* p;  // this thread's slot of q = 0, j = 0

  __device__ __forceinline__ R& at(int q, int j) const { return p[(size_t)(q * LW2_CHUNK + j) * blockDim.x]; }
};

// Chunk k's bottom-up recurrence from (alb, src) at its bottom level: each
// layer's coefficients from the inputs, its albedo and source below it and
// the flux pass's folded factors to `c`; leaves (alb, src) at the chunk's
// top. The input pointers are this thread's (col, g) of level 0; the lower
// level source of a layer is the upper one of the layer below, and each
// layer's inputs are read while the layer below is computed.
template <typename R>
__device__ __forceinline__ void lw2_chunk_up(int k, int nlay, size_t stride, const R* __restrict__ tau,
                                             const R* __restrict__ ssa, const R* __restrict__ gasym,
                                             const R* __restrict__ lev_source, R& alb, R& src,
                                             const Lw2Chunk<R>& c) {
  const R one = R(1);
  const int l0 = k * LW2_CHUNK, n = min(LW2_CHUNK, nlay - l0);
  size_t s = (size_t)l0 * stride;
  R lev_bot = __ldg(lev_source + s);
  R t_next = __ldg(tau + s), w_next = __ldg(ssa + s), g_next = __ldg(gasym + s);
  R top_next = __ldg(lev_source + s + stride);
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const R t = t_next, w = w_next, gg = g_next, lev_top = top_next;
    if (j + 1 < n) {
      s += stride;
      t_next = __ldg(tau + s);
      w_next = __ldg(ssa + s);
      g_next = __ldg(gasym + s);
      top_next = __ldg(lev_source + s + stride);
    }
    R Rdif, Tdif, src_up, src_dn;
    lw2_coeffs(t, w, gg, lev_bot, lev_top, Rdif, Tdif, src_up, src_dn);
    const R denom = one / (one - Rdif * alb);
    c.at(0, j) = alb;
    c.at(1, j) = src;
    c.at(2, j) = Tdif * denom;
    c.at(3, j) = denom * (Rdif * src + src_dn);
    const R alb_n = Rdif + Tdif * Tdif * alb * denom;
    const R src_n = src_up + Tdif * denom * (src + alb * src_dn);
    alb = alb_n;
    src = src_n;
    lev_bot = lev_top;
  }
}

template <typename R, bool SPLIT>
__global__ void lw_2stream_reduced_kernel(const R* __restrict__ tau,         // (nlay, ncol, ngpt)
                                          const R* __restrict__ ssa,         // (nlay, ncol, ngpt)
                                          const R* __restrict__ gasym,       // (nlay, ncol, ngpt)
                                          const R* __restrict__ lev_source,  // (nlev, ncol, ngpt)
                                          const R* __restrict__ sfc_source,  // (ncol, ngpt)
                                          const R* __restrict__ sfc_emis,    // (nbnd, ncol)
                                          const int* __restrict__ gpt2band,  // (ngpt,)
                                          const R* __restrict__ inc_flux,    // (ncol, ngpt) or null
                                          R* __restrict__ s_alb,             // 2 x (checkpoints, ncol, ngpt)
                                          R* __restrict__ s_src,
                                          R* __restrict__ flux_up,           // (nlev, ncol)
                                          R* __restrict__ flux_dn,
                                          R* __restrict__ partials,          // (2, nlev, ncol, column's warps) or null
                                          int nlay, int ncol, int ngpt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < ngpt;
  const int nlev = nlay + 1;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlev);
  const size_t stride = (size_t)ncol * ngpt, g0 = (size_t)col * ngpt + g;
  const R one = R(1), pi = R(3.14159265358979323846);
  const int nchunk = lw2_checkpoints(nlay);
  enum { UP = 0, DN = 1 };

  // bottom-up: the adding recurrence in registers, (alb, src) at each
  // chunk's bottom to the checkpoints; the top chunk's state stays in c
  const Lw2Chunk<R> c{reinterpret_cast<R*>(smem_raw) + (SPLIT ? 0 : 2 * (size_t)nlev * (blockDim.x >> 5)) +
                      threadIdx.x};
  R alb = R(0), src = R(0);
  if (active) {
    const R emis = __ldg(sfc_emis + (size_t)__ldg(gpt2band + g) * ncol + col);
    alb = one - emis;
    src = pi * emis * __ldg(sfc_source + g0);
    for (int k = 0; k < nchunk; ++k) {
      s_alb[(size_t)k * stride + g0] = alb;
      s_src[(size_t)k * stride + g0] = src;
      lw2_chunk_up(k, nlay, stride, tau + g0, ssa + g0, gasym + g0, lev_source + g0, alb, src, c);
    }
  }

  // top-down diffuse flux, a chunk at a time: replay the chunk's adding
  // state from its checkpoint (the top chunk's is in c already), then fold
  // the flux through it
  R fd = (active && inc_flux != nullptr) ? inc_flux[g0] : R(0);
  sums.add(UP, nlay, active ? alb * fd + src : R(0));
  sums.add(DN, nlay, fd);
  for (int k = nchunk - 1; k >= 0; --k) {
    if (active && k < nchunk - 1) {
      R a = s_alb[(size_t)k * stride + g0], r = s_src[(size_t)k * stride + g0];
      lw2_chunk_up(k, nlay, stride, tau + g0, ssa + g0, gasym + g0, lev_source + g0, a, r, c);
    }
#pragma unroll 1
    for (int j = min(LW2_CHUNK, nlay - k * LW2_CHUNK) - 1; j >= 0; --j) {
      R up = R(0);
      if (active) {
        fd = c.at(2, j) * fd + c.at(3, j);
        up = c.at(0, j) * fd + c.at(1, j);
      }
      sums.add(UP, k * LW2_CHUNK + j, up);
      sums.add(DN, k * LW2_CHUNK + j, fd);
    }
  }

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev < nlev; lev += blockDim.x) {
      flux_up[(size_t)lev * ncol + col] = sums.total(UP, lev);
      flux_dn[(size_t)lev * ncol + col] = sums.total(DN, lev);
    }
  }
}

}  // namespace rrtmgp

// f32; inc_flux null = no incident flux. s_alb, s_src: the checkpoints,
// (n_checkpoints, ncol, ngpt) each, n_checkpoints at least ceil(nlay /
// LW2_CHUNK) (else cudaErrorInvalidValue). group, n_groups, in_block: the
// host's launch plan, which counts the chunk state (lw2_chunk_bytes)
// besides the level sums; partials (2, nlev, ncol, column's warps) unless
// in_block, else null.
extern "C" int rrtmgp_lw_2stream_reduced(const void* tau, const void* ssa, const void* gasym,
                                         const void* lev_source, const void* sfc_source, const void* sfc_emis,
                                         const void* gpt2band, const void* inc_flux, void* s_alb, void* s_src,
                                         void* flux_up, void* flux_dn, void* partials, int nlay, int ncol, int ngpt,
                                         int nbnd, int n_checkpoints, int group, int n_groups, int in_block,
                                         void* stream) {
  using namespace rrtmgp;
  if (n_checkpoints < lw2_checkpoints(nlay)) return (int)cudaErrorInvalidValue;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  const MegaLaunch m = group_launch<float>(d, 2, group, n_groups, in_block, lw2_chunk_bytes(group));
  const cudaStream_t s = (cudaStream_t)stream;
  auto kernel = in_block ? lw_2stream_reduced_kernel<float, false> : lw_2stream_reduced_kernel<float, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<m.grid, m.block, m.smem, s>>>(
      (const float*)tau, (const float*)ssa, (const float*)gasym, (const float*)lev_source,
      (const float*)sfc_source, (const float*)sfc_emis, (const int*)gpt2band, (const float*)inc_flux,
      (float*)s_alb, (float*)s_src, (float*)flux_up, (float*)flux_dn, in_block ? nullptr : (float*)partials, nlay,
      ncol, ngpt);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return (int)err;
  return (int)finish_sums<float>(s, (const float*)partials, 2, nlay + 1, ncol, n_groups * group / 32, SUMS_PLAIN,
                                 1.f, (float*)flux_up, (float*)flux_dn, nullptr);
}

namespace rrtmgp {

// The most threads a block of lw_2stream_reduced may have, both level-sum
// variants (errors.cu rrtmgp_max_threads); variant is 0.
cudaError_t lw_2stream_reduced_max_threads(int, int* threads) {
  return max_threads(threads, lw_2stream_reduced_kernel<float, false>, lw_2stream_reduced_kernel<float, true>);
}

}  // namespace rrtmgp
