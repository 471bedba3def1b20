// McICA cloud-mask sampling on the device: the threefry-2x32 stream of the
// JAX package's off-TPU sampler (rrtmgp_tpu/ops/cloud_optics.py
// build_cloud_mask_mcica with col_offset), bit for bit, and the
// max-random-overlap recurrence.
//
// Replaces: the in-kernel samplers of rrtmgp_tpu/ops/pallas_mega.py
//   (_lw_mega_kernel :589, _sw_mega_kernel :1037, _lw2_mega_kernel :1584),
//   which draw from the TPU's own generator (pltpu.prng_random_bits keyed per
//   128-column block). That stream cannot be reproduced on a GPU; this one
//   is the stream the JAX package draws everywhere else, so one mask holds
//   across JAX on the CPU, the torch twins (ops/threefry.py) and the kernels.
//
// Stream: column key = threefry(seed key, counter (0, global column)) (that
//   is fold_in); the uniform of (layer l, g-point g) = threefry(column key,
//   counter (0, l * ngpt + g)), 32 bits = x0 ^ x1, mantissa bits OR'd into
//   1.0f, minus 1. A pure function of (seed, global column, layer, g-point),
//   so any split of the columns draws the same mask.
//
// Recurrence (top layer down): u_eff = u above the first cloudy layer;
//   u_eff(above) below a masked layer; u * (1 - cf_above) below an unmasked
//   one; mask = cf > 0 && u_eff >= 1 - cf. Built with -fmad=false, so the
//   product and the comparison round as the twin's f32 operations do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rrtmgp {

struct Key2x32 {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

#define RRTMGP_TF_ROUND(r) \
  x0 += x1;                \
  x1 = rotl32(x1, r);      \
  x1 ^= x0;

// Threefry-2x32, 20 rounds, of counter (x0, x1) under key k, in place.
__device__ __forceinline__ void threefry2x32(Key2x32 k, uint32_t& x0, uint32_t& x1) {
  const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += ks0;
  x1 += ks1;
  RRTMGP_TF_ROUND(13) RRTMGP_TF_ROUND(15) RRTMGP_TF_ROUND(26) RRTMGP_TF_ROUND(6)
  x0 += ks1;
  x1 += ks2 + 1u;
  RRTMGP_TF_ROUND(17) RRTMGP_TF_ROUND(29) RRTMGP_TF_ROUND(16) RRTMGP_TF_ROUND(24)
  x0 += ks2;
  x1 += ks0 + 2u;
  RRTMGP_TF_ROUND(13) RRTMGP_TF_ROUND(15) RRTMGP_TF_ROUND(26) RRTMGP_TF_ROUND(6)
  x0 += ks0;
  x1 += ks1 + 3u;
  RRTMGP_TF_ROUND(17) RRTMGP_TF_ROUND(29) RRTMGP_TF_ROUND(16) RRTMGP_TF_ROUND(24)
  x0 += ks1;
  x1 += ks2 + 4u;
  RRTMGP_TF_ROUND(13) RRTMGP_TF_ROUND(15) RRTMGP_TF_ROUND(26) RRTMGP_TF_ROUND(6)
  x0 += ks2;
  x1 += ks0 + 5u;
}

#undef RRTMGP_TF_ROUND

// fold_in(seed key, global column): the column's key.
__device__ __forceinline__ Key2x32 mcica_column_key(Key2x32 seed, long long global_col) {
  uint32_t x0 = 0u, x1 = (uint32_t)global_col;
  threefry2x32(seed, x0, x1);
  return Key2x32{x0, x1};
}

// Uniform in [0, 1) of flat counter idx (< 2^32) under a column key.
__device__ __forceinline__ float mcica_uniform(Key2x32 k, uint32_t idx) {
  uint32_t x0 = 0u, x1 = idx;
  threefry2x32(k, x0, x1);
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

// Carry of the max-random-overlap recurrence for one (column, g-point).
struct McicaCarry {
  float u_above = 0.f, cf_above = 0.f;
  bool mask_above = false, started = false;

  // One layer, top down: the mask of a layer with draw u and cloud
  // fraction cf.
  __device__ __forceinline__ bool step(float u, float cf) {
    const float u_eff = started ? (mask_above ? u_above : u * (1.f - cf_above)) : u;
    const bool cloudy = cf > 0.f;
    const bool m = cloudy && (u_eff >= 1.f - cf);
    u_above = u_eff;
    cf_above = cf;
    mask_above = m;
    started = started || cloudy;
    return m;
  }
};

// Number of the block's threads with flag set, after which every thread
// holds it. Needs 32 ints of shared memory; contains __syncthreads().
__device__ __forceinline__ int block_count(bool flag, int* smem32) {
  const int warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  const int n = __popc(__ballot_sync(0xffffffffu, flag));
  if ((threadIdx.x & 31) == 0) smem32[warp] = n;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < nwarps; ++w) total += smem32[w];
  __syncthreads();
  return total;
}

}  // namespace rrtmgp
