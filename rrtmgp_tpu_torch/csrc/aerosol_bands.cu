// MERRA aerosol band sums: tau, tau*ssa and tau*ssa*g per (layer, band,
// column), accumulated over the active species.
//
// Replaces: rrtmgp_tpu/ops/pallas_aerosol.py, _aero_kernel (wrapper
//   aerosol_bands_pallas). The TPU kernel contracts one-hot interpolation
//   weights against bf16 hi/lo table splits on the MXU; here each thread
//   reads its few table entries directly in f32 (the tables are a few KB
//   and stay in L1), so there is no split and no weight matrix.
//
// Bound on this card: device memory by bytes. Per (layer, column) it reads
//   2 x 15 floats of mass and size plus the RH and writes 3 x nbnd floats;
//   at 60 x 75748 with 16 bands that is ~1.4 GB of traffic (~0.43 ms at
//   3.35 TB/s). The arithmetic (~10 flops per active species and band) is
//   small. What it costs beyond: ~69 table reads per band and row, 1,100 at
//   16 bands, whose addresses depend on each column's RH level and size
//   bins.
//
// Design: the tables are staged once per block in shared memory, and the
//   block loops over (layer, column) rows (grid-stride, as many blocks as
//   fit the SMs at once), a thread a row, consecutive threads on consecutive
//   columns, so each output row (layer, band) is written coalesced. Read
//   from device memory through L1, the rows of a warp touched many lines per
//   load, one per distinct (RH level, size bin) (PERF.md, PR 12 ablation).
//   In shared memory each table is a run of records, one per (RH level,
//   bin) or bin or RH level, of nbnd (ext, ssa, asy) triples at an odd
//   stride in words (AeroLayout), so the distinct records a warp reads fall
//   in distinct banks (an even stride of 48 words would put them in 2). Per
//   band the species are added in the order of the plain twin (dust, sea
//   salt, sulfate, BC-RH, OC-RH, BC, OC), with the expressions of the
//   kernel that read device memory, so the sums have its bits. The active
//   species come as a 15-bit mask; with all 15 active, as the solves call
//   it, an instance without a test per species runs (ALL): with the tests
//   the band loop ran ~25% slower (PERF.md, PR 12). The wrapper refuses
//   tables that do not fit a block's shared memory.
#include "common.cuh"

namespace rrtmgp {

struct AeroTables {
  const float* bin_lims;   // (2, nbin)
  const float* rh_levels;  // (nrh,)
  const float* dust;       // (3, nbin, nbnd)
  const float* sea_salt;   // (3, nrh, nbin, nbnd)
  const float* sulfate;    // (3, nrh, nbnd)
  const float* bc_rh;      // (3, nrh, nbnd)
  const float* bc;         // (3, nbnd)
  const float* oc_rh;      // (3, nrh, nbnd)
  const float* oc;         // (3, nbnd)
};

// MERRA species indices (ops/aerosol_optics.py)
constexpr int kSulfate = 2, kBcRh = 3, kBc = 4, kOcRh = 5, kOc = 6;

// Where the staged tables lie in shared memory, in words: the bin limits
// (2, nbin), the RH levels (nrh,), then the records of dust (nbin), sea salt
// (nrh x nbin, RH level major), sulfate, BC-RH, OC-RH (nrh each), BC and OC
// (one each). A record holds nbnd (ext, ssa, asy) triples, band b at 3 b;
// records are `stride` words apart, an odd number (ops/aerosol_bands.py
// staged_bytes mirrors this).
struct AeroLayout {
  int stride, lims, rh, dust, salt, sulf, bcrh, ocrh, bc, oc, words;

  __host__ __device__ AeroLayout(int nbnd, int nbin, int nrh) {
    stride = 3 * nbnd | 1;
    lims = 0;
    rh = lims + 2 * nbin;
    dust = rh + nrh;
    salt = dust + nbin * stride;
    sulf = salt + nrh * nbin * stride;
    bcrh = sulf + nrh * stride;
    ocrh = bcrh + nrh * stride;
    bc = ocrh + nrh * stride;
    oc = bc + stride;
    words = oc + stride;
  }
};

// A table of (3, nrec, nbnd) values into records at smem + off.
__device__ __forceinline__ void stage_records(float* smem, int off, int stride, const float* __restrict__ t, int nrec,
                                              int nbnd) {
  const int per_value = nrec * nbnd;
  for (int i = threadIdx.x; i < 3 * per_value; i += blockDim.x) {
    const int q = i / per_value, rest = i - q * per_value;
    const int r = rest / nbnd, b = rest - r * nbnd;
    smem[off + r * stride + 3 * b + q] = __ldg(t + i);
  }
}

__device__ __forceinline__ int size_bin(const float* lims, int nbin, float size) {
  for (int j = 0; j < nbin; ++j) {
    if (size >= lims[j] && size <= lims[nbin + j]) return j;
  }
  return nbin - 1;
}

struct Acc {
  float t = 0.f, ts = 0.f, tsg = 0.f;

  __device__ __forceinline__ void add(float m, float ext, float ssa, float asy) {
    const float tt = m > 0.f ? m * ext : 0.f;
    const float tts = tt * ssa;
    t = t + tt;
    ts = ts + tts;
    tsg = tsg + tts * asy;
  }

  // the triple at word w of the staged tables
  __device__ __forceinline__ void add(float m, const float* smem, int w) { add(m, smem[w], smem[w + 1], smem[w + 2]); }

  // the triples at words w0 and w1, interpolated in RH
  __device__ __forceinline__ void add(float m, const float* smem, int w0, int w1, float omf, float fac) {
    float v[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) v[q] = smem[w0 + q] * omf + smem[w1 + q] * fac;
    add(m, v[0], v[1], v[2]);
  }
};

template <bool ALL>
__global__ void aerosol_bands_kernel(AeroTables tb, const float* __restrict__ mass,  // (15, n)
                                     const float* __restrict__ size,                  // (15, n)
                                     const float* __restrict__ rh,                    // (n,)
                                     float* __restrict__ t_out,    // (nlay, nbnd, ncol)
                                     float* __restrict__ ts_out, float* __restrict__ tsg_out,
                                     int nlay, int ncol, int nbnd, int nbin, int nrh, int active) {
  extern __shared__ float smem[];
  const AeroLayout lay(nbnd, nbin, nrh);
  const int S = lay.stride;
  for (int i = threadIdx.x; i < 2 * nbin; i += blockDim.x) smem[lay.lims + i] = __ldg(tb.bin_lims + i);
  for (int i = threadIdx.x; i < nrh; i += blockDim.x) smem[lay.rh + i] = __ldg(tb.rh_levels + i);
  stage_records(smem, lay.dust, S, tb.dust, nbin, nbnd);
  stage_records(smem, lay.salt, S, tb.sea_salt, nrh * nbin, nbnd);
  stage_records(smem, lay.sulf, S, tb.sulfate, nrh, nbnd);
  stage_records(smem, lay.bcrh, S, tb.bc_rh, nrh, nbnd);
  stage_records(smem, lay.ocrh, S, tb.oc_rh, nrh, nbnd);
  stage_records(smem, lay.bc, S, tb.bc, 1, nbnd);
  stage_records(smem, lay.oc, S, tb.oc, 1, nbnd);
  __syncthreads();
  const float *lims = smem + lay.lims, *rh_levels = smem + lay.rh;

  const int kDust[5] = {0, 7, 8, 9, 10};
  const int kSalt[5] = {1, 11, 12, 13, 14};
  const long long n = (long long)nlay * ncol;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(i / ncol), c = (int)(i - (long long)l * ncol);

    // relative-humidity location: levels <= rh, minus one, clamped
    const float r = __ldg(rh + i);
    int cnt = 0;
    for (int j = 0; j < nrh; ++j) cnt += rh_levels[j] <= r ? 1 : 0;
    const int loc = min(max(cnt - 1, 0), nrh - 2);
    const float lev0 = rh_levels[loc], lev1 = rh_levels[loc + 1];
    const float fac = fminf(fmaxf((r - lev0) / (lev1 - lev0), 0.f), 1.f);
    const float omf = 1.f - fac;

    // each species' first record, in words: dust by bin, sea salt by (RH
    // level, bin), the RH tables by RH level
    int dust_rec[5], salt_rec[5];
    float dust_m[5], salt_m[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      dust_m[k] = __ldg(mass + (size_t)kDust[k] * n + i);
      salt_m[k] = __ldg(mass + (size_t)kSalt[k] * n + i);
      dust_rec[k] = lay.dust + size_bin(lims, nbin, __ldg(size + (size_t)kDust[k] * n + i)) * S;
      salt_rec[k] = lay.salt + (loc * nbin + size_bin(lims, nbin, __ldg(size + (size_t)kSalt[k] * n + i))) * S;
    }
    const float m_bc = __ldg(mass + (size_t)kBc * n + i), m_oc = __ldg(mass + (size_t)kOc * n + i);
    const int rh_rec[3] = {lay.sulf + loc * S, lay.bcrh + loc * S, lay.ocrh + loc * S};
    const int rh_idx[3] = {kSulfate, kBcRh, kOcRh};
    float rh_m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rh_m[k] = __ldg(mass + (size_t)rh_idx[k] * n + i);
    const auto on = [&](int idx) { return ALL || (active >> idx & 1); };
    const int salt_next = nbin * S;  // the same bin one RH level up

    for (int b = 0; b < nbnd; ++b) {
      const int o3 = 3 * b;
      Acc a;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (on(kDust[k])) a.add(dust_m[k], smem, dust_rec[k] + o3);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if (on(kSalt[k])) a.add(salt_m[k], smem, salt_rec[k] + o3, salt_rec[k] + salt_next + o3, omf, fac);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (on(rh_idx[k])) a.add(rh_m[k], smem, rh_rec[k] + o3, rh_rec[k] + S + o3, omf, fac);
      }
      if (on(kBc)) a.add(m_bc, smem, lay.bc + o3);
      if (on(kOc)) a.add(m_oc, smem, lay.oc + o3);
      const size_t o = ((size_t)l * nbnd + b) * ncol + c;
      t_out[o] = a.t;
      ts_out[o] = a.ts;
      tsg_out[o] = a.tsg;
    }
  }
}

constexpr int kAeroThreads = 256;
constexpr int kAllSpecies = (1 << 15) - 1;

// Shared memory of a block: the staged tables.
inline size_t aerosol_smem(int nbnd, int nbin, int nrh) {
  return sizeof(float) * (size_t)AeroLayout(nbnd, nbin, nrh).words;
}

// Blocks of the kernel instance for `active` that fit one SM at once with
// this shared memory.
inline cudaError_t aerosol_blocks_per_sm(int active, size_t smem, int* blocks) {
  auto kernel = active == kAllSpecies ? aerosol_bands_kernel<true> : aerosol_bands_kernel<false>;
  const cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kAeroThreads, smem);
}

}  // namespace rrtmgp

// The tables as ops/aerosol_bands.py TABLES lists them, then mass, size
// (15, nlay, ncol), rh (nlay, ncol) and the three outputs (nlay, nbnd, ncol).
// The grid is the blocks that fit the SMs at once (no more than the rows
// need); each block stages the tables (rrtmgp_aerosol_bands_smem bytes).
extern "C" int rrtmgp_aerosol_bands(const void* bin_lims, const void* rh_levels, const void* dust,
                                    const void* sea_salt, const void* sulfate, const void* bc_rh,
                                    const void* bc, const void* oc_rh, const void* oc, const void* mass,
                                    const void* size, const void* rh, void* t_out, void* ts_out,
                                    void* tsg_out, int nlay, int ncol, int nbnd, int nbin, int nrh,
                                    int active, void* stream) {
  using namespace rrtmgp;
  const AeroTables tb{(const float*)bin_lims, (const float*)rh_levels, (const float*)dust,
                      (const float*)sea_salt, (const float*)sulfate, (const float*)bc_rh,
                      (const float*)bc, (const float*)oc_rh, (const float*)oc};
  const long long n = (long long)nlay * ncol;
  if (n == 0) return (int)cudaGetLastError();
  const size_t smem = aerosol_smem(nbnd, nbin, nrh);
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = aerosol_blocks_per_sm(active, smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (n + kAeroThreads - 1) / kAeroThreads;
  const unsigned blocks = (unsigned)(need < (long long)per_sm * sms ? need : (long long)per_sm * sms);
  auto kernel = active == kAllSpecies ? aerosol_bands_kernel<true> : aerosol_bands_kernel<false>;
  kernel<<<blocks, kAeroThreads, smem, (cudaStream_t)stream>>>(
      tb, (const float*)mass, (const float*)size, (const float*)rh, (float*)t_out, (float*)ts_out, (float*)tsg_out,
      nlay, ncol, nbnd, nbin, nrh, active);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one aerosol_bands block: the staged tables.
extern "C" long long rrtmgp_aerosol_bands_smem(int nbnd, int nbin, int nrh) {
  return (long long)rrtmgp::aerosol_smem(nbnd, nbin, nrh);
}

// Blocks of aerosol_bands (all species active) that fit one SM at once with
// the tables of (nbnd, nbin, nrh) staged: the grid of a launch is this
// times the SMs.
extern "C" int rrtmgp_aerosol_bands_blocks(int nbnd, int nbin, int nrh, int* blocks) {
  using namespace rrtmgp;
  return (int)aerosol_blocks_per_sm(kAllSpecies, aerosol_smem(nbnd, nbin, nrh), blocks);
}
