// MERRA aerosol band sums: tau, tau*ssa and tau*ssa*g per (layer, band,
// column), accumulated over the active species.
//
// Replaces: rrtmgp_tpu/ops/pallas_aerosol.py, _aero_kernel (wrapper
//   aerosol_bands_pallas). The TPU kernel contracts one-hot interpolation
//   weights against bf16 hi/lo table splits on the MXU; here each thread
//   reads its few table entries directly in f32 (the tables are a few KB
//   and stay in L1), so there is no split and no weight matrix.
//
// Bound on this card: device memory. Per (layer, column) it reads 2 x 15
//   floats of mass and size plus the RH and writes 3 x nbnd floats; at 60 x
//   75748 with 14 bands that is ~0.8 GB of traffic (~0.25 ms at 3.35 TB/s).
//   The arithmetic (~10 flops per active species and band) is small.
//
// Design: one thread per (layer, column), consecutive threads on
//   consecutive columns, so each output row (layer, band) is written
//   coalesced. Per band the species are added in the order of the plain
//   twin (dust, sea salt, sulfate, BC-RH, OC-RH, BC, OC), so the sums round
//   alike. The active species come as a 15-bit mask.
#include <cuda_runtime.h>

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

__device__ __forceinline__ int size_bin(const float* lims, int nbin, float size) {
  for (int j = 0; j < nbin; ++j) {
    if (size >= __ldg(lims + j) && size <= __ldg(lims + nbin + j)) return j;
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
};

__global__ void aerosol_bands_kernel(AeroTables tb, const float* __restrict__ mass,  // (15, n)
                                     const float* __restrict__ size,                  // (15, n)
                                     const float* __restrict__ rh,                    // (n,)
                                     float* __restrict__ t_out,    // (nlay, nbnd, ncol)
                                     float* __restrict__ ts_out, float* __restrict__ tsg_out,
                                     int nlay, int ncol, int nbnd, int nbin, int nrh, int active) {
  const int kDust[5] = {0, 7, 8, 9, 10};
  const int kSalt[5] = {1, 11, 12, 13, 14};
  const long long n = (long long)nlay * ncol;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l = (int)(i / ncol), c = (int)(i - (long long)l * ncol);

  // relative-humidity location: levels <= rh, minus one, clamped
  const float r = __ldg(rh + i);
  int cnt = 0;
  for (int j = 0; j < nrh; ++j) cnt += __ldg(tb.rh_levels + j) <= r ? 1 : 0;
  const int loc = min(max(cnt - 1, 0), nrh - 2);
  const float lev0 = __ldg(tb.rh_levels + loc), lev1 = __ldg(tb.rh_levels + loc + 1);
  const float fac = fminf(fmaxf((r - lev0) / (lev1 - lev0), 0.f), 1.f);
  const float omf = 1.f - fac;

  int dust_bin[5], salt_bin[5];
  float dust_m[5], salt_m[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dust_m[k] = __ldg(mass + (size_t)kDust[k] * n + i);
    salt_m[k] = __ldg(mass + (size_t)kSalt[k] * n + i);
    dust_bin[k] = size_bin(tb.bin_lims, nbin, __ldg(size + (size_t)kDust[k] * n + i));
    salt_bin[k] = size_bin(tb.bin_lims, nbin, __ldg(size + (size_t)kSalt[k] * n + i));
  }
  const float m_sulf = __ldg(mass + (size_t)kSulfate * n + i), m_bcrh = __ldg(mass + (size_t)kBcRh * n + i);
  const float m_ocrh = __ldg(mass + (size_t)kOcRh * n + i), m_bc = __ldg(mass + (size_t)kBc * n + i);
  const float m_oc = __ldg(mass + (size_t)kOc * n + i);
  const int nb = nbnd, rhs = nrh * nbnd;  // value stride of the (3, nrh, nbnd) tables

  for (int b = 0; b < nbnd; ++b) {
    Acc a;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (active >> kDust[k] & 1) {
        const float* d = tb.dust + (size_t)dust_bin[k] * nb + b;
        const int vs = nbin * nb;
        a.add(dust_m[k], __ldg(d), __ldg(d + vs), __ldg(d + 2 * vs));
      }
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (active >> kSalt[k] & 1) {
        const int vs = nrh * nbin * nb;
        const float* s0 = tb.sea_salt + ((size_t)loc * nbin + salt_bin[k]) * nb + b;
        const float* s1 = s0 + (size_t)nbin * nb;
        float v[3];
        for (int q = 0; q < 3; ++q) v[q] = __ldg(s0 + q * vs) * omf + __ldg(s1 + q * vs) * fac;
        a.add(salt_m[k], v[0], v[1], v[2]);
      }
    }
    const float* rh_tabs[3] = {tb.sulfate, tb.bc_rh, tb.oc_rh};
    const int rh_idx[3] = {kSulfate, kBcRh, kOcRh};
    const float rh_m[3] = {m_sulf, m_bcrh, m_ocrh};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (active >> rh_idx[k] & 1) {
        const float* p0 = rh_tabs[k] + (size_t)loc * nb + b;
        float v[3];
        for (int q = 0; q < 3; ++q) v[q] = __ldg(p0 + q * rhs) * omf + __ldg(p0 + nb + q * rhs) * fac;
        a.add(rh_m[k], v[0], v[1], v[2]);
      }
    }
    if (active >> kBc & 1) a.add(m_bc, __ldg(tb.bc + b), __ldg(tb.bc + nb + b), __ldg(tb.bc + 2 * nb + b));
    if (active >> kOc & 1) a.add(m_oc, __ldg(tb.oc + b), __ldg(tb.oc + nb + b), __ldg(tb.oc + 2 * nb + b));
    const size_t o = ((size_t)l * nbnd + b) * ncol + c;
    t_out[o] = a.t;
    ts_out[o] = a.ts;
    tsg_out[o] = a.tsg;
  }
}

}  // namespace rrtmgp

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
  const int threads = 256;
  if (n > 0) {
    aerosol_bands_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, (cudaStream_t)stream>>>(
        tb, (const float*)mass, (const float*)size, (const float*)rh, (float*)t_out, (float*)ts_out,
        (float*)tsg_out, nlay, ncol, nbnd, nbin, nrh, active);
  }
  return (int)cudaGetLastError();
}
