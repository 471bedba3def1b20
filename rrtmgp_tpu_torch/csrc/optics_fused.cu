// Materialized gas optics: tau and the Planck fraction (LW) or the Rayleigh
// single-scattering albedo (SW) per (layer, column, g-point), written to
// device memory for the sweeps of the two-kernel path and for any caller that
// needs the optics as tensors.
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _optics_fused_kernel (wrapper
//   optics_fused): major-species tau by (pressure, temperature, eta)
//   interpolation scaled by col_dry, minor-gas tau per covering interval,
//   then LW: tau clamped at 0 and the Planck fraction; SW: tau with Rayleigh
//   clamped at 0 and ssa = Rayleigh / tau where tau > 0, else 0.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 256
//   g-points the two outputs are 2 x 2.01 GB (SW, 224 g-points: 2 x 1.76 GB)
//   against ~0.2 GB of inputs: ~1.3 ms at 3.35 TB/s. Each point reads 16 (LW)
//   or 12 (SW) table values plus 4 kminor values per covering minor interval
//   from tables that stay in L2, and does ~60 operations.
//
// Design: a block is one layer and a tile of adjacent columns, a thread one
//   g-point (a column's g-points over several blocks past 1024, the host's
//   launch plan). The block first stages what its cells share
//   (gather.cuh): per (layer, column) the weights, col_dry and the side,
//   per (layer, column, band) the table corner offsets (32-bit, formed once
//   instead of in sixteen 64-bit tab() calls per point), the eta weights and
//   mixing ratios, per (interval, column) the minor scalings, and each
//   interval's band and kminor base. Each thread then reads its band and
//   minor ranges once and walks the tile's columns: the table lines that
//   neighbouring columns share stay in its SM's L1. A warp still writes 128
//   contiguous bytes per output, g-point fastest, with streaming stores so
//   that the outputs do not push the tables out of L2. The arithmetic is
//   that of the megakernels' layer loops in the same operation order, so
//   the two-kernel path and the megakernels see the same optics to the
//   last bit. The real type and the spectral range are template
//   parameters. Nothing of the TPU kernel's structure is kept: no one-hot
//   contraction, no bf16 hi/lo tables, no windows, no scalar pack, no
//   128-lane g-point padding.
#include "gather.cuh"

namespace rrtmgp {

template <typename R, bool SW>
__global__ void optics_fused_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d, int n_minor, int tile, int n_tiles,
                                    R* __restrict__ tau_out,      // (nlay, ncol, ngpt)
                                    R* __restrict__ second_out) { // (nlay, ncol, ngpt)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OpticsSmem<R> lay(tile, d.nbnd, n_minor);
  StagedBand<R>* sb = reinterpret_cast<StagedBand<R>*>(smem_raw + lay.bands);
  StagedCol<R>* sc = reinterpret_cast<StagedCol<R>*>(smem_raw + lay.cols);
  R* scal = reinterpret_cast<R*>(smem_raw + lay.scal);
  int* mband = reinterpret_cast<int*>(smem_raw + lay.meta);
  int* mkbase = mband + n_minor;

  const int l = (int)(blockIdx.x / (unsigned)n_tiles);
  const int c0 = (int)(blockIdx.x - (unsigned)l * n_tiles) * tile;
  const int nc = min(tile, d.ncol - c0);
  const size_t lc0 = (size_t)l * d.ncol + c0;
  const size_t plane = (size_t)d.nlay * d.ncol;
  for (int e = threadIdx.x; e < nc * d.nbnd; e += blockDim.x) {
    const size_t lc = lc0 + e / d.nbnd;
    const size_t lcb = lc0 * d.nbnd + e;
    set_band<R, SW>(d, __ldg(in.jtemp + lc), __ldg(in.jpress + lc), __ldg(in.tropo_lower + lc) != 0,
                    __ldg(in.jeta1 + lcb), __ldg(in.jeta2 + lcb), __ldg(in.feta1 + lcb), __ldg(in.feta2 + lcb),
                    __ldg(in.cmix1 + lcb), __ldg(in.cmix2 + lcb), sb[e]);
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const size_t lc = lc0 + c;
    set_col(__ldg(in.ftemp + lc), __ldg(in.fpress + lc), __ldg(in.col_dry + lc), __ldg(in.tropo_lower + lc) != 0,
            sc[c]);
    if constexpr (SW) sc[c].ray = __ldg(in.ray_factor + lc);
  }
  stage_minor(in.minor_scaling, tb.minor_band, tb.minor_kbase, plane, lc0, nc, tile, n_minor, scal, mband, mkbase);
  __syncthreads();

  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= d.ngpt) return;
  const GptMeta m = gpt_meta(tb.gpt2band, tb.minor_start, d.ngpt, g);
  const int se = d.ngpt, sp = d.ntemp * d.neta * d.ngpt;
  const R* kmajor = tb.kmajor + g;
  const R* second = tb.second + g;
  const R* kminor = tb.kminor + g;
  // streaming stores (__stcs): the optics are written once and read by
  // another kernel, so they should not push the tables out of L2
  R* tau_p = tau_out + lc0 * d.ngpt + g;
  R* second_p = second_out + lc0 * d.ngpt + g;
  for (int c = 0; c < nc; ++c) {
    const StagedCol<R>& col = sc[c];
    const StagedBand<R>* bands = sb + c * d.nbnd;
    const StagedBand<R>& b = bands[m.band];
    const R gas = staged_tau_major(kmajor, sp, se, col, b) +
                  staged_tau_minor(kminor, tb.minor_list, d.ncontrib, m, col, bands, scal + c, tile, mband, mkbase);
    if constexpr (SW) {
      const R ray = staged_tau_rayleigh(second, se, col, b);
      const R tau = r_max(gas + ray, R(0));
      __stcs(tau_p + (size_t)c * d.ngpt, tau);
      __stcs(second_p + (size_t)c * d.ngpt, tau > R(0) ? ray / tau : R(0));
    } else {
      __stcs(tau_p + (size_t)c * d.ngpt, r_max(gas, R(0)));
      __stcs(second_p + (size_t)c * d.ngpt, staged_planck_fraction(second, sp, se, col, b));
    }
  }
}

template <typename R, bool SW>
cudaError_t launch_optics_fused(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d, int n_minor, int tile,
                                int group, int n_groups, R* tau, R* second, cudaStream_t stream) {
  if (tile < 1) return cudaErrorInvalidValue;
  const long long n_tiles = (d.ncol + tile - 1) / tile;
  const long long blocks = n_tiles * d.nlay;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaGetLastError();
  const size_t smem = OpticsSmem<R>(tile, d.nbnd, n_minor).total;
  auto kernel = optics_fused_kernel<R, SW>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_groups), group, smem, stream>>>(in, tb, d, n_minor, tile, (int)n_tiles,
                                                                              tau, second);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. `second` is the Planck-fraction table (LW) or the Rayleigh table (SW);
// ray_factor is read only when shortwave != 0. tile: columns of a block;
// group, n_groups: the g-point launch plan (ops/_launch.py gpoint_plan).
extern "C" int rrtmgp_optics_fused(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* ray_factor,
    const void* kmajor, const void* second, const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    void* tau_out, void* second_out,
    int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor, int shortwave,
    int tile, int group, int n_groups, void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, (const float*)ray_factor};
  const Tables tb{(const float*)kmajor, (const float*)second, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      shortwave ? launch_optics_fused<float, true>(in, tb, d, n_minor, tile, group, n_groups, (float*)tau_out,
                                                   (float*)second_out, s)
                : launch_optics_fused<float, false>(in, tb, d, n_minor, tile, group, n_groups, (float*)tau_out,
                                                    (float*)second_out, s);
  return (int)err;
}

// Dynamic shared memory of one optics_fused block (f32).
extern "C" long long rrtmgp_optics_fused_smem(int tile, int nbnd, int n_minor) {
  return (long long)rrtmgp::OpticsSmem<float>(tile, nbnd, n_minor).total;
}

namespace rrtmgp {

// The most threads a block of optics_fused may have (errors.cu
// rrtmgp_max_threads): variant = shortwave.
cudaError_t optics_fused_max_threads(int variant, int* threads) {
  return variant ? max_threads(threads, optics_fused_kernel<float, true>)
                 : max_threads(threads, optics_fused_kernel<float, false>);
}

}  // namespace rrtmgp
