// Minor-gas optical depth per (layer, column, g-point): the minor part of the
// unfused gas optics.
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _minor_merged_kernel (wrapper
//   interp_minor_merged): per minor interval covering a g-point, a
//   (temperature, eta) interpolation of its kminor rows at the eta data of
//   the interval's band, times the interval's scaling, summed over the
//   intervals. The TPU kernel merges both troposphere sides per g-point
//   group, with scalings that are zero off their side; this kernel walks only
//   the cell's own side of the interval index (KernelTables.minor_start /
//   minor_list): the other side's scalings are zero, so the function is the
//   same.
//
// Bound on this card: device memory for the output. At 32768 columns x 60
//   layers x 256 g-points it writes 2.01 GB (SW, 224 g-points: 1.76 GB) and
//   reads the per-(layer, column) scalings and eta data (~0.5 GB): ~0.8 ms at
//   3.35 TB/s. Each covering interval reads 4 kminor values from a table
//   that stays in L2 and does ~14 operations.
//
// Design: optics_fused.cu's staged gather for the minor gases alone
//   (gather.cuh). A block is one layer and a tile of adjacent columns, a
//   thread one g-point (a column's g-points over several blocks past 1024,
//   the host's launch plan; no g-point limit). The block first stages, in
//   shared memory, per (layer, column) the temperature weight with its
//   complement and the troposphere side, per (layer, column, band) the two
//   kminor rows and the eta weights with their complements (the record's
//   kmajor corners are formed at slab 0 and not read; no col_mix), per
//   (interval, column) the minor scalings, and each interval's band and
//   kminor base. Every thread, idle ones included, reaches the staging
//   barrier. Each thread then reads its band and minor ranges once and
//   walks the tile's columns with staged_tau_minor, the function
//   optics_fused computes its minor part with, so this output equals that
//   part bit for bit (the same intervals in the same order from 0, in the
//   operation order of common.cuh's tau_minor). A warp writes 128
//   contiguous bytes, g-point fastest, with streaming stores that leave
//   kminor in L2; only the output offset is 64-bit. The 32-bit table
//   offsets need a kminor of fewer than 2^31 elements (the host checks).
//   Nothing of the TPU kernel's structure is kept: no scalar pack, no
//   one-hot contraction, no bf16 hi/lo tables, no per-group g-point
//   padding.
#include "gather.cuh"

namespace rrtmgp {

template <typename R>
__global__ void interp_minor_kernel(OpticsInT<R> in, TablesT<R> tb, Dims d, int n_minor, int tile, int n_tiles,
                                    R* __restrict__ out) {  // (nlay, ncol, ngpt)
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
  for (int e = threadIdx.x; e < nc * d.nbnd; e += blockDim.x) {
    const size_t lc = lc0 + e / d.nbnd;
    const size_t lcb = lc0 * d.nbnd + e;
    set_band<R, false>(d, __ldg(in.jtemp + lc), 0, false, __ldg(in.jeta1 + lcb), __ldg(in.jeta2 + lcb),
                       __ldg(in.feta1 + lcb), __ldg(in.feta2 + lcb), R(1), R(1), sb[e]);
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    set_col(__ldg(in.ftemp + lc0 + c), R(0), R(0), __ldg(in.tropo_lower + lc0 + c) != 0, sc[c]);
  }
  stage_minor(in.minor_scaling, tb.minor_band, tb.minor_kbase, (size_t)d.nlay * d.ncol, lc0, nc, tile, n_minor,
              scal, mband, mkbase);
  __syncthreads();

  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= d.ngpt) return;
  const GptMeta m = gpt_meta(tb.gpt2band, tb.minor_start, d.ngpt, g);
  const R* kminor = tb.kminor + g;
  R* o = out + lc0 * d.ngpt + g;
  for (int c = 0; c < nc; ++c) {
    __stcs(o + (size_t)c * d.ngpt, staged_tau_minor(kminor, tb.minor_list, d.ncontrib, m, sc[c], sb + c * d.nbnd,
                                                    scal + c, tile, mband, mkbase));
  }
}

template <typename R>
cudaError_t launch_interp_minor(const OpticsInT<R>& in, const TablesT<R>& tb, const Dims& d, int n_minor, int tile,
                                int group, int n_groups, R* out, cudaStream_t stream) {
  if (tile < 1) return cudaErrorInvalidValue;
  const long long n_tiles = (d.ncol + tile - 1) / tile;
  const long long blocks = n_tiles * d.nlay;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaGetLastError();
  const size_t smem = OpticsSmem<R>(tile, d.nbnd, n_minor).total;
  auto kernel = interp_minor_kernel<R>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_groups), group, smem, stream>>>(in, tb, d, n_minor, tile,
                                                                              (int)n_tiles, out);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. The arguments are optics_fused's without ray_factor and the tables
// of kmajor and the second table, which this kernel does not read (nor
// jpress, fpress, col_dry, cmix1 and cmix2). tile: columns of a block;
// group, n_groups: the g-point launch plan (ops/_launch.py gpoint_plan).
extern "C" int rrtmgp_interp_minor(
    const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* tropo_lower, const void* col_dry,
    const void* jeta1, const void* feta1, const void* cmix1,
    const void* jeta2, const void* feta2, const void* cmix2, const void* minor_scaling,
    const void* kminor, const void* gpt2band,
    const void* minor_start, const void* minor_list, const void* minor_kbase, const void* minor_band,
    void* out, int nlay, int ncol, int ngpt, int nbnd, int ntemp, int neta, int ncontrib, int n_minor, int tile,
    int group, int n_groups, void* stream) {
  using namespace rrtmgp;
  const OpticsIn in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                    (const unsigned char*)tropo_lower, (const float*)col_dry,
                    (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                    (const int*)jeta2, (const float*)feta2, (const float*)cmix2,
                    (const float*)minor_scaling, nullptr};
  const Tables tb{nullptr, nullptr, (const float*)kminor, (const int*)gpt2band,
                  (const int*)minor_start, (const int*)minor_list, (const int*)minor_kbase,
                  (const int*)minor_band};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, ncontrib};
  return (int)launch_interp_minor<float>(in, tb, d, n_minor, tile, group, n_groups, (float*)out,
                                         (cudaStream_t)stream);
}

// Dynamic shared memory of one interp_minor block (f32).
extern "C" long long rrtmgp_interp_minor_smem(int tile, int nbnd, int n_minor) {
  return (long long)rrtmgp::OpticsSmem<float>(tile, nbnd, n_minor).total;
}

namespace rrtmgp {

// The most threads a block of interp_minor may have (errors.cu
// rrtmgp_max_threads); variant is 0.
cudaError_t interp_minor_max_threads(int, int* threads) { return max_threads(threads, interp_minor_kernel<float>); }

}  // namespace rrtmgp
