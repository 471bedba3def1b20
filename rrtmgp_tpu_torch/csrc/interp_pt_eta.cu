// Generic (pressure, temperature, eta) table interpolation per (layer,
// column, g-point): the table reads of the unfused gas optics, one table at a
// time (kmajor with col_mix, the Planck fraction, the Rayleigh table).
//
// Replaces: rrtmgp_tpu/ops/pallas_interp.py, _full_kernel (wrapper
//   interp_pt_eta) and _windowed_kernel (wrapper interp_pt_eta_windowed):
//   out = sum over the two temperature nodes of the temperature weight times
//   (pressure- and eta-interpolated table value x that node's col_mix). One
//   kernel covers both: the windowed variant computes the same function on a
//   per-layer table window, and the port reads whole tables from L2, so there
//   is no window to choose or to guard.
//
// Bound on this card: device memory for the output. At 32768 columns x 60
//   layers x 256 g-points it writes 2.01 GB (SW, 224 g-points: 1.76 GB) and
//   reads ~0.8 GB of per-(layer, column, band) inputs: ~0.8 ms at 3.35 TB/s.
//   Each point reads 8 table values (4 where no pressure slab lies above the
//   cell) from a table that stays in L2 and does ~25 operations.
//
// Design: optics_fused.cu's staged gather (gather.cuh). A block is one layer
//   and a tile of adjacent columns, a thread one g-point (a column's
//   g-points over several blocks past 1024, the host's launch plan; no
//   g-point limit). The block first stages, in shared memory, per (layer,
//   column) the temperature and pressure weights with their complements and
//   whether the table has a slab above the cell's, and per (layer, column,
//   band) the two 32-bit corner offsets, the eta weights with their
//   complements and the two col_mix factors (1 without col_mix). Every
//   thread, idle ones included, reaches the staging barrier. Each thread
//   then reads its band once and walks the tile's columns: eight gathers,
//   each one add from a staged offset (the other corners are the fixed
//   strides +ngpt for eta and +ntemp*neta*ngpt for pressure), so the table
//   lines that neighbouring columns share stay in its SM's L1. A warp writes
//   128 contiguous bytes, g-point fastest, with streaming stores that leave
//   the table in L2; only the output offset is 64-bit (5.0e8 points). The
//   32-bit offsets need a table of fewer than 2^31 elements (the host
//   checks). The arithmetic is the per-point version's in the same order:
//   per node omfp * lo + fp * hi, the eta blend, then (1 - ft) * (v0 * cm1) +
//   ft * (v1 * cm2), so that kmajor x col_dry here equals optics_fused's
//   major tau bit for bit; without col_mix the factor is 1, which leaves
//   every value as planck_fraction and tau_rayleigh compute it. A table of
//   npress pressure slabs is never read past its last slab: the node above
//   it (the Rayleigh table's side 1 with fpress = 0) has weight fpress and
//   value 0 (gather.cuh staged_p_eta_bounded). Nothing of the TPU kernel's
//   structure is kept: no one-hot contraction, no bf16 hi/lo table split,
//   no window, no 128-lane g-point padding.
#include "gather.cuh"

namespace rrtmgp {

// Per-(layer, column) and per-(layer, column, band) inputs of one call.
template <typename R>
struct InterpInT {
  const int* jtemp;
  const R* ftemp;
  const int* jpress;  // pressure slab of the lower node
  const R* fpress;
  const int* jeta1;
  const R* feta1;
  const R* cmix1;  // null: no col_mix (a factor of 1)
  const int* jeta2;
  const R* feta2;
  const R* cmix2;
};

// Shared memory of a block: the staged bands and columns of the tile and
// each column's flag of a slab above.
template <typename R>
struct InterpSmem {
  size_t bands, cols, above, total;
  __host__ __device__ InterpSmem(int tile, int nbnd) {
    bands = 0;
    cols = bands + sizeof(StagedBand<R>) * tile * nbnd;
    above = cols + sizeof(StagedCol<R>) * tile;
    total = above + sizeof(int) * tile;
  }
};

template <typename R>
__global__ void interp_pt_eta_kernel(const R* __restrict__ table,  // (npress, ntemp, neta, ngpt)
                                     InterpInT<R> in, const int* __restrict__ gpt2band, Dims d, int npress,
                                     int tile, int n_tiles, R* __restrict__ out) {  // (nlay, ncol, ngpt)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const InterpSmem<R> lay(tile, d.nbnd);
  StagedBand<R>* sb = reinterpret_cast<StagedBand<R>*>(smem_raw + lay.bands);
  StagedCol<R>* sc = reinterpret_cast<StagedCol<R>*>(smem_raw + lay.cols);
  int* above = reinterpret_cast<int*>(smem_raw + lay.above);

  const int l = (int)(blockIdx.x / (unsigned)n_tiles);
  const int c0 = (int)(blockIdx.x - (unsigned)l * n_tiles) * tile;
  const int nc = min(tile, d.ncol - c0);
  const size_t lc0 = (size_t)l * d.ncol + c0;
  for (int e = threadIdx.x; e < nc * d.nbnd; e += blockDim.x) {
    const size_t lc = lc0 + e / d.nbnd;
    const size_t lcb = lc0 * d.nbnd + e;
    set_band<R, false>(d, __ldg(in.jtemp + lc), __ldg(in.jpress + lc), false, __ldg(in.jeta1 + lcb),
                       __ldg(in.jeta2 + lcb), __ldg(in.feta1 + lcb), __ldg(in.feta2 + lcb),
                       in.cmix1 ? __ldg(in.cmix1 + lcb) : R(1), in.cmix2 ? __ldg(in.cmix2 + lcb) : R(1), sb[e]);
  }
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const size_t lc = lc0 + c;
    set_col(__ldg(in.ftemp + lc), __ldg(in.fpress + lc), R(1), false, sc[c]);
    above[c] = __ldg(in.jpress + lc) + 1 < npress;
  }
  __syncthreads();

  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= d.ngpt) return;
  const int band = __ldg(gpt2band + g);
  const int se = d.ngpt, sp = d.ntemp * d.neta * d.ngpt;
  const R* t = table + g;
  R* o = out + lc0 * d.ngpt + g;
  for (int c = 0; c < nc; ++c) {
    const StagedCol<R>& col = sc[c];
    const StagedBand<R>& b = sb[c * d.nbnd + band];
    R v0, v1;
    staged_p_eta_bounded(t, sp, se, col, b, above[c] != 0, v0, v1);
    __stcs(o + (size_t)c * d.ngpt, col.omft * (v0 * b.cm1) + col.ft * (v1 * b.cm2));
  }
}

template <typename R>
cudaError_t launch_interp_pt_eta(const R* table, const InterpInT<R>& in, const int* gpt2band, const Dims& d,
                                 int npress, int tile, int group, int n_groups, R* out, cudaStream_t stream) {
  if (tile < 1) return cudaErrorInvalidValue;
  const long long n_tiles = (d.ncol + tile - 1) / tile;
  const long long blocks = n_tiles * d.nlay;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  if (blocks == 0) return cudaGetLastError();
  const size_t smem = InterpSmem<R>(tile, d.nbnd).total;
  auto kernel = interp_pt_eta_kernel<R>;
  cudaError_t err = prepare_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)blocks, (unsigned)n_groups), group, smem, stream>>>(table, in, gpt2band, d, npress, tile,
                                                                              (int)n_tiles, out);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// f32. cmix1 / cmix2 may both be null (no col_mix). tile: columns of a
// block; group, n_groups: the g-point launch plan (ops/_launch.py
// gpoint_plan).
extern "C" int rrtmgp_interp_pt_eta(
    const void* table, const void* jtemp, const void* ftemp, const void* jpress, const void* fpress,
    const void* jeta1, const void* feta1, const void* cmix1, const void* jeta2, const void* feta2,
    const void* cmix2, const void* gpt2band, void* out,
    int nlay, int ncol, int ngpt, int nbnd, int npress, int ntemp, int neta, int tile, int group, int n_groups,
    void* stream) {
  using namespace rrtmgp;
  const InterpInT<float> in{(const int*)jtemp, (const float*)ftemp, (const int*)jpress, (const float*)fpress,
                            (const int*)jeta1, (const float*)feta1, (const float*)cmix1,
                            (const int*)jeta2, (const float*)feta2, (const float*)cmix2};
  const Dims d{nlay, ncol, ngpt, nbnd, ntemp, neta, 0};
  return (int)launch_interp_pt_eta<float>((const float*)table, in, (const int*)gpt2band, d, npress, tile, group,
                                          n_groups, (float*)out, (cudaStream_t)stream);
}

// Dynamic shared memory of one interp_pt_eta block (f32).
extern "C" long long rrtmgp_interp_pt_eta_smem(int tile, int nbnd) {
  return (long long)rrtmgp::InterpSmem<float>(tile, nbnd).total;
}

namespace rrtmgp {

// The most threads a block of interp_pt_eta may have (errors.cu
// rrtmgp_max_threads); variant is 0.
cudaError_t interp_pt_eta_max_threads(int, int* threads) { return max_threads(threads, interp_pt_eta_kernel<float>); }

}  // namespace rrtmgp
