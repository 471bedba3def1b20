// SW two-stream sweeps from materialized optics: fluxes summed over g-points
// or kept per g-point.
//
// Replaces: rrtmgp_tpu/ops/pallas_rte.py, _sw_sweep_reduced_kernel and
//   _sw_sweep_reduced_stream_kernel (wrapper sw_2stream_pallas_reduced; the
//   two TPU kernels compute one function, blocked or streamed to fit VMEM;
//   here sw_2stream_reduced_kernel) and _sw_sweep_kernel (wrapper
//   sw_2stream_pallas; here sw_2stream_gpt_kernel, see the end of Design):
//   the direct beam from the top, the PIFM / Meador-Weaver layer coefficients
//   with their energy clamps, the adding recurrence from the surface, the
//   diffuse flux from the top, and the g-point sums of up, down and direct
//   flux at every level. The asymmetry g is optional: a null pointer is the
//   clear-sky case g = 0 (the TPU kernel's has_g=False), which saves reading
//   one (nlay, ncol, ngpt) tensor.
//
// Bound on this card: device memory. At 32768 columns x 60 layers x 224
//   g-points tau and ssa are 2 x 1.76 GB (g a third), the outputs 24 MB:
//   1.1 ms at 3.35 TB/s (1.6 ms with g). The summed design's own scratch
//   adds three (nlay, ncol, ngpt) passes: the beam written (top-down), read
//   with tau and ssa while the albedo and the source are written
//   (bottom-up), those two read with tau and ssa again (top-down): 44 bytes
//   a point without g, 19.4 GB, 5.8 ms. Per point five exp, two sqrt and
//   nine divides (the beam transmittance in every pass, the coefficients and
//   the adding denominator in passes 2 and 3).
//
// Design: one block per column, one thread per g-point (more than 1024: a
//   column's g-points over several blocks of the host's launch plan, the
//   level sums completed by finish_level_sums), in three passes, as the TPU
//   kernel and lw_2stream_reduced.cu are structured:
//   1. top-down: the direct beam, each layer's top value stored, and the
//      SW_DIR level sums;
//   2. bottom-up: the adding recurrence in registers; each layer's
//      coefficients computed from tau, ssa (and g) and its stored beam, the
//      albedo and the source at its bottom level stored;
//   3. top-down: the coefficients, the beam (beam *= T0, pass 1's order) and
//      the adding denominator computed again, the diffuse flux folded as
//      the megakernel folds it (tdif' = Tdif * denom, rdif' = denom * (Rdif
//      * src + Tdir * beam), fd = tdif' * fd + rdif'), and the SW_UP /
//      SW_DN_DIF sums.
//   Every pass reads the next layer's inputs (tau; tau, ssa, g and the
//   stored beam; tau, ssa, g and the stored albedo and source) one layer
//   ahead, so that the loads overlap the current layer's arithmetic:
//   without it the kernel waited on each layer's loads (11.2 against 8.1
//   ms, PERF.md).
//   The coefficient function is sw_twostream.cuh's sw_coeffs, and every
//   value is formed by the expressions of the SW megakernel's passes, so the
//   two routes agree to the last bit on equal optics. Passes 2 and 3 are
//   those of sw_twostream.cuh's sw_recomputed_passes (there without g),
//   which the SW megakernel runs on clear sky; this kernel keeps them
//   inline, because calling that function took it from 53-56 to 57-62
//   registers and 8.2 to 8.7 ms (PERF.md). The scratch is two (nlay, ncol, ngpt) arrays
//   in device memory: the beam, whose slot pass 2 reads before it writes
//   the albedo there (a layer ahead), and the source. A third array for the
//   albedo moved the same bytes and took 1.76 GB more at 32768 x 60 x 224
//   (PERF.md). Storing the coefficients instead (Rdir * beam, Tdir * beam,
//   Rdif and Tdif in four arrays rewritten by the adding pass, as the SW
//   megakernel does all-sky) would move 72 bytes a point instead of 44.
//   mu0 guarded by eps enters
//   only the beam transmittance. Night columns (mu0 <= 0) give finite or
//   non-finite values that the caller replaces by zeros. The real type and
//   has_g are template parameters (the entry points build f32). Nothing of
//   the TPU kernels' structure is kept: no column blocks, no lane padding,
//   no streaming ring buffer.
//   sw_2stream_gpt is the same transport without the g-point sums, in a
//   kernel of its own with the same three passes: mu0 and the albedos come
//   per g-point, (ncol, ngpt), as the TPU function takes them, and the
//   state lives in the thread's own slots of its outputs, (nlev, ncol, ngpt)
//   each, so the kernel needs no scratch and no shared memory. Pass 1
//   writes every level's beam to flux_dir; pass 2 reads the beam at each
//   layer's top from flux_dir[l + 1] and writes the albedo and the source at
//   level l (0 included) into flux_up[l] and flux_dn[l]; pass 3 reads them
//   back and overwrites them with up = fd * alb + src and dn = fd + beam,
//   the beam recomputed (beam *= T0, pass 1's bits), so it reads no
//   flux_dir. The slots are written and read by one thread, never through
//   the read-only (__ldg) path, which may serve a stale line. Per point
//   without g: 8 bytes (tau, the beam), 20 (tau, ssa, the beam, albedo and
//   source) and 24 (tau, ssa, albedo, source, up, down): 52 B, 22.9 GB at
//   32768 x 60 x 224, a 6.8 ms floor at 3.35 TB/s (60 B and 7.9 ms with g),
//   against the bound's 20 B (3 x 1.79 GB of outputs beside 3 x 1.76 GB of
//   inputs: 10.7 GB, 3.2 ms). The albedo and source of the bottom C levels
//   (the host's plan, ops/rte_kernels.py sw_2stream_gpt_design) stay in
//   shared memory instead, 8 bytes a level and thread: 52 - 16 C / nlay B a
//   point. C = 24 ran fastest at that size; more shared memory a block cost
//   more resident blocks than the bytes it saved (PERF.md). Storing the coefficients instead (Rdir *
//   beam, Tdir * beam, Rdif, Tdif in four arrays rewritten by the adding
//   pass, as the SW megakernel does all-sky) moves 88 B a point and holds
//   7.0 GB of scratch at that size (PERF.md).
#include "common.cuh"
#include "sw_twostream.cuh"

namespace rrtmgp {

// The g-summed sweep: the three passes of Design.
template <typename R, bool HAS_G, bool SPLIT>
__global__ void sw_2stream_reduced_kernel(const R* __restrict__ tau,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ ssa,        // (nlay, ncol, ngpt)
                                          const R* __restrict__ gasym,      // (nlay, ncol, ngpt), HAS_G
                                          const R* __restrict__ mu0_col,    // (ncol,)
                                          const R* __restrict__ toa_gpt,    // (ncol, ngpt)
                                          const R* __restrict__ alb_dir,    // (nbnd, ncol)
                                          const R* __restrict__ alb_dif,    // (nbnd, ncol)
                                          const int* __restrict__ gpt2band,  // (ngpt,)
                                          const R* __restrict__ inc_dif,    // (ncol, ngpt) or null
                                          R* s_beam,                        // (nlay, ncol, ngpt): beam at the top,
                                                                            // then albedo at the bottom
                                          R* __restrict__ s_src,            // source at the bottom
                                          R* __restrict__ flux_up,          // 3 x (nlev, ncol)
                                          R* __restrict__ flux_dn,
                                          R* __restrict__ flux_dir,
                                          R* __restrict__ partials,         // null: sums in the block
                                          Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  const bool active = g < d.ngpt;
  const int nlay = d.nlay;
  const auto sums = level_sums<R, SPLIT>(reinterpret_cast<R*>(smem_raw), partials, nlay + 1);
  // this thread's (col, g) in every (nlay, ncol, ngpt) array; layer l at
  // [l * stride]
  const size_t stride = (size_t)d.ncol * d.ngpt, g0 = (size_t)col * d.ngpt + g;
  const R *tau_p = tau + g0, *ssa_p = ssa + g0, *g_p = HAS_G ? gasym + g0 : nullptr;
  R *beam_p = s_beam + g0, *alb_p = beam_p, *src_p = s_src + g0;
  const int band = active ? __ldg(gpt2band + g) : 0;
  const R mu0 = __ldg(mu0_col + col);
  const R mu0_safe = r_max(mu0, r_eps<R>());
  const R beam_toa = active ? __ldg(toa_gpt + g0) * mu0 : R(0);

  // 1. top-down: the beam at each layer's top to scratch
  R beam = beam_toa;
  sums.add(SW_DIR, nlay, beam);
  R t1 = (active && nlay > 0) ? __ldg(tau_p + (size_t)(nlay - 1) * stride) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    if (active) {
      const size_t s = (size_t)l * stride;
      const R t = t1;
      if (l > 0) t1 = __ldg(tau_p + s - stride);
      beam_p[s] = beam;
      beam *= r_exp(-t / mu0_safe);
    }
    sums.add(SW_DIR, l, beam);
  }

  // 2. bottom-up adding: the albedo and source at each layer's bottom level
  // to scratch (the beam's slot is read, a layer ahead, before the albedo's
  // is written)
  R alb = active ? __ldg(alb_dif + (size_t)band * d.ncol + col) : R(0);
  R src = active ? beam * __ldg(alb_dir + (size_t)band * d.ncol + col) : R(0);
  if (active && nlay > 0) {
    R t_n = __ldg(tau_p), w_n = __ldg(ssa_p), g_n = HAS_G ? __ldg(g_p) : R(0), bt_n = beam_p[0];
    for (int l = 0; l < nlay; ++l) {
      const size_t s = (size_t)l * stride;
      const R t = t_n, w = w_n, gg = g_n, bt = bt_n;
      if (l + 1 < nlay) {
        t_n = __ldg(tau_p + s + stride);
        w_n = __ldg(ssa_p + s + stride);
        if (HAS_G) g_n = __ldg(g_p + s + stride);
        bt_n = beam_p[s + stride];
      }
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, w, gg, mu0, r_exp(-t / mu0_safe), Rdir, Tdir, Rdif, Tdif);
      alb_p[s] = alb;
      src_p[s] = src;
      const R denom = R(1) / (R(1) - Rdif * alb);
      const R alb_n = Rdif + Tdif * Tdif * alb * denom;
      const R src_n = Rdir * bt + Tdif * denom * (src + alb * (Tdir * bt));
      alb = alb_n;
      src = src_n;
    }
  }

  // 3. top-down diffuse flux, the coefficients and the beam again, the
  // inputs a layer ahead
  R fd = (active && inc_dif != nullptr) ? inc_dif[g0] : R(0);
  sums.add(SW_UP, nlay, active ? fd * alb + src : R(0));
  sums.add(SW_DN_DIF, nlay, fd);
  beam = beam_toa;
  R t_n = R(0), w_n = R(0), g_n = R(0), a_n = R(0), c_n = R(0);
  if (active && nlay > 0) {
    const size_t s = (size_t)(nlay - 1) * stride;
    t_n = __ldg(tau_p + s);
    w_n = __ldg(ssa_p + s);
    if (HAS_G) g_n = __ldg(g_p + s);
    a_n = alb_p[s];
    c_n = src_p[s];
  }
  for (int l = nlay - 1; l >= 0; --l) {
    R up = R(0);
    if (active) {
      const size_t s = (size_t)l * stride;
      const R t = t_n, w = w_n, gg = g_n, alb_l = a_n, src_l = c_n;
      if (l > 0) {
        t_n = __ldg(tau_p + s - stride);
        w_n = __ldg(ssa_p + s - stride);
        if (HAS_G) g_n = __ldg(g_p + s - stride);
        a_n = alb_p[s - stride];
        c_n = src_p[s - stride];
      }
      const R T0 = r_exp(-t / mu0_safe);
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, w, gg, mu0, T0, Rdir, Tdir, Rdif, Tdif);
      const R denom = R(1) / (R(1) - Rdif * alb_l);
      fd = (Tdif * denom) * fd + denom * (Rdif * src_l + Tdir * beam);
      up = fd * alb_l + src_l;
      beam *= T0;
    }
    sums.add(SW_UP, l, up);
    sums.add(SW_DN_DIF, l, fd);
  }

  if constexpr (!SPLIT) {
    __syncthreads();
    for (int lev = threadIdx.x; lev <= nlay; lev += blockDim.x) {
      const size_t o = (size_t)lev * d.ncol + col;
      const R dir = sums.total(SW_DIR, lev);
      flux_up[o] = sums.total(SW_UP, lev);
      flux_dn[o] = sums.total(SW_DN_DIF, lev) + dir;
      flux_dir[o] = dir;
    }
  }
}

// The per-g-point sweep: the three passes of Design, each thread's state in
// its own slots of the outputs (no scratch), the albedo and source of the
// bottom nsm levels in shared memory, [2][nsm][blockDim.x].
template <typename R, bool HAS_G, bool SPLIT>
__global__ void sw_2stream_gpt_kernel(const R* __restrict__ tau,      // (nlay, ncol, ngpt)
                                      const R* __restrict__ ssa,      // (nlay, ncol, ngpt)
                                      const R* __restrict__ gasym,    // (nlay, ncol, ngpt), HAS_G
                                      const R* __restrict__ mu0_gpt,  // (ncol, ngpt)
                                      const R* __restrict__ toa_gpt,  // (ncol, ngpt)
                                      const R* __restrict__ alb_dir,  // (ncol, ngpt)
                                      const R* __restrict__ alb_dif,  // (ncol, ngpt)
                                      const R* __restrict__ inc_dif,  // (ncol, ngpt) or null
                                      R* __restrict__ flux_up,        // 3 x (nlev, ncol, ngpt): albedo, then up
                                      R* __restrict__ flux_dn,        // source, then diffuse + direct down
                                      R* __restrict__ flux_dir,       // the beam, written by pass 1
                                      Dims d, int nsm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int col = blockIdx.x;
  const int g = gpoint<SPLIT>();
  if (g >= d.ngpt) return;  // no level sums: an idle thread has nothing to add
  const int nlay = d.nlay;
  // this thread's (col, g) in every (nlay or nlev, ncol, ngpt) array; layer
  // or level l at [l * stride]. flux_up / flux_dn / flux_dir are written and
  // read back by this thread alone, never through the read-only path.
  const size_t stride = (size_t)d.ncol * d.ngpt, g0 = (size_t)col * d.ngpt + g;
  const R *tau_p = tau + g0, *ssa_p = ssa + g0, *g_p = HAS_G ? gasym + g0 : nullptr;
  R *up_p = flux_up + g0, *dn_p = flux_dn + g0, *dir_p = flux_dir + g0;
  // level l < nsm: its albedo at sm[l * bd], its source at sm[(nsm + l) * bd]
  R* sm = reinterpret_cast<R*>(smem_raw) + threadIdx.x;
  const size_t bd = blockDim.x;
  const R mu0 = __ldg(mu0_gpt + g0);
  const R mu0_safe = r_max(mu0, r_eps<R>());
  const R beam_toa = __ldg(toa_gpt + g0) * mu0;

  // 1. top-down: the beam of every level to flux_dir
  R beam = beam_toa;
  dir_p[(size_t)nlay * stride] = beam;
  R t1 = nlay > 0 ? __ldg(tau_p + (size_t)(nlay - 1) * stride) : R(0);
  for (int l = nlay - 1; l >= 0; --l) {
    const size_t s = (size_t)l * stride;
    const R t = t1;
    if (l > 0) t1 = __ldg(tau_p + s - stride);
    beam *= r_exp(-t / mu0_safe);
    dir_p[s] = beam;
  }

  // 2. bottom-up adding: each layer's coefficients from tau, ssa (g) and the
  // beam at its top, flux_dir[l + 1]; the albedo and the source at its
  // bottom level l to flux_up[l] and flux_dn[l] (the bottom nsm levels to
  // shared memory)
  R alb = __ldg(alb_dif + g0);
  R src = beam * __ldg(alb_dir + g0);
  if (nlay > 0) {
    R t_n = __ldg(tau_p), w_n = __ldg(ssa_p), g_n = HAS_G ? __ldg(g_p) : R(0), bt_n = dir_p[stride];
    for (int l = 0; l < nlay; ++l) {
      const size_t s = (size_t)l * stride;
      const R t = t_n, w = w_n, gg = g_n, bt = bt_n;
      if (l + 1 < nlay) {
        t_n = __ldg(tau_p + s + stride);
        w_n = __ldg(ssa_p + s + stride);
        if (HAS_G) g_n = __ldg(g_p + s + stride);
        bt_n = dir_p[s + 2 * stride];
      }
      R Rdir, Tdir, Rdif, Tdif;
      sw_coeffs(t, w, gg, mu0, r_exp(-t / mu0_safe), Rdir, Tdir, Rdif, Tdif);
      if (l < nsm) {
        sm[l * bd] = alb;
        sm[(nsm + l) * bd] = src;
      } else {
        up_p[s] = alb;
        dn_p[s] = src;
      }
      const R denom = R(1) / (R(1) - Rdif * alb);
      const R alb_n = Rdif + Tdif * Tdif * alb * denom;
      const R src_n = Rdir * bt + Tdif * denom * (src + alb * (Tdir * bt));
      alb = alb_n;
      src = src_n;
    }
  }

  // 3. top-down diffuse flux, the coefficients and the beam again; level
  // l's albedo and source read from its slots, then overwritten by its
  // fluxes
  R fd = inc_dif != nullptr ? inc_dif[g0] : R(0);
  up_p[(size_t)nlay * stride] = fd * alb + src;
  dn_p[(size_t)nlay * stride] = fd + beam_toa;
  beam = beam_toa;
  R t_n = R(0), w_n = R(0), g_n = R(0), a_n = R(0), c_n = R(0);
  if (nlay > 0) {
    const size_t s = (size_t)(nlay - 1) * stride;
    t_n = __ldg(tau_p + s);
    w_n = __ldg(ssa_p + s);
    if (HAS_G) g_n = __ldg(g_p + s);
    if (nlay - 1 < nsm) {
      a_n = sm[(nlay - 1) * bd];
      c_n = sm[(nsm + nlay - 1) * bd];
    } else {
      a_n = up_p[s];
      c_n = dn_p[s];
    }
  }
  for (int l = nlay - 1; l >= 0; --l) {
    const size_t s = (size_t)l * stride;
    const R t = t_n, w = w_n, gg = g_n, alb_l = a_n, src_l = c_n;
    if (l > 0) {
      t_n = __ldg(tau_p + s - stride);
      w_n = __ldg(ssa_p + s - stride);
      if (HAS_G) g_n = __ldg(g_p + s - stride);
      if (l - 1 < nsm) {
        a_n = sm[(l - 1) * bd];
        c_n = sm[(nsm + l - 1) * bd];
      } else {
        a_n = up_p[s - stride];
        c_n = dn_p[s - stride];
      }
    }
    const R T0 = r_exp(-t / mu0_safe);
    R Rdir, Tdir, Rdif, Tdif;
    sw_coeffs(t, w, gg, mu0, T0, Rdir, Tdir, Rdif, Tdif);
    const R denom = R(1) / (R(1) - Rdif * alb_l);
    fd = (Tdif * denom) * fd + denom * (Rdif * src_l + Tdir * beam);
    beam *= T0;
    up_p[s] = fd * alb_l + src_l;
    dn_p[s] = fd + beam;
  }
}

// group, n_groups, in_block: the host's launch plan; partials (3, nlev,
// ncol, column's warps) unless in_block, else null.
template <typename R, bool HAS_G>
cudaError_t launch_sw_reduced(const Dims& d, int group, int n_groups, bool in_block, cudaStream_t stream, const R* tau,
                              const R* ssa, const R* gasym, const R* mu0, const R* toa_gpt, const R* alb_dir,
                              const R* alb_dif, const int* gpt2band, const R* inc_dif, R* s_beam, R* s_src,
                              R* up, R* dn, R* dir, R* partials) {
  const MegaLaunch m = group_launch<R>(d, 3, group, n_groups, in_block);
  auto kernel = in_block ? sw_2stream_reduced_kernel<R, HAS_G, false> : sw_2stream_reduced_kernel<R, HAS_G, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(tau, ssa, gasym, mu0, toa_gpt, alb_dir, alb_dif, gpt2band, inc_dif,
                                              s_beam, s_src, up, dn, dir, in_block ? nullptr : partials, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || in_block) return err;
  return finish_sums<R>(stream, partials, 3, d.nlay + 1, d.ncol, n_groups * group / 32, SUMS_SW, R(1), up, dn, dir);
}

template <typename R, bool HAS_G>
cudaError_t launch_sw_gpt(const Dims& d, int nsm, int group, int n_groups, cudaStream_t stream, const R* tau,
                          const R* ssa, const R* gasym, const R* mu0, const R* toa_gpt, const R* alb_dir,
                          const R* alb_dif, const R* inc_dif, R* up, R* dn, R* dir) {
  const MegaLaunch m = group_launch<R>(d, 0, group, n_groups, n_groups == 1, bottom_state_bytes<R>(nsm, group));
  auto kernel = n_groups == 1 ? sw_2stream_gpt_kernel<R, HAS_G, false> : sw_2stream_gpt_kernel<R, HAS_G, true>;
  cudaError_t err = prepare_smem(kernel, m.smem);
  if (err != cudaSuccess) return err;
  kernel<<<m.grid, m.block, m.smem, stream>>>(tau, ssa, gasym, mu0, toa_gpt, alb_dir, alb_dif, inc_dif, up, dn, dir,
                                              d, nsm);
  return cudaGetLastError();
}

}  // namespace rrtmgp

// Summed over g-points, f32: mu0 (ncol,), albedos (nbnd, ncol) with
// gpt2band, fluxes (nlev, ncol); gasym null = asymmetry 0, inc_dif null = no
// incident diffuse flux. Scratch (nlay, ncol, ngpt) each: s_beam (then the
// albedo), s_src. group, n_groups, in_block: the launch plan; partials (3,
// nlev, ncol, column's warps) unless in_block, else null.
extern "C" int rrtmgp_sw_2stream_reduced(const void* tau, const void* ssa, const void* gasym, const void* mu0,
                                         const void* toa_gpt, const void* alb_dir, const void* alb_dif,
                                         const void* gpt2band, const void* inc_dif, void* s_beam, void* s_src,
                                         void* flux_up, void* flux_dn, void* flux_dir, void* partials, int nlay,
                                         int ncol, int ngpt, int nbnd, int group, int n_groups, int in_block,
                                         void* stream) {
  using namespace rrtmgp;
  const Dims d{nlay, ncol, ngpt, nbnd, 0, 0, 0};
  auto launch = gasym != nullptr ? launch_sw_reduced<float, true> : launch_sw_reduced<float, false>;
  return (int)launch(d, group, n_groups, in_block != 0, (cudaStream_t)stream, (const float*)tau, (const float*)ssa,
                     (const float*)gasym, (const float*)mu0, (const float*)toa_gpt, (const float*)alb_dir,
                     (const float*)alb_dif, (const int*)gpt2band, (const float*)inc_dif, (float*)s_beam,
                     (float*)s_src, (float*)flux_up, (float*)flux_dn, (float*)flux_dir, (float*)partials);
}

// Per g-point, f32: mu0 and albedos (ncol, ngpt), fluxes (nlev, ncol, ngpt),
// which also hold the state of the passes: no scratch. nsm: the bottom
// levels whose albedo and source stay in shared memory, 0 to nlay (else
// cudaErrorInvalidValue); group, n_groups: the host's launch plan, which
// counts that memory (bottom_state_bytes).
extern "C" int rrtmgp_sw_2stream_gpt(const void* tau, const void* ssa, const void* gasym, const void* mu0,
                                     const void* toa_gpt, const void* alb_dir, const void* alb_dif,
                                     const void* inc_dif, void* flux_up, void* flux_dn, void* flux_dir, int nlay,
                                     int ncol, int ngpt, int nsm, int group, int n_groups, void* stream) {
  using namespace rrtmgp;
  if (nsm < 0 || nsm > nlay) return (int)cudaErrorInvalidValue;
  const Dims d{nlay, ncol, ngpt, 0, 0, 0, 0};
  auto launch = gasym != nullptr ? launch_sw_gpt<float, true> : launch_sw_gpt<float, false>;
  return (int)launch(d, nsm, group, n_groups, (cudaStream_t)stream, (const float*)tau, (const float*)ssa,
                     (const float*)gasym, (const float*)mu0, (const float*)toa_gpt, (const float*)alb_dir,
                     (const float*)alb_dif, (const float*)inc_dif, (float*)flux_up, (float*)flux_dn,
                     (float*)flux_dir);
}

namespace rrtmgp {

// The most threads a block of sw_2stream_reduced / sw_2stream_gpt may have,
// both variants of each (errors.cu rrtmgp_max_threads): variant = has_g.
cudaError_t sw_2stream_reduced_max_threads(int variant, int* threads) {
  return variant ? max_threads(threads, sw_2stream_reduced_kernel<float, true, false>,
                               sw_2stream_reduced_kernel<float, true, true>)
                 : max_threads(threads, sw_2stream_reduced_kernel<float, false, false>,
                               sw_2stream_reduced_kernel<float, false, true>);
}

cudaError_t sw_2stream_gpt_max_threads(int variant, int* threads) {
  return variant ? max_threads(threads, sw_2stream_gpt_kernel<float, true, false>,
                               sw_2stream_gpt_kernel<float, true, true>)
                 : max_threads(threads, sw_2stream_gpt_kernel<float, false, false>,
                               sw_2stream_gpt_kernel<float, false, true>);
}

}  // namespace rrtmgp
