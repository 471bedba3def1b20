"""Machine-utilization accounting for the port's solves (counterpart of
``rrtmgp_tpu/utils/perf_accounting.py``).

- **Memory roofline**: bytes that must cross device memory in one solve
  (inputs read once, outputs written once, tables read once,
  intermediates written and read = 2x), ``solve_hbm_bytes``, over the
  card's memory rate gives the bandwidth-bound minimum time.
- **Algorithmic FLOPs**: ``algorithmic_flops``, the arithmetic the RRTMGP
  algorithm demands, the same number the JAX package computes for the same
  lookup.

The card's figures are those of an NVIDIA H100 SXM (data sheet): 3.35 TB/s
of HBM3 and 67 TFLOP/s f32 / 33.5 TFLOP/s f64 outside the tensor cores;
``chip_smoke.py``'s kernel bounds read them from here. The JAX package's
``mega_mxu_flops`` is not ported: it counts the TPU megakernels' one-hot MXU
contractions (the table gathers done as matmuls), which the port's kernels
do not have; they gather from the tables directly.
"""

from __future__ import annotations

from ..states import tree_leaves

#: NVIDIA H100 SXM: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
#: NVIDIA H100 SXM: peak operations per second outside the tensor cores, by type
PEAK_OPS_PER_S = {"f32": 67e12, "f64": 33.5e12}


def tree_bytes(tree) -> int:
    """Total tensor bytes of a container, tuple or namedtuple tree
    (``states.tree_leaves``)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def solve_hbm_bytes(inputs, outputs, tables, intermediates) -> int:
    """Device-memory traffic of one solve: inputs + outputs + tables (read
    once) + 2x the intermediates (written then read)."""
    return (
        tree_bytes(inputs)
        + tree_bytes(outputs)
        + tree_bytes(tables)
        + 2 * tree_bytes(intermediates)
    )


def algorithmic_flops(lkp, ncol: int, nlay: int, longwave: bool,
                      two_stream: bool) -> int:
    """PHYSICS-REQUIRED FLOPs of one whole solve — the numerator of
    ``mfu_algorithmic``.

    Counts only the arithmetic the RRTMGP algorithm itself demands per
    (layer, column, g-point), read off the reference's scalar kernels
    (RRTMGP.jl src/optics/gas_optics.jl:166-335, src/rte/*.jl): the
    8-point trilinear major interpolation, minor-gas 2x2 interpolations and
    scaling laws, Rayleigh, Planck sources, transport recurrences, and the
    spectral flux reduction. One-hot gather lanes, band->g-point expand dots,
    and every form of padding are EXCLUDED — this is what a hypothetical
    perfectly-lean implementation would execute. Conventions (documented so
    the number is reproducible): mul/add/sub/div/select = 1 FLOP each,
    exp/sqrt = 1; per-(layer, column, band) weight precomputation is
    amortized to 0 against the ~16 g-points per band; minor-gas coverage
    uses min(lower-side, upper-side) interval-g-point counts — each layer
    runs exactly one side, so this is a strict lower bound regardless of
    where the tropopause falls. Result: a LOWER bound on required FLOPs,
    hence mfu_algorithmic is a lower bound on how well ANY implementation
    of this physics could use the chip at the measured time.
    """
    ngpt = lkp.n_gpt
    e = ncol * nlay * ngpt  # elements per spectral tensor

    # tau_major trilinear (interp3d, optics_utils.jl:123-149): 4 (press,temp)
    # corners x (eta lerp 3 + x combined weight 1 + accumulate 1) + col_dry
    f = 21 * e
    # minor gases (gas_optics.jl:255-306): per covered (gpt, interval):
    # eta lerp at 2 temp nodes (6) + temp combine (3) + x scaling + add (2);
    # coverage = min over tropo sides (each layer runs one side)
    cov_lower = sum(iv.gpt1 - iv.gpt0 for iv in lkp.minor_lower if iv.gas != 0)
    cov_upper = sum(iv.gpt1 - iv.gpt0 for iv in lkp.minor_upper if iv.gas != 0)
    f += 11 * ncol * nlay * min(cov_lower, cov_upper)

    if longwave:
        # planck fraction: trilinear without col_mix (4 x (3+1+1))
        f += 20 * e
        # sources (Optics.jl:228-248): lay = pfrac x band-Planck (1);
        # lev interior = sqrt + 2 mul (3); band 1-D interp amortized per band
        f += 4 * e
        if two_stream:
            # lw_2stream_coeffs (longwave2stream.jl:110-161): gammas 6,
            # k=sqrt 3, exp 2, rt 5, Rdif 3, Tdif 3, Toon sources ~14 => 36
            # + adding sweep (Shonk-Hogan, :182-254) ~18 + reduce 2
            f += (36 + 18 + 2) * e
        else:
            # Clough transport (longwave1scalar.jl:149-212): trans 2, fact 3,
            # src_dn/up 2x6, recurrences 2x2 + reduce 2
            f += (2 + 3 + 12 + 4 + 2) * e
    else:
        # Rayleigh (gas_optics.jl:324-335): 2 eta lerps 6 + temp combine 3 +
        # x (1+h2o)*col_dry 1; ssa = div + select
        f += (10 + 2) * e
        if two_stream:
            # sw_2stream_coeffs (shortwave2stream.jl:135-195): gammas 10,
            # a1/a2 6, k 4, exponentials 5, rt 5, Rdif/Tdif 6, Rdir/Tdir ~26,
            # clamps 4, direct sources 2 => ~68; direct beam cumulative-tau 4;
            # adding sweep ~18; reduce 3
            f += (68 + 4 + 18 + 3) * e
        else:
            f += (4 + 1) * e  # direct beam + reduce
    return f
