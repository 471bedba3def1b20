"""The work of a solve, whatever implements it, and the card's peaks: the
numerators and denominators of the roofline shares.

Frozen from the port's ``utils/perf_accounting.py`` (``algorithmic_flops``
and the H100 figures), so that a change to the program cannot change the
yardstick. Operations are the arithmetic the RRTMGP algorithm needs per
(layer, column, g-point), a lower bound; bytes are the solve's inputs, its
tables and its fluxes, each counted once.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bytes per second, and f32 and f64
#: operations per second outside the tensor cores (700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 33.5e12


def algorithmic_flops(meta: dict, ngpt: int, ncol: int, nlay: int, longwave: bool, two_stream: bool) -> int:
    """Operations of one whole gas-optics + transport solve (one quadrature
    angle), counted per (layer, column, g-point) from the reference's
    scalar kernels: the trilinear major interpolation (21), the minor gases
    over the smaller side's coverage (11), the Planck fraction and sources
    (20 + 4) or Rayleigh (12), and the transport with its reduction. Work
    per (layer, column, band) is amortised to zero: a lower bound."""
    e = ncol * nlay * ngpt
    f = 21 * e
    cover = [sum(g1 - g0 for gas, _, _, _, g0, g1, _ in meta[side] if gas != 0)
             for side in ("minor_lower", "minor_upper")]
    f += 11 * ncol * nlay * min(cover)
    if longwave:
        f += (20 + 4) * e
        f += (36 + 18 + 2) * e if two_stream else (2 + 3 + 12 + 4 + 2) * e
    else:
        f += (10 + 2) * e
        f += (68 + 4 + 18 + 3) * e if two_stream else (4 + 1) * e
    return f


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for k, v in tree.items() if k != "meta")
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


#: state fields each solve reads
_LW_STATE = ("p_lay", "t_lay", "t_lev", "t_sfc", "col_dry", "vmr_h2o", "vmr_o3", "vmr_gm")
_SW_STATE = ("p_lay", "t_lay", "col_dry", "vmr_h2o", "vmr_o3", "vmr_gm")


def solve_bytes(tables: dict, state: dict, bcs: dict, longwave: bool) -> int:
    """Device-memory bytes of one solve counted once: the state it reads
    (clouds and aerosols when present), its boundary values, its tables
    and its flux outputs (up, down; SW also direct) at every level."""
    wave = "lw" if longwave else "sw"
    n = sum(_nbytes(state[k]) for k in (_LW_STATE if longwave else _SW_STATE))
    n += _nbytes(state.get("cloud", {})) + _nbytes(state.get("aerosol", {})) + _nbytes(state.get("rel_hum", {}))
    n += sum(_nbytes(bcs[k]) for k in (("sfc_emis",) if longwave else
                                        ("cos_zenith", "toa_flux", "sfc_alb_direct", "sfc_alb_diffuse")))
    n += sum(_nbytes(tables[k]) for k in (wave, f"{wave}_cld", f"{wave}_aero") if k in tables)
    nlev, ncol = state["p_lev"].shape
    return n + (2 if longwave else 3) * nlev * ncol * state["p_lay"].element_size()


def step_work(cfg: dict, traffic: dict, inputs: dict) -> dict:
    """{"lw": (ops, bytes), "sw": (ops, bytes)} of one step of the cell."""
    t, st, b = inputs["tables"], inputs["states"][0], inputs["bcs"]
    ncol, nlay = cfg["ncol"], cfg["nlay"]
    two_stream_lw = traffic["solver"].get("two_stream_lw", True)
    return {
        "lw": (algorithmic_flops(t["lw"]["meta"], cfg["lw"]["n_gpt"], ncol, nlay, True, two_stream_lw),
               solve_bytes(t, st, b, True)),
        "sw": (algorithmic_flops(t["sw"]["meta"], cfg["sw"]["n_gpt"], ncol, nlay, False, True),
               solve_bytes(t, st, b, False)),
    }


def least_seconds(ops: int, nbytes: int, peak_ops_per_s: float = PEAK_F32_OPS_PER_S) -> float:
    """The least time the card could take: operations at the peak (f32
    unless given) or bytes at the memory rate, the larger."""
    return max(ops / peak_ops_per_s, nbytes / HBM_BYTES_PER_S)
