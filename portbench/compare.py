"""The comparison that decides ``correct``: the fluxes of steps that the
window produced against the plain reference of the same steps, computed
again from the benchmark's inputs in float64, block of columns by block.

Each number is the widest gap over a wave's flux fields (LW up and down;
SW up, down and direct down) and over the checked steps, as a share of
the wave's largest reference flux (the SW down flux at the top, the LW up
flux near the surface): ``max |out - ref| / max |ref|``. One scale per
wave, so that a field of small values (SW up) is judged in the units of
the flux that drives it. A field that holds a NaN or an infinity reads
infinity.
"""

from __future__ import annotations

import math

import torch

from . import reference

NUMBERS = {"lw_flux_err": ("lw_up", "lw_dn"), "sw_flux_err": ("sw_up", "sw_dn", "sw_dir")}
#: reference memory per column, in (layer, g-point) float64 elements, at
#: the peak of its largest solve (LW two-stream), with room
REF_ELEMENTS_PER_POINT = 48


def block_columns(cfg: dict, device) -> int:
    """Columns per reference block: a power of two whose float64 solve
    fits in half of the card's free memory; the whole width on the CPU."""
    ncol = cfg["ncol"]
    if torch.device(device).type != "cuda":
        return ncol
    per_col = cfg["nlay"] * max(cfg["lw"]["n_gpt"], cfg["sw"]["n_gpt"]) * 8 * REF_ELEMENTS_PER_POINT
    fit = max(int(0.5 * torch.cuda.mem_get_info()[0] // per_col), 1)
    return min(ncol, 1 << (fit.bit_length() - 1))


def step_errors(inputs: dict, cfg: dict, traffic: dict, checked: list, candidate=None,
                cdt=torch.float64) -> list:
    """Per checked step, (global step, state index, fluxes) each, its
    widest gaps against the reference in ``cdt``. ``candidate(step, k, lo,
    hi)``, when given, stands in for the fluxes (the control)."""
    two_stream = traffic["solver"].get("two_stream_lw", True)
    ncol, block = cfg["ncol"], block_columns(cfg, inputs["bcs"]["toa_flux"].device)
    per_step = []
    for step, k, fluxes in checked:
        gap = {f: 0.0 for fs in NUMBERS.values() for f in fs}
        scale = dict(gap)
        for lo in range(0, ncol, block):
            hi = min(lo + block, ncol)
            ref = reference.step_fluxes(inputs["tables"], inputs["states"][k], inputs["bcs"], two_stream,
                                        step, lo, hi, cdt)
            got = candidate(step, k, lo, hi) if candidate else {f: v[:, lo:hi] for f, v in fluxes.items()}
            for f in gap:
                x = got[f].to(cdt)
                d = (x - ref[f]).abs().max().item() if bool(torch.isfinite(x).all()) else math.inf
                gap[f] = max(gap[f], d)
                scale[f] = max(scale[f], ref[f].abs().max().item())
            del ref, got
        per_step.append({name: max(gap[f] for f in fields) / max(max(scale[f] for f in fields), 1e-30)
                         for name, fields in NUMBERS.items()})
    return per_step


def worst(per_step: list) -> dict:
    """Each number's largest reading over the checked steps."""
    return {name: max(s[name] for s in per_step) for name in NUMBERS}


#: the precision below each configuration dtype, in which the control computes
PRECISION_BELOW = {"float32": torch.bfloat16, "float64": torch.float32}


def control_dtype(cfg: dict) -> torch.dtype:
    """The control's precision: the one below the configuration's dtype."""
    return PRECISION_BELOW[cfg["dtype"]]


def control(inputs: dict, cfg: dict, traffic: dict, checked: list) -> dict:
    """The control: the reference computed in the precision below the
    configuration's (``control_dtype``) in the program's place."""
    cdt = control_dtype(cfg)
    two_stream = traffic["solver"].get("two_stream_lw", True)
    low = lambda step, k, lo, hi: reference.step_fluxes(
        inputs["tables"], inputs["states"][k], inputs["bcs"], two_stream, step, lo, hi, cdt)
    return worst(step_errors(inputs, cfg, traffic, checked, candidate=low))
