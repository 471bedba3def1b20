"""The system under test: ``rrtmgp_tpu_torch.api.RRTMGPSolver``, built from
copies of a cell's seeded inputs, and the copy of an atmospheric state into
the solver's own state tensors that starts every step.

A configuration with ``mesh`` (a number of cards) gets a solver over a
``ColumnMesh`` of that many entries, one a card, which splits the columns
over them; each card's copy-in then writes that card's columns from a copy
on the same card, and the fluxes come back split, to be gathered after the
window. A configuration with ``chunk_budget_gb`` builds its solver under
that memory budget for the f64 column chunks (the solver's
``$RRTMGP_CHUNK_BUDGET_GB``, set while it is built and then restored), so
that the run's environment does not change the chunks.

This is the only module of the harness that imports the port.
"""

from __future__ import annotations

import contextlib
import os

import torch

import rrtmgp_tpu_torch as rt
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.parallel.sharding import ColumnSharded, make_column_mesh


def _copy(tree):
    """The tensors of a dict tree cloned (the program gets its own copies of
    the inputs; the reference reads the originals)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def lookups(tables: dict) -> rt.LookupBundle:
    """The port's lookup bundle of a cell's tables."""
    t = _copy(tables)
    gas = lambda d: convert.gas_lookup_from_numpy(
        {k: v for k, v in d.items() if k != "meta"}, d["meta"], dtype=d["kmajor"].dtype, device=d["kmajor"].device)
    cld = lambda d: convert.cloud_lookup_from_numpy(
        {k: v for k, v in d.items() if k != "meta"}, d["meta"], dtype=d["liq"].dtype, device=d["liq"].device)
    aero = lambda d: convert.aerosol_lookup_from_numpy(
        {k: v for k, v in d.items() if k != "meta"}, d["meta"], dtype=d["dust"].dtype, device=d["dust"].device)
    return rt.LookupBundle(
        lookup_lw=gas(t["lw"]), lookup_sw=gas(t["sw"]),
        lookup_lw_cld=cld(t["lw_cld"]) if "lw_cld" in t else None,
        lookup_sw_cld=cld(t["sw_cld"]) if "sw_cld" in t else None,
        lookup_lw_aero=aero(t["lw_aero"]) if "lw_aero" in t else None,
        lookup_sw_aero=aero(t["sw_aero"]) if "sw_aero" in t else None,
    )


def atmosphere(state: dict) -> rt.AtmosphericState:
    """The port's atmospheric state holding copies of a state's tensors."""
    s = _copy(state)
    return convert.atmosphere_from_numpy(
        p_lay=s["p_lay"], t_lay=s["t_lay"], p_lev=s["p_lev"], t_lev=s["t_lev"], t_sfc=s["t_sfc"],
        col_dry=s["col_dry"], vmr_h2o=s["vmr_h2o"], vmr_o3=s["vmr_o3"], vmr_gm=s["vmr_gm"],
        rel_hum=s.get("rel_hum"), cloud_state=s.get("cloud"), aerosol_state=s.get("aerosol"),
        dtype=s["p_lay"].dtype, device=s["p_lay"].device,
    )


def devices(cfg: dict, device) -> list:
    """The devices a cell runs on: ``device`` alone, or with ``mesh`` one
    mesh entry a card, ``cuda:0`` to ``cuda:{mesh-1}`` (off the card, the
    one device repeated, as the CPU tests split the columns)."""
    n = cfg.get("mesh")
    if not n:
        return [device]
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(device)] * n


@contextlib.contextmanager
def _chunk_budget(gb):
    """``$RRTMGP_CHUNK_BUDGET_GB`` set to ``gb`` (unchanged where None), and
    restored on leaving."""
    key, was = "RRTMGP_CHUNK_BUDGET_GB", os.environ.get("RRTMGP_CHUNK_BUDGET_GB")
    if gb is not None:
        os.environ[key] = repr(gb)
    try:
        yield
    finally:
        if was is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = was


def solver(cfg: dict, traffic: dict, inputs: dict) -> rt.RRTMGPSolver:
    """``RRTMGPSolver`` of the configuration with the traffic's solver
    options, on a copy of the first state; with ``mesh``, over a column
    mesh of the cell's cards, given the whole state to split itself; with
    ``chunk_budget_gb``, under that f64 chunk budget."""
    tables, bcs = inputs["tables"], _copy(inputs["bcs"])
    atm = atmosphere(inputs["states"][0])
    options = dict(traffic["solver"])
    if cfg.get("mesh"):
        options["mesh"] = make_column_mesh(devices(cfg, atm.p_lay.device))
    if cfg["sky"] == "allsky":
        method = rt.AllSkyRadiation(aerosol_radiation=cfg["aerosols"])
    else:
        method = rt.ClearSkyRadiation(aerosol_radiation=cfg["aerosols"])
    with _chunk_budget(cfg.get("chunk_budget_gb")):
        return rt.RRTMGPSolver(
            rt.RRTMGPGridParams(nlay=cfg["nlay"], ncol=cfg["ncol"], dtype=atm.p_lay.dtype),
            method, rt.RRTMGPParameters(),
            rt.LwBCs(sfc_emis=bcs["sfc_emis"]),
            rt.SwBCs(cos_zenith=bcs["cos_zenith"], toa_flux=bcs["toa_flux"],
                     sfc_alb_direct=bcs["sfc_alb_direct"], sfc_alb_diffuse=bcs["sfc_alb_diffuse"]),
            atm, lookups=lookups(tables), **options,
        )


def _columns(tree, lo: int, hi: int, device):
    """Columns [lo, hi) of a state dict, copied to ``device`` (the
    global-mean vmr vector, which has no column axis, whole)."""
    if isinstance(tree, dict):
        return {k: v.to(device, copy=True) if k == "vmr_gm" else _columns(v, lo, hi, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[..., lo:hi].to(device, copy=True).contiguous()
    return tree


def copy_pairs(atm, state: dict) -> list:
    """(destination, source) pairs that write ``state`` into the solver's
    state ``atm`` in place, every tensor of it. On a mesh (``atm`` a
    ``ColumnSharded``) one set a mesh entry, whose sources are a copy of
    that entry's columns of ``state`` on the entry's own card, so that the
    copy-in never crosses cards."""
    if isinstance(atm, ColumnSharded):
        per = atm.ncol // len(atm.mesh)
        return [pair for part, lo, device in zip(atm.shards, atm.offsets, atm.devices)
                for pair in copy_pairs(part, _columns(state, lo, lo + per, device))]
    pairs = [(getattr(atm, k), state[k]) for k in ("p_lay", "t_lay", "p_lev", "t_lev", "t_sfc", "col_dry")]
    pairs += [(atm.vmr.vmr_h2o, state["vmr_h2o"]), (atm.vmr.vmr_o3, state["vmr_o3"]), (atm.vmr.vmr, state["vmr_gm"])]
    if "rel_hum" in state:
        pairs.append((atm.rel_hum, state["rel_hum"]))
    if "cloud" in state:
        cs = atm.cloud_state
        pairs += [(getattr(cs, k), state["cloud"][k])
                  for k in ("cld_r_eff_liq", "cld_r_eff_ice", "cld_path_liq", "cld_path_ice", "cld_frac")]
    if "aerosol" in state:
        ae = atm.aerosol_state
        pairs += [(ae.aero_size, state["aerosol"]["aero_size"]), (ae.aero_mass, state["aerosol"]["aero_mass"])]
    for dst, src in pairs:
        if (dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device
                or dst.data_ptr() == src.data_ptr()):
            raise ValueError(f"state copy: {tuple(src.shape)} {src.dtype} on {src.device} "
                             f"into {tuple(dst.shape)} {dst.dtype} on {dst.device}")
    return pairs


def fluxes(s: rt.RRTMGPSolver) -> dict:
    """The fields of the last step that the check compares, as references
    to the program's own output tensors."""
    return dict(lw_up=s.flux_lw.flux_up, lw_dn=s.flux_lw.flux_dn,
                sw_up=s.flux_sw.flux_up, sw_dn=s.flux_sw.flux_dn, sw_dir=s.flux_sw.flux_dn_dir)


def gather(fluxes: dict) -> dict:
    """``fluxes`` as whole tensors: on a mesh, every entry's columns joined
    on the first entry's device (after the window, for the check)."""
    def whole(v):
        if not isinstance(v, ColumnSharded):
            return v
        device = v.shards[0].device
        return torch.cat([part.to(device) for part in v.shards], dim=v.axis)

    return {f: whole(v) for f, v in fluxes.items()}
