"""The benchmark's plain-torch reference, at small sizes on the CPU:

- against the JAX package's XLA solves (numpy hand-over; float32 there,
  float64 here; McICA from the same seed on both sides), within 1e-4 of
  the largest flux, the port's own tolerance against JAX at 8 layers;
- against the port's ``impl="torch"`` path in float64 through the solver
  the harness drives, within 1e-12 of the largest flux;
- and the comparison that decides ``correct``: a program run in the
  configuration's dtype passes the cell's limits, the control (the
  reference in the precision below, bfloat16 for float32 and float32 for
  float64, in the program's place) fails them.

Run with ``python -m pytest portbench/tests -q`` from the repository root.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portbench import compare, harness, inputs, program, reference, run
from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu.states import LwBCs as JLwBCs
from rrtmgp_tpu.states import SwBCs as JSwBCs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NCOL, NLAY = 20, 8

GAS_ARRAYS = ("kmajor", "kminor_lower", "kminor_upper", "eta_half", "planck_fraction", "totplnk", "rayl",
              "solar_src_scaled")
GAS_META = ("idx_h2o", "p_ref_tropo", "p_ref_min", "key_species", "bnd_lims_gpt", "minor_lower", "minor_upper",
            "gas_names", "n_eta", "n_press", "n_temp", "t_ref_min", "t_ref_delta", "ln_p_ref_max",
            "ln_p_ref_delta", "t_planck_min", "t_planck_delta", "solar_src_tot")


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_case(cloudy: bool):
    """JAX lookups, state and boundary values at the files' g-points, and
    the same as the reference's dicts."""
    jl = jsyn.synthetic_gas_lookup(longwave=True, n_gpt=256, n_bnd=16, dtype=np.float32)
    js = jsyn.synthetic_gas_lookup(longwave=False, n_gpt=224, n_bnd=14, seed=1, dtype=np.float32)
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=cloudy, with_aerosols=cloudy)
    gas = lambda lk: {**{k: _t(getattr(lk, k)) for k in GAS_ARRAYS},
                      "meta": {k: getattr(lk, k) for k in GAS_META}}
    tables = dict(lw=gas(jl), sw=gas(js))
    state = dict(p_lay=_t(ja.p_lay), t_lay=_t(ja.t_lay), p_lev=_t(ja.p_lev), t_lev=_t(ja.t_lev),
                 t_sfc=_t(ja.t_sfc), col_dry=_t(ja.col_dry), vmr_h2o=_t(ja.vmr.vmr_h2o),
                 vmr_o3=_t(ja.vmr.vmr_o3), vmr_gm=_t(ja.vmr.vmr))
    jc = jae = None
    if cloudy:
        cf = np.asarray(ja.cloud_state.cld_frac) * np.random.default_rng(5).uniform(
            0.2, 1.0, (NLAY, NCOL)).astype(np.float32)
        ja = dataclasses.replace(ja, cloud_state=dataclasses.replace(ja.cloud_state, cld_frac=jnp.asarray(cf)))
        cs = ja.cloud_state
        state["cloud"] = {k: _t(getattr(cs, k)) for k in
                          ("cld_r_eff_liq", "cld_r_eff_ice", "cld_path_liq", "cld_path_ice", "cld_frac")}
        state["cloud"]["ice_rgh"] = int(cs.ice_rgh)
        state["aerosol"] = dict(aero_size=_t(ja.aerosol_state.aero_size), aero_mass=_t(ja.aerosol_state.aero_mass))
        state["rel_hum"] = _t(ja.rel_hum)
        jc = (jsyn.synthetic_cloud_lookup(n_bnd=16, dtype=np.float32),
              jsyn.synthetic_cloud_lookup(n_bnd=14, seed=5, dtype=np.float32))
        jae = (jsyn.synthetic_aerosol_lookup(n_bnd=16, dtype=np.float32),
               jsyn.synthetic_aerosol_lookup(n_bnd=14, seed=6, dtype=np.float32))
        for key, lk in (("lw_cld", jc[0]), ("sw_cld", jc[1])):
            tables[key] = {k: _t(getattr(lk, k)) for k in
                           ("liq", "ice", "bnd_lims_wn", "radliq_lwr", "radliq_upr", "radice_lwr", "radice_upr")}
            tables[key]["meta"] = dict(nsize_liq=lk.nsize_liq, nsize_ice=lk.nsize_ice, nrghice=lk.nrghice)
        for key, lk in (("lw_aero", jae[0]), ("sw_aero", jae[1])):
            tables[key] = {k: _t(getattr(lk, k)) for k in
                           ("size_bin_limits", "rh_levels", "dust", "sea_salt", "sulfate", "black_carbon_rh",
                            "black_carbon", "organic_carbon_rh", "organic_carbon", "bnd_lims_wn")}
            tables[key]["meta"] = dict(iband_550nm=lk.iband_550nm, n_bin=lk.n_bin, n_rh=lk.n_rh)
    bcs = dict(sfc_emis=torch.full((16, NCOL), 0.98), cos_zenith=torch.full((NCOL,), 0.6),
               toa_flux=torch.full((NCOL,), 1361.0), sfc_alb_direct=torch.full((14, NCOL), 0.2),
               sfc_alb_diffuse=torch.full((14, NCOL), 0.2))
    return (jl, js, ja, jc, jae), tables, state, bcs


def _rel(ours, theirs):
    theirs = np.asarray(theirs, np.float64)
    return np.abs(ours.numpy() - theirs).max() / np.abs(theirs).max()


@pytest.mark.parametrize("cloudy,two_stream", [(False, False), (True, False), (True, True)])
def test_reference_matches_jax(cloudy, two_stream):
    (jl, js, ja, jc, jae), tables, state, bcs = _jax_case(cloudy)
    step = 7
    kw_lw = kw_sw = {}
    if cloudy:
        kw_lw = dict(lkp_cld=jc[0], lkp_aero=jae[0], cld_mask_seed=2 * step, col_offset=0)
        kw_sw = dict(lkp_cld=jc[1], lkp_aero=jae[1], cld_mask_seed=2 * step + 1, col_offset=0)
    j_lw, _ = jmod.solve_lw(jl, ja, JLwBCs(sfc_emis=jnp.asarray(bcs["sfc_emis"].numpy())),
                            two_stream=two_stream, **kw_lw)
    j_sw, _ = jmod.solve_sw(js, ja, JSwBCs(**{k: jnp.asarray(bcs[k].numpy()) for k in
                                             ("cos_zenith", "toa_flux", "sfc_alb_direct", "sfc_alb_diffuse")}),
                            **kw_sw)
    ours = reference.step_fluxes(tables, state, bcs, two_stream, step, 0, NCOL)
    pairs = dict(lw_up=j_lw.flux_up, lw_dn=j_lw.flux_dn, sw_up=j_sw.flux_up, sw_dn=j_sw.flux_dn,
                 sw_dir=j_sw.flux_dn_dir)
    for field, theirs in pairs.items():
        assert ours[field].dtype == torch.float64
        assert _rel(ours[field], theirs) <= 1e-4, field


def _small(cell: str, ncol=24, nlay=10):
    spec = run.cell_spec(BENCH, cell)
    spec["cfg"].update(ncol=ncol, nlay=nlay)
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_torch_path_f64(cell):
    spec = _small(cell)
    cfg = dict(spec["cfg"], dtype="float64")
    inp = inputs.make_inputs(cfg, 2**33 + 17, 2, "cpu")
    s = program.solver(cfg, spec["traffic"], inp)
    two_stream = spec["traffic"]["solver"]["two_stream_lw"]
    for k, step in ((0, 4), (1, 9)):
        for dst, src in program.copy_pairs(s.as_, inp["states"][k]):
            dst.copy_(src)
        s.advance_step(step)
        s.update_fluxes()
        out = program.gather(program.fluxes(s))
        ref = reference.step_fluxes(inp["tables"], inp["states"][k], inp["bcs"], two_stream, step, 0, cfg["ncol"])
        for f in ref:
            assert out[f].dtype == torch.float64
            gap = (out[f] - ref[f]).abs().max() / ref[f].abs().max().clamp(min=1e-30)
            assert gap <= 1e-12, (f, float(gap))


@pytest.mark.parametrize("cell", CELLS)
def test_comparison_passes_program_and_fails_control(cell):
    """A sound run in the configuration's dtype reads under the cell's
    limits; the reference in the precision below, put in the program's
    place, reads over one of them."""
    spec = _small(cell, ncol=48, nlay=16)
    res = harness.run_cell(spec["cfg"], spec["traffic"], 2**32 + 5, 0.0, False, "cpu", 0.0, keep_inputs=True)
    limits = {n: v["limit"] for n, v in spec["limits"].items()}
    program_worst = compare.worst(res["per_step"])
    assert all(program_worst[n] <= limits[n] for n in limits), program_worst
    ctl = compare.control(res["inputs"], spec["cfg"], spec["traffic"], res["checked"])
    assert any(ctl[n] > limits[n] for n in limits), ctl


def test_block_columns_is_whole_width_on_cpu():
    spec = _small(CELLS[0])
    assert compare.block_columns(spec["cfg"], "cpu") == spec["cfg"]["ncol"]
