"""The solver's option matrix routed as on the card, against the JAX
package's dispatch, and the f64 solver with ``fused_optics=False``.

Routes: ``_resolve_impl`` is wrapped so that it routes for a ``cuda``
device (on the CPU every ``impl=None`` solve takes the torch path), records
the route it returns, whether it warned, or the exception it raised, and
stops the solve there: no flux is computed, so the whole product costs
little. It is driven through the entry points a user calls (``solve_lw``,
``solve_sw``, ``RRTMGPSolver.update_lw_fluxes`` / ``update_sw_fluxes``
unsplit and on a mesh of two CPU entries, ``differentiable_solve_lw`` /
``_sw``) over f32 / f64, LW two-stream or no-scattering at 1-4 angles, SW
two-stream or direct beam, clouds and aerosols on or off,
``fused_optics`` on or off and, on the solver, ``f64_kernel`` None /
False / True, with ``impl=None``; the routes are held against ``ROUTES``,
written from the JAX package's dispatch:

- f32 with the fused optics (the JAX default windows): the megakernels,
  and the two-kernel path for several LW angles and the SW direct beam;
- f32 without (``pallas_windowed="off"``): the two-kernel path;
- f64 either way: the JAX package drops its Pallas tables for any dtype
  but f32 (``rrtmgp_tpu/api.py:350-352``, ``rrtmgp_tpu/models/rrtmgp.py``
  ``solve_lw`` / ``solve_sw``) and chooses its f64 LW kernel without
  regard to ``pallas_windowed`` (``rrtmgp_tpu/api.py:440-446``): the f64
  kernel for clear-sky LW no-scattering without aerosols, unless
  ``f64_kernel=False``, and the exact torch path with ``F64_WARNING`` for
  the rest. The port adds an f64 kernel the JAX package does not have, for
  clear-sky SW two-stream without aerosols, routed the same way (the JAX
  package's f64 SW solve is XLA: the port's torch path). ``impl=None``
  never raises.

Numbers: the f64 ``RRTMGPSolver(fused_optics=False)``, routed as on the
card (the kernel wrappers run their twins on CPU tensors), equals the
fused f64 solver bit for bit and the JAX ``RRTMGPSolver(pallas_windowed=
"off", f64_kernel=False)`` within 1e-10 of the largest flux, as
tests/test_torch_f64.py compares f64; clear and all-sky with aerosols, LW
two-stream with SW two-stream and LW no-scattering at 3 angles with the SW
direct beam; 8 layers, 16 g-points, inputs from a numpy seed.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu as jrt
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu_torch.data.synthetic import (
    synthetic_aerosol_lookup,
    synthetic_atmosphere,
    synthetic_cloud_lookup,
    synthetic_gas_lookup,
)
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.ops import mega
from rrtmgp_tpu_torch.parallel.sharding import make_column_mesh
from test_torch_f64 import FLUXES, _allsky_case, _rel

NLAY, NCOL, NGPT, NBND = 8, 4, 16, 2
REL = 1e-10
WARN = "torch, warned"  # the torch path with F64_WARNING

#: (dtype, fused_optics, solve) -> (route clear sky without aerosols, route
#: with clouds or aerosols), impl=None, as the JAX package dispatches
ROUTES = {
    ("f32", True, "lw two-stream"): ("kernel", "kernel"),
    ("f32", True, "lw no-scattering, 1 angle"): ("kernel", "kernel"),
    ("f32", True, "lw no-scattering, 2-4 angles"): ("two_kernel", "two_kernel"),
    ("f32", True, "sw two-stream"): ("kernel", "kernel"),
    ("f32", True, "sw direct beam"): ("two_kernel", "two_kernel"),
    ("f32", False, "lw two-stream"): ("two_kernel", "two_kernel"),
    ("f32", False, "lw no-scattering, 1 angle"): ("two_kernel", "two_kernel"),
    ("f32", False, "lw no-scattering, 2-4 angles"): ("two_kernel", "two_kernel"),
    ("f32", False, "sw two-stream"): ("two_kernel", "two_kernel"),
    ("f32", False, "sw direct beam"): ("two_kernel", "two_kernel"),
    ("f64", True, "lw two-stream"): (WARN, WARN),
    ("f64", True, "lw no-scattering, 1 angle"): ("kernel", WARN),
    ("f64", True, "lw no-scattering, 2-4 angles"): ("kernel", WARN),
    ("f64", True, "sw two-stream"): ("kernel", WARN),
    ("f64", True, "sw direct beam"): (WARN, WARN),
    ("f64", False, "lw two-stream"): (WARN, WARN),
    ("f64", False, "lw no-scattering, 1 angle"): ("kernel", WARN),
    ("f64", False, "lw no-scattering, 2-4 angles"): ("kernel", WARN),
    ("f64", False, "sw two-stream"): ("kernel", WARN),
    ("f64", False, "sw direct beam"): (WARN, WARN),
}
#: the solver's f64 solves with f64_kernel=False: the exact path, asked for
F64_KERNEL_FALSE = "torch"

#: (solve, keyword arguments of the solve)
SOLVES = {
    "lw": [("lw two-stream", dict(two_stream=True)),
           *((f"lw no-scattering, {'1 angle' if n == 1 else '2-4 angles'}", dict(two_stream=False, n_gauss_angles=n))
             for n in (1, 2, 3, 4))],
    "sw": [("sw two-stream", dict(two_stream=True)), ("sw direct beam", dict(two_stream=False))],
}
ENTRIES = ("solve", "solver", "mesh solver", "differentiable solve")
DTYPES = {"f32": torch.float32, "f64": torch.float64}


class _Stop(Exception):
    """Raised by the recording ``_resolve_impl``: the route is known, the
    solve goes no further."""


@pytest.fixture
def recorded(monkeypatch):
    """``_resolve_impl`` routing as for a cuda device; each call appends
    its route (``WARN`` when it warned), or the name of the exception it
    raised, to the returned list, then stops the solve."""
    real, seen = tmod._resolve_impl, []

    def spy(impl, device, *args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                route = real(impl, torch.device("cuda"), *args, **kwargs)
            except Exception as e:  # recorded, held against the table
                route = type(e).__name__
        if route == "torch" and any(str(w.message) == tmod.F64_WARNING for w in caught):
            route = WARN
        seen.append(route)
        raise _Stop

    monkeypatch.setattr(tmod, "_resolve_impl", spy)
    return seen


@pytest.fixture(scope="module")
def inputs():
    """Lookups, state and boundary conditions of a cloudy, aerosol-laden
    problem in each dtype, on the CPU."""
    out = {}
    for name, dtype in DTYPES.items():
        dt = np.float32 if name == "f32" else np.float64
        bundle = rt.LookupBundle(
            lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=dt, device="cpu"),
            lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, dtype=dt, device="cpu"),
            lookup_lw_cld=synthetic_cloud_lookup(n_bnd=NBND, dtype=dt, device="cpu"),
            lookup_sw_cld=synthetic_cloud_lookup(n_bnd=NBND, dtype=dt, device="cpu"),
            lookup_lw_aero=synthetic_aerosol_lookup(n_bnd=NBND, dtype=dt, device="cpu"),
            lookup_sw_aero=synthetic_aerosol_lookup(n_bnd=NBND, dtype=dt, device="cpu"))
        atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=dt, with_clouds=True, with_aerosols=True,
                                   device="cpu")
        full = lambda shape, v: torch.full(shape, v, dtype=dtype)
        bcs_lw = rt.LwBCs(sfc_emis=full((NBND, NCOL), 0.98))
        bcs_sw = rt.SwBCs(cos_zenith=full((NCOL,), 0.6), toa_flux=full((NCOL,), 1361.0),
                          sfc_alb_direct=full((NBND, NCOL), 0.2), sfc_alb_diffuse=full((NBND, NCOL), 0.2))
        out[name] = bundle, atm, bcs_lw, bcs_sw
    return out


def _drive(entry, wave, inp, kw, clouds, aerosols, fused, f64_kernel):
    """One call of ``entry`` for the ``wave`` solve of ``kw``, stopped at
    its route."""
    bundle, atm, bcs_lw, bcs_sw = inp
    lw = wave == "lw"
    if entry in ("solver", "mesh solver"):
        method = rt.AllSkyRadiation(aerosols) if clouds else rt.ClearSkyRadiation(aerosols)
        wave_kw = (dict(two_stream_lw=kw["two_stream"], n_gauss_angles=kw.get("n_gauss_angles", 1)) if lw
                   else dict(two_stream_sw=kw["two_stream"]))
        solver = rt.RRTMGPSolver(
            rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=atm.p_lay.dtype), method, rt.RRTMGPParameters(),
            bcs_lw, bcs_sw, atm, lookups=bundle, fused_optics=fused, f64_kernel=f64_kernel,
            mesh=make_column_mesh(["cpu", "cpu"]) if entry == "mesh solver" else None, **wave_kw)
        call = solver.update_lw_fluxes if lw else solver.update_sw_fluxes
    else:
        lkp = bundle.lookup_lw if lw else bundle.lookup_sw
        sky = dict(fused_optics=fused, **kw)
        if aerosols:
            sky["lkp_aero"] = bundle.lookup_lw_aero if lw else bundle.lookup_sw_aero
        if clouds:
            sky.update(lkp_cld=bundle.lookup_lw_cld if lw else bundle.lookup_sw_cld, cld_mask_seed=3)
        bcs = bcs_lw if lw else bcs_sw
        if entry == "solve":
            call = lambda: (tmod.solve_lw if lw else tmod.solve_sw)(lkp, atm, bcs, **sky)
        else:
            f = (tmod.differentiable_solve_lw if lw else tmod.differentiable_solve_sw)(lkp, **sky)
            call = lambda: f(atm, bcs)
    with pytest.raises(_Stop):
        call()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("wave", ["lw", "sw"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_routes_follow_the_jax_dispatch(recorded, inputs, entry, wave, dtype, fused):
    """Every solve of the product takes the route of ``ROUTES``; none
    raises with impl=None."""
    wrong = []
    kernel_opts = (None, False, True) if "solver" in entry else (None,)
    # differentiable solves refuse McICA (cld_mask / cld_mask_seed), as the JAX package's do
    cloud_opts = (False,) if entry == "differentiable solve" else (False, True)
    for solve, kw in SOLVES[wave]:
        for clouds in cloud_opts:
            for aerosols in (False, True):
                for f64_kernel in kernel_opts:
                    recorded.clear()
                    _drive(entry, wave, inputs[dtype], kw, clouds, aerosols, fused, f64_kernel)
                    want = ROUTES[dtype, fused, solve][clouds or aerosols]
                    if dtype == "f64" and f64_kernel is False and "solver" in entry:
                        want = F64_KERNEL_FALSE
                    if recorded != [want]:
                        wrong.append((solve, kw, dict(clouds=clouds, aerosols=aerosols, f64_kernel=f64_kernel),
                                      recorded[:], want))
    assert not wrong, "\n".join(map(str, wrong))


# ---------------------------------------------------------------------------
# The f64 solver without the fused optics, in numbers
# ---------------------------------------------------------------------------

SKIES = {"clear": ("ClearSkyRadiation", False), "all-sky with aerosols": ("AllSkyRadiation", True)}
WAVES = {"LW two-stream, SW two-stream": dict(two_stream_lw=True, two_stream_sw=True),
         "LW no-scattering 3 angles, SW direct beam": dict(two_stream_lw=False, n_gauss_angles=3,
                                                           two_stream_sw=False)}


@pytest.fixture
def cuda_routing(monkeypatch):
    """solve_* route impl=None as for CUDA tensors of the inputs' dtype (on
    CPU tensors the wrappers then run their twins); the routes taken are
    appended to the returned list."""
    real, taken = tmod._resolve_impl, []

    def route(impl, device, *args, **kwargs):
        taken.append(real(impl, torch.device("cuda"), *args, **kwargs))
        return taken[-1]

    monkeypatch.setattr(tmod, "_resolve_impl", route)
    return taken


@pytest.mark.parametrize("waves", list(WAVES))
@pytest.mark.parametrize("sky", list(SKIES))
def test_f64_unfused_solver_equals_fused_and_jax_off(cuda_routing, sky, waves):
    name, aero = SKIES[sky]
    jx, port = _allsky_case(np.float64)
    ncol = port["atm"].ncol
    jl = jrt.LookupBundle(lookup_lw=jx["lw"], lookup_sw=jx["sw"], lookup_lw_cld=jx["cld"],
                          lookup_sw_cld=jx["cld"], lookup_lw_aero=jx["aero"], lookup_sw_aero=jx["aero"])
    tl = rt.LookupBundle(lookup_lw=port["lw"], lookup_sw=port["sw"], lookup_lw_cld=port["cld"],
                         lookup_sw_cld=port["cld"], lookup_lw_aero=port["aero"], lookup_sw_aero=port["aero"])
    jb = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    ref = jrt.RRTMGPSolver(
        jrt.RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=jnp.float64), getattr(jrt, name)(aerosol_radiation=aero),
        jrt.RRTMGPParameters(), jrt.LwBCs(**jb(jx["bc_lw"])), jrt.SwBCs(**jb(jx["bc_sw"])), jx["atm"],
        lookups=jl, pallas_windowed="off", f64_kernel=False, **WAVES[waves])
    bl = dataclasses.replace(port["bc_lw"], inc_flux=None)
    bs = dataclasses.replace(port["bc_sw"], inc_flux_diffuse=None)
    mk = lambda fused: rt.RRTMGPSolver(
        rt.RRTMGPGridParams(nlay=NLAY, ncol=ncol, dtype=torch.float64), getattr(rt, name)(aerosol_radiation=aero),
        rt.RRTMGPParameters(), bl, bs, port["atm"], lookups=tl, fused_optics=fused, **WAVES[waves])
    unfused, fused = mk(False), mk(True)
    routes = {}
    for key, s in (("unfused", unfused), ("fused", fused), ("jax", ref)):
        s.advance_step(3)
        cuda_routing.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # F64_WARNING, by design
            s.update_fluxes()
        routes[key] = cuda_routing[:]
    # LW then SW: the f64 kernels (their twins here) for the clear no-scattering
    # LW and the clear two-stream SW
    clear = sky == "clear"
    want = [("kernel" if clear and has else "torch")
            for has in (not WAVES[waves]["two_stream_lw"], WAVES[waves]["two_stream_sw"])]
    assert routes["unfused"] == routes["fused"] == want
    for name_ in FLUXES:
        a, b = getattr(unfused, name_)(), getattr(fused, name_)()
        assert a.dtype == torch.float64 and torch.equal(a, b), name_
        assert _rel(a, getattr(ref, name_)()) <= REL, name_
    for name_ in ("lw_cloud_cover", "sw_cloud_cover", "aod_sw_extinction", "aod_sw_scattering"):
        a, b, c = getattr(unfused, name_)(), getattr(fused, name_)(), getattr(ref, name_)()
        assert (a is None) == (b is None) == (c is None), name_
        if a is not None:
            assert torch.equal(a, b), name_
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-9, err_msg=name_)


# ---------------------------------------------------------------------------
# chip_smoke.py's routes phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

#: the function that counts a launch on the card, entered from outside any
#: other: the wrapper's launch count it adds to (on CPU tensors these
#: functions run the twins and count nothing)
COUNTED = {
    "planck_band": "planck_band", "planck_band_sets": "planck_band", "lw_clear_mega": "lw_clear_mega",
    "lw2_mega": "lw2_mega", "sw_clear_mega": "sw_clear_mega", "mcica_mask_export": "mcica_mask_export",
    "aerosol_bands": "aerosol_bands", "cloud_bands": "cloud_bands", "optics_fused": "optics_fused",
    "planck_band_rows": "planck_band_rows",
    "planck_band_rows_sets": "planck_band_rows", "interp_pt_eta": "interp_pt_eta", "interp_minor": "interp_minor",
    "lw_noscat_banded_reduced": "lw_noscat_banded_reduced", "lw_noscat_banded_angles": "lw_noscat_banded_reduced",
    "lw_noscat_reduced": "lw_noscat_reduced", "lw_noscat_reduced_angles": "lw_noscat_reduced",
    "lw_2stream_reduced": "lw_2stream_reduced", "sw_2stream_reduced": "sw_2stream_reduced",
    "sw_2stream_gpt": "sw_2stream_gpt", "lw_noscat_gpt": "lw_noscat_gpt",
}


@pytest.fixture
def counted_launches(monkeypatch):
    """``mega.reset_launch_counts`` / ``launch_counts`` read the kernel
    wrappers entered on CPU tensors (a profile hook), as the card counts
    their launches."""
    import collections
    import sys

    counts, stack = collections.Counter(), []

    def hook(frame, event, arg):
        code = frame.f_code
        if code.co_name not in COUNTED or "rrtmgp_tpu_torch" not in code.co_filename:
            return
        if event == "call":
            if not stack:
                counts[COUNTED[code.co_name]] += 1
            stack.append(frame)
        elif event == "return" and stack and stack[-1] is frame:
            stack.pop()

    monkeypatch.setattr(mega, "reset_launch_counts", counts.clear)
    monkeypatch.setattr(mega, "launch_counts", lambda: {name: counts[name] for name in set(COUNTED.values())})
    sys.setprofile(hook)
    yield counts
    sys.setprofile(None)


def test_chip_smoke_routes_phase_on_cpu(monkeypatch, inputs, cuda_routing, counted_launches):
    """chip_smoke.py's routes phase at 8 columns x 8 layers on the small
    lookups, routed as on the card, the kernels counted as they are entered:
    the f64 solver without the fused optics bitwise the fused one and on a
    mesh of two CPU entries, the launches of its route table, and every
    configuration of the covering set within its route's tolerance of
    impl="torch" (the wrappers' twins here)."""
    import itertools

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args, **kwargs: None)
    configs = chip_smoke.pairwise_configs()
    assert len(configs) <= 30  # at least 6 methods x 3 f64_kernel values
    for (i, (a, va)), (j, (b, vb)) in itertools.combinations(enumerate(chip_smoke.ROUTE_FACTORS), 2):
        for x, y in itertools.product(va, vb):
            assert any(c[a] == x and c[b] == y for c in configs), (a, x, b, y)
    chip_smoke.phase_routes(inputs["f32"][0], inputs["f64"][0], ncol=8, nlay=NLAY)
