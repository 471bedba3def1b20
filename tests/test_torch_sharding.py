"""The port's column split (rrtmgp_tpu_torch.parallel.sharding and
RRTMGPSolver(mesh=...)) on the CPU, 8 mesh entries on one CPU, against the
port's unsplit solves bit for bit and the JAX package's unsplit solves
(its XLA path) within 1e-4 of max |flux| (8 layers, the tolerance of
tests/test_torch_api.py): every flux field's largest difference over the
largest flux of its solve (f32: the SW surface fluxes of these inputs
differ by ~2e-5 of the downward flux, 1e-4 of the smaller upward one).

The all-sky cases scale the cloud fraction by 0.6: at 0 or 1 the McICA
mask does not depend on the draws, and a split that gave every entry the
same clouds would pass. The port's McICA stream is the JAX package's
off-TPU stream, so the same seed draws the same mask in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu as jrt
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu.data import synthetic as jsyn
from rrtmgp_tpu.models import rrtmgp as jmod
from rrtmgp_tpu_torch import convert
from rrtmgp_tpu_torch.parallel import distributed as dist
from rrtmgp_tpu_torch.parallel.sharding import (
    COLUMN_AXIS,
    ColumnSharded,
    column_sharding,
    make_column_mesh,
    replicate,
    replicated,
    shard_columns,
    shard_solve,
)

NBND, NCOL, NLAY, NGPT = 2, 32, 8, 16
TOL = 1e-4
MESH = make_column_mesh(["cpu"] * 8)

J_LOOKUPS = jrt.LookupBundle(
    lookup_lw=jsyn.synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=np.float32),
    lookup_sw=jsyn.synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, dtype=np.float32),
    lookup_lw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=np.float32),
    lookup_sw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, seed=5, dtype=np.float32),
)
T_LOOKUPS = rt.LookupBundle(
    lookup_lw=convert.gas_lookup_from_object(J_LOOKUPS.lookup_lw),
    lookup_sw=convert.gas_lookup_from_object(J_LOOKUPS.lookup_sw),
    lookup_lw_cld=convert.cloud_lookup_from_object(J_LOOKUPS.lookup_lw_cld),
    lookup_sw_cld=convert.cloud_lookup_from_object(J_LOOKUPS.lookup_sw_cld),
)


def _inputs(ncol=NCOL, dtype=np.float32):
    """JAX state with fractional clouds (the synthetic fraction times 0.6),
    and numpy boundary conditions."""
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=NLAY, dtype=dtype, with_clouds=True)
    cs = ja.cloud_state
    ja = dataclasses.replace(ja, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * 0.6))
    mu0 = np.full(ncol, 0.6, dtype)
    mu0[::5] = -0.1
    bc_lw = dict(sfc_emis=np.full((NBND, ncol), 0.98, dtype))
    bc_sw = dict(cos_zenith=mu0, toa_flux=np.full(ncol, 1361.0, dtype),
                 sfc_alb_direct=np.full((NBND, ncol), 0.2, dtype),
                 sfc_alb_diffuse=np.full((NBND, ncol), 0.25, dtype))
    return ja, bc_lw, bc_sw


def _port(ja, bc_lw, bc_sw):
    tb = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    return convert.atmosphere_from_object(ja, device="cpu"), rt.LwBCs(**tb(bc_lw)), rt.SwBCs(**tb(bc_sw))


def _max_rel(port, ref, names) -> float:
    """The largest difference of the fields ``names`` (getters of solvers,
    or fields of flux tuples) over the largest |flux| among them."""
    get = lambda obj, n: getattr(obj, n)() if callable(getattr(obj, n)) else getattr(obj, n)
    err = scale = 0.0
    for n in names:
        a, b = np.asarray(get(port, n)).astype(np.float64), np.asarray(get(ref, n), np.float64)
        assert a.shape == b.shape and np.all(np.isfinite(a)), n
        err, scale = max(err, np.abs(a - b).max()), max(scale, np.abs(b).max())
    return err / scale


def _equal(whole, split) -> bool:
    """A tensor or flux tuple of the unsplit port against a ColumnSharded one."""
    if isinstance(whole, torch.Tensor):
        return np.array_equal(whole.numpy(), np.asarray(split))
    return all(_equal(a, b) for a, b in zip(whole, split, strict=True))


@pytest.mark.parametrize("wave", ["lw", "sw"])
def test_shard_solve_equals_the_unsplit_solve_and_jax(wave):
    ja, bc_lw, bc_sw = _inputs()
    atm, bl, bs = _port(ja, bc_lw, bc_sw)
    if wave == "lw":
        port = lambda lk, a, b: rt.solve_lw(lk, a, b, two_stream=True)[0]
        jfn = lambda lk, a, b: jmod.solve_lw(lk, a, b, two_stream=True)[0]
        lk, jlk, bcs, jbcs = T_LOOKUPS.lookup_lw, J_LOOKUPS.lookup_lw, bl, jrt.LwBCs(**bc_lw)
    else:
        port = lambda lk, a, b: rt.solve_sw(lk, a, b)[0]
        jfn = lambda lk, a, b: jmod.solve_sw(lk, a, b)[0]
        lk, jlk, bcs, jbcs = T_LOOKUPS.lookup_sw, J_LOOKUPS.lookup_sw, bs, jrt.SwBCs(**bc_sw)
    whole = port(lk, atm, bcs)
    split = shard_solve(port, MESH, NCOL)(replicate(lk, MESH), atm, bcs)
    assert isinstance(split, ColumnSharded) and split.offsets == tuple(range(0, NCOL, NCOL // 8))
    assert all(s.flux_up.shape == (NLAY + 1, NCOL // 8) for s in split.shards)
    assert split.flux_up.shape == (NLAY + 1, NCOL)
    assert _equal(whole, split)
    # ColumnSharded arguments (shard_columns) give the same
    again = shard_solve(port, MESH, NCOL)(replicate(lk, MESH), shard_columns(atm, MESH, NCOL),
                                          shard_columns(bcs, MESH, NCOL))
    assert _equal(whole, again)
    ref = jax.jit(jfn)(jlk, ja, jbcs)
    assert _max_rel(split, ref, ref._fields) <= TOL


def _solvers(method, mesh_kw, dtype=np.float32, lookups=T_LOOKUPS):
    ja, bc_lw, bc_sw = _inputs(dtype=dtype)
    atm, bl, bs = _port(ja, bc_lw, bc_sw)
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=convert.torch_dtype(dtype))
    mk = lambda **kw: rt.RRTMGPSolver(grid, method, rt.RRTMGPParameters(), bl, bs, atm, lookups=lookups, **kw)
    return mk(), mk(**mesh_kw), (ja, bc_lw, bc_sw)


def test_allsky_solver_on_a_mesh_equals_the_unsplit_solver_and_jax():
    whole, split, (ja, bc_lw, bc_sw) = _solvers(rt.AllSkyRadiation(), dict(mesh=MESH))
    jgrid = jrt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float32)
    ref = jrt.RRTMGPSolver(jgrid, jrt.AllSkyRadiation(), jrt.RRTMGPParameters(), jrt.LwBCs(**bc_lw),
                           jrt.SwBCs(**bc_sw), ja, lookups=J_LOOKUPS)
    for s in (whole, split, ref):
        s.advance_step(3)
        s.update_lw_fluxes()
        s.update_sw_fluxes()
    assert isinstance(split.flux_lw, ColumnSharded) and isinstance(split.lw_flux_up(), ColumnSharded)
    assert _equal(whole.flux_lw, split.flux_lw) and _equal(whole.flux_sw, split.flux_sw)
    for name in ("lw_cloud_cover", "sw_cloud_cover"):
        assert _equal(getattr(whole, name)(), getattr(split, name)()), name
        cover = np.asarray(getattr(split, name)())
        assert 0.0 < cover.mean() < 0.67, (name, cover.mean())  # the clouds were drawn, not set
        np.testing.assert_allclose(cover, np.asarray(getattr(ref, name)()), rtol=1e-6, err_msg=name)
    assert _max_rel(split, ref, ("lw_flux_up", "lw_flux_dn", "lw_flux_net")) <= TOL
    assert _max_rel(split, ref, ("sw_flux_up", "sw_flux_dn", "sw_flux_net", "sw_direct_flux_dn")) <= TOL
    # a mesh of another size draws the same clouds; a per-column metric
    # scaling is split with the state
    scale = torch.full((NLAY + 1, NCOL), 2.0)
    other = _solvers(rt.AllSkyRadiation(), dict(mesh=make_column_mesh(["cpu"] * 2), metric_scaling=scale))[1]
    other.advance_step(3)
    assert _equal(tuple(2.0 * f for f in whole.update_fluxes()[0]), other.update_fluxes()[0])


def test_f64_chunks_within_each_mesh_entry(monkeypatch):
    """f64 with a budget of 2 columns: every entry's 4 columns solve in 2
    chunks, each at its global McICA offset; bit for bit the unsplit,
    unchunked solver."""
    lk64 = rt.LookupBundle(**{f.name: getattr(T_LOOKUPS, f.name).to(dtype=torch.float64)
                              for f in dataclasses.fields(T_LOOKUPS) if getattr(T_LOOKUPS, f.name) is not None})
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", "0.0001")
    with pytest.warns(UserWarning, match=r"ncol=4 per mesh entry .* auto-chunking into 2-column chunks"):
        _, split, _ = _solvers(rt.AllSkyRadiation(), dict(mesh=MESH), np.float64, lk64)
    monkeypatch.delenv("RRTMGP_CHUNK_BUDGET_GB")
    whole = _solvers(rt.AllSkyRadiation(), {}, np.float64, lk64)[0]
    assert split.auto_chunk == 2 and whole.auto_chunk is None
    for s in (whole, split):
        s.advance_step(5)
        s.update_fluxes()
    assert split.lw_flux_up().dtype == torch.float64
    assert _equal(whole.flux_lw, split.flux_lw) and _equal(whole.flux_sw, split.flux_sw)
    assert _equal(whole.sw_cloud_cover(), split.sw_cloud_cover())


@pytest.mark.parametrize("two_stream", [False, True])
def test_gray_solver_on_a_mesh(two_stream):
    lat = torch.linspace(-60.0, 60.0, NCOL, dtype=torch.float64)
    ta = rt.setup_gray_as_pr_grid(NLAY, lat, 1e5, 9e3, rt.GrayOpticalThicknessOGorman2008(), rt.RRTMGPParameters(),
                                  dtype=torch.float64, device="cpu")
    f = lambda shape, v: torch.full(shape, v, dtype=torch.float64)
    bl = rt.LwBCs(sfc_emis=f((1, NCOL), 1.0))
    mu0 = f((NCOL,), 0.5)
    mu0[::7] = -0.2
    bs = rt.SwBCs(cos_zenith=mu0, toa_flux=f((NCOL,), 1360.0), sfc_alb_direct=f((1, NCOL), 0.1),
                  sfc_alb_diffuse=f((1, NCOL), 0.1))
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=torch.float64)
    mk = lambda **kw: rt.RRTMGPSolver(grid, rt.GrayRadiation(), rt.RRTMGPParameters(), bl, bs, ta,
                                      two_stream_lw=two_stream, two_stream_sw=two_stream, **kw)
    whole, split = mk(), mk(mesh=MESH)
    assert split.auto_chunk is None
    w_lw, w_sw = whole.update_fluxes()
    s_lw, s_sw = split.update_fluxes()
    assert isinstance(s_lw, ColumnSharded) and len(s_lw.shards) == 8
    assert _equal(w_lw, s_lw) and _equal(w_sw, s_sw)
    assert split.optical_thickness_parameter() == rt.GrayOpticalThicknessOGorman2008()
    assert _equal(whole.temperature(), split.temperature())


def test_vmr_vector_and_incident_fluxes_are_split_by_their_layout():
    """ncol == ngas + 1 (9): the VmrGM global-mean vector, shape (9,), is
    copied whole to every entry; the (ncol, ngpt) incident fluxes are cut
    along their leading column axis; the solves with them equal the unsplit
    ones bit for bit."""
    ncol, mesh = 9, make_column_mesh(["cpu"] * 3)
    ja, bc_lw, bc_sw = _inputs(ncol=ncol)
    atm, _, _ = _port(ja, bc_lw, bc_sw)
    assert isinstance(atm.vmr, rt.VmrGM) and atm.vmr.vmr.shape == (ncol,)
    rng = np.random.default_rng(3)
    inc = torch.from_numpy(rng.uniform(0.0, 2.0, (ncol, NGPT)).astype(np.float32))
    bl = rt.LwBCs(sfc_emis=torch.from_numpy(bc_lw["sfc_emis"]), inc_flux=inc)
    bs = rt.SwBCs(**{k: torch.from_numpy(v) for k, v in bc_sw.items()}, inc_flux_diffuse=inc * 3.0)
    split_atm, split_bl = shard_columns(atm, mesh, ncol), shard_columns(bl, mesh, ncol)
    for k, (part, lo) in enumerate(zip(split_atm.shards, split_atm.offsets)):
        assert torch.equal(part.vmr.vmr, atm.vmr.vmr)
        assert torch.equal(part.vmr.vmr_h2o, atm.vmr.vmr_h2o[:, lo:lo + 3])
        assert torch.equal(split_bl.shards[k].inc_flux, inc[lo:lo + 3]) and split_bl.shards[k].inc_flux.is_contiguous()
    assert torch.equal(split_atm.vmr.vmr, atm.vmr.vmr)  # read once, not per column
    assert split_bl.inc_flux.shape == (ncol, NGPT) and np.array_equal(np.asarray(split_bl.inc_flux), inc.numpy())
    for solve, lk, bcs in ((lambda lk, a, b: rt.solve_lw(lk, a, b)[0], T_LOOKUPS.lookup_lw, bl),
                           (lambda lk, a, b: rt.solve_sw(lk, a, b)[0], T_LOOKUPS.lookup_sw, bs)):
        assert _equal(solve(lk, atm, bcs), shard_solve(solve, mesh, ncol)(replicate(lk, mesh), atm, bcs))
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=ncol)
    s = rt.RRTMGPSolver(grid, rt.ClearSkyRadiation(), rt.RRTMGPParameters(), bl, bs, atm, lookups=T_LOOKUPS,
                        mesh=mesh)
    assert np.array_equal(np.asarray(s.top_of_atmosphere_lw_flux_dn()), inc.numpy())
    assert torch.equal(s.volume_mixing_ratio("co2"), atm.vmr.vmr[2])


def test_a_column_count_the_mesh_does_not_divide_raises():
    ja, bc_lw, bc_sw = _inputs(ncol=30)
    atm, bl, bs = _port(ja, bc_lw, bc_sw)
    solve = lambda lk, a, b: rt.solve_lw(lk, a, b)[0]
    with pytest.raises(ValueError, match="ncol=30 does not divide over a mesh of 8"):
        shard_solve(solve, MESH, 30)
    with pytest.raises(ValueError, match="does not divide"):
        shard_columns(atm, MESH, 30)
    with pytest.raises(ValueError, match="does not divide"):
        dist.process_column_range(30, MESH)
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=30)
    with pytest.raises(ValueError, match="does not divide"):
        rt.RRTMGPSolver(grid, rt.ClearSkyRadiation(), rt.RRTMGPParameters(), bl, bs, atm, lookups=T_LOOKUPS,
                        mesh=MESH)
    with pytest.raises(ValueError, match="the state has 30 columns, grid_params.ncol is 32"):
        rt.RRTMGPSolver(rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL), rt.ClearSkyRadiation(), rt.RRTMGPParameters(),
                        bl, bs, atm, lookups=T_LOOKUPS, mesh=MESH)
    split = shard_columns(_port(*_inputs())[0], MESH, NCOL)
    with pytest.raises(ValueError, match="not split over this mesh"):
        shard_solve(solve, make_column_mesh(["cpu"] * 4), NCOL)(T_LOOKUPS.lookup_lw, split, None)


def test_mesh_placements_replicas_and_local_values():
    assert MESH.axis_names == (COLUMN_AXIS,) and len(MESH) == 8
    assert all(e.process == 0 and e.device == torch.device("cpu") for e in MESH)
    assert column_sharding(MESH).split_columns and not replicated(MESH).split_columns
    # one copy per distinct device, the lookup itself where it already is
    reps = replicate(T_LOOKUPS, MESH)
    assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is T_LOOKUPS
    x = torch.arange(3 * NCOL, dtype=torch.float32).reshape(3, NCOL)
    split = shard_columns(x, MESH, NCOL)
    assert np.array_equal(np.asarray(split), x.numpy()) and split.shape == (3, NCOL)
    assert np.array_equal(dist.local_values(split), x.numpy())
    assert np.array_equal(np.asarray(split[1]), x[1].numpy())
    flux = shard_solve(lambda a: rt.FluxLW(a, 2 * a, -a), MESH, NCOL)(x)
    got = dist.local_values((flux, {"x": split}))
    assert isinstance(got[0], rt.FluxLW) and np.array_equal(got[0].flux_dn, 2 * x.numpy())
    assert np.array_equal(got[1]["x"], x.numpy())
    # a tree already of all columns globalizes like shard_columns (one process)
    assert dist.process_column_range(NCOL, MESH) == (0, NCOL)
    g = dist.globalize(x, MESH, NCOL)
    assert g.offsets == split.offsets and all(torch.equal(a, b) for a, b in zip(g.shards, split.shards))



def test_the_kernel_prologue_copies_no_host_data_to_the_device(monkeypatch):
    """After its first call the megakernels' plain-torch prologue
    (``mega_lw_inputs`` / ``mega_sw_inputs``, the start of every kernel
    solve) makes no tensor from host data on a device: on the card such a
    copy blocks the host until the card is done, and the entries of a mesh,
    launched one after another from one thread, would then run one after
    another (the key-species index is built once per lookup). On the CPU the
    copies are counted: a ``device`` passed to torch.tensor /
    torch.as_tensor."""
    from rrtmgp_tpu_torch.ops.mega_inputs import mega_lw_inputs, mega_sw_inputs

    atm = _port(*_inputs())[0]
    calls = ((mega_lw_inputs, T_LOOKUPS.lookup_lw), (mega_sw_inputs, T_LOOKUPS.lookup_sw))
    for fn, lkp in calls:
        fn(lkp, atm)
    made = []
    for name in ("tensor", "as_tensor"):
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kw):
            if kw.get("device") is not None:
                made.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(torch, name, counted)
    for fn, lkp in calls:
        fn(lkp, atm)
    assert made == []
