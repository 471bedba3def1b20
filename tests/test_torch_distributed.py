"""Two processes solving one column split (rrtmgp_tpu_torch.parallel.distributed)
on the CPU, joined by gloo on a free localhost port.

Each process has two CPU mesh entries (a global mesh of 4), builds only its
own columns, as a host model would, globalizes them, and solves them twice:
``shard_solve`` of ``solve_lw`` (two-stream) and an all-sky
``RRTMGPSolver(mesh=global_column_mesh())`` with fractional cloud. Its
``local_values`` must equal the same columns of the port's unsplit solves
bit for bit and the JAX package's within 1e-4 of the largest flux of the
solve (8 layers, as tests/test_torch_sharding.py). The processes import
no JAX: each writes its columns to a file, which the test reads.
"""

import dataclasses
import os
import socket
import subprocess
import sys

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

NCOL, NLAY, NGPT, NBND = 32, 8, 16, 2
TOL = 1e-4
TIMEOUT_S = 120

_WORKER = r"""
import dataclasses, os, sys
sys.path.insert(0, os.environ["RRTMGP_REPO"])
import numpy as np
import torch

torch.set_num_threads(1)
import rrtmgp_tpu_torch as rt
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere, synthetic_cloud_lookup, synthetic_gas_lookup
from rrtmgp_tpu_torch.parallel import distributed as dist
from rrtmgp_tpu_torch.parallel.sharding import replicate, shard_solve
from rrtmgp_tpu_torch.states import slice_columns

NCOL, NLAY, NGPT, NBND = {NCOL}, {NLAY}, {NGPT}, {NBND}
pid = int(os.environ["DIST_PID"])
dist.initialize(coordinator_address=os.environ["DIST_COORD"], num_processes=2, process_id=pid)
mesh = dist.global_column_mesh(["cpu", "cpu"])
assert [e.process for e in mesh] == [0, 0, 1, 1], mesh
lo, hi = dist.process_column_range(NCOL, mesh)
assert (lo, hi) == (16 * pid, 16 * pid + 16), (lo, hi)

kw = dict(dtype=np.float32, device="cpu")
L = rt.LookupBundle(
    lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, **kw),
    lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, **kw),
    lookup_lw_cld=synthetic_cloud_lookup(n_bnd=NBND, **kw),
    lookup_sw_cld=synthetic_cloud_lookup(n_bnd=NBND, seed=5, **kw),
)
# this process's columns only, as a host model holds them
atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, with_clouds=True, **kw)
cs = atm.cloud_state
atm = dataclasses.replace(atm, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * 0.6))
f = lambda shape, v: torch.full(shape, v)
bl = rt.LwBCs(sfc_emis=f((NBND, NCOL), 0.98))
bs = rt.SwBCs(cos_zenith=f((NCOL,), 0.6), toa_flux=f((NCOL,), 1361.0), sfc_alb_direct=f((NBND, NCOL), 0.2),
              sfc_alb_diffuse=f((NBND, NCOL), 0.25))
mine = lambda t: slice_columns(t, lo, hi, NCOL)
g_atm, g_bl, g_bs = (dist.globalize(mine(t), mesh, NCOL) for t in (atm, bl, bs))
assert g_atm.offsets == (32 * pid // 2, 32 * pid // 2 + 8) and g_atm.ncol == NCOL

solve = lambda lk, a, b: rt.solve_lw(lk, a, b, two_stream=True)[0]
clear = dist.local_values(shard_solve(solve, mesh, NCOL)(replicate(L.lookup_lw, mesh), g_atm, g_bl))
grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL)
solver = rt.RRTMGPSolver(grid, rt.AllSkyRadiation(), rt.RRTMGPParameters(), g_bl, g_bs, g_atm, lookups=L,
                         mesh=mesh)
solver.advance_step(3)
lw, sw = solver.update_fluxes()
out = dist.local_values(dict(lw=lw, sw=sw, lw_cover=solver.lw_cloud_cover(), sw_cover=solver.sw_cloud_cover()))
np.savez(os.environ["DIST_OUT"], lo=lo, hi=hi, clear_up=clear.flux_up, clear_dn=clear.flux_dn,
         **{{f"lw_{{k}}": v for k, v in out["lw"]._asdict().items()}},
         **{{f"sw_{{k}}": v for k, v in out["sw"]._asdict().items()}},
         lw_cover=out["lw_cover"], sw_cover=out["sw_cover"])
torch.distributed.destroy_process_group()
print(f"DIST-OK pid={{pid}}")
""".format(NCOL=NCOL, NLAY=NLAY, NGPT=NGPT, NBND=NBND)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the two processes; their outputs by rank."""
    out_dir = tmp_path_factory.mktemp("dist")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # nothing but the repo: the workers import no JAX
    env.update(RRTMGP_REPO=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               DIST_COORD=f"localhost:{_free_port()}", OMP_NUM_THREADS="1")
    procs = []
    for pid in range(2):
        e = dict(env, DIST_PID=str(pid), DIST_OUT=str(out_dir / f"rank{pid}.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert f"DIST-OK pid={pid}" in out
    return [dict(np.load(out_dir / f"rank{pid}.npz")) for pid in range(2)]


def _inputs():
    ja = jsyn.synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=True)
    cs = ja.cloud_state
    ja = dataclasses.replace(ja, cloud_state=dataclasses.replace(cs, cld_frac=cs.cld_frac * 0.6))
    bc_lw = dict(sfc_emis=np.full((NBND, NCOL), 0.98, np.float32))
    bc_sw = dict(cos_zenith=np.full(NCOL, 0.6, np.float32), toa_flux=np.full(NCOL, 1361.0, np.float32),
                 sfc_alb_direct=np.full((NBND, NCOL), 0.2, np.float32),
                 sfc_alb_diffuse=np.full((NBND, NCOL), 0.25, np.float32))
    return ja, bc_lw, bc_sw


def _lookups():
    j = jrt.LookupBundle(
        lookup_lw=jsyn.synthetic_gas_lookup(longwave=True, n_gpt=NGPT, n_bnd=NBND, dtype=np.float32),
        lookup_sw=jsyn.synthetic_gas_lookup(longwave=False, n_gpt=NGPT, n_bnd=NBND, seed=1, dtype=np.float32),
        lookup_lw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, dtype=np.float32),
        lookup_sw_cld=jsyn.synthetic_cloud_lookup(n_bnd=NBND, seed=5, dtype=np.float32),
    )
    return j, rt.LookupBundle(
        lookup_lw=convert.gas_lookup_from_object(j.lookup_lw), lookup_sw=convert.gas_lookup_from_object(j.lookup_sw),
        lookup_lw_cld=convert.cloud_lookup_from_object(j.lookup_lw_cld),
        lookup_sw_cld=convert.cloud_lookup_from_object(j.lookup_sw_cld))


def _max_rel(pairs) -> float:
    err = scale = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape and np.all(np.isfinite(a))
        err, scale = max(err, np.abs(a - b).max()), max(scale, np.abs(b).max())
    return err / scale


@pytest.mark.parametrize("rank", [0, 1])
def test_each_process_holds_its_columns_of_the_whole_solve(worlds, rank):
    got = worlds[rank]
    lo, hi = int(got["lo"]), int(got["hi"])
    assert (lo, hi) == ((0, 16), (16, 32))[rank]
    ja, bc_lw, bc_sw = _inputs()
    jl, tl = _lookups()
    atm = convert.atmosphere_from_object(ja, device="cpu")
    tb = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    bl, bs = rt.LwBCs(**tb(bc_lw)), rt.SwBCs(**tb(bc_sw))
    cols = lambda x: np.asarray(x)[..., lo:hi]

    # shard_solve of solve_lw: bitwise the port's whole solve, within TOL of JAX's
    whole = rt.solve_lw(tl.lookup_lw, atm, bl, two_stream=True)[0]
    assert np.array_equal(got["clear_up"], cols(whole.flux_up))
    assert np.array_equal(got["clear_dn"], cols(whole.flux_dn))
    ref = jax.jit(lambda a, b: jmod.solve_lw(jl.lookup_lw, a, b, two_stream=True)[0])(ja, jrt.LwBCs(**bc_lw))
    assert _max_rel([(got["clear_up"], cols(ref.flux_up)), (got["clear_dn"], cols(ref.flux_dn))]) <= TOL

    # the all-sky solver over the global mesh: bitwise the unsplit port solver
    grid = rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL)
    solver = rt.RRTMGPSolver(grid, rt.AllSkyRadiation(), rt.RRTMGPParameters(), bl, bs, atm, lookups=tl)
    solver.advance_step(3)
    lw, sw = solver.update_fluxes()
    for name in lw._fields:
        assert np.array_equal(got[f"lw_{name}"], cols(getattr(lw, name))), name
    for name in sw._fields:
        assert np.array_equal(got[f"sw_{name}"], cols(getattr(sw, name))), name
    for wave in ("lw", "sw"):
        cover = got[f"{wave}_cover"]
        assert np.array_equal(cover, cols(getattr(solver, f"{wave}_cloud_cover")()))
        assert 0.0 < cover.mean() < 0.67, cover.mean()
    # and within TOL of JAX's unsplit solver
    jgrid = jrt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL, dtype=jnp.float32)
    js = jrt.RRTMGPSolver(jgrid, jrt.AllSkyRadiation(), jrt.RRTMGPParameters(), jrt.LwBCs(**bc_lw),
                          jrt.SwBCs(**bc_sw), ja, lookups=jl)
    js.advance_step(3)
    jlw, jsw = js.update_fluxes()
    assert _max_rel([(got[f"lw_{n}"], cols(getattr(jlw, n))) for n in lw._fields]) <= TOL
    assert _max_rel([(got[f"sw_{n}"], cols(getattr(jsw, n))) for n in sw._fields]) <= TOL
    np.testing.assert_allclose(got["lw_cover"], cols(js.lw_cloud_cover()), rtol=1e-6)


def test_process_column_range_refuses_what_jax_asserts():
    """ValueError where the JAX package asserts: a column count the mesh
    does not divide, a process without an entry, entries out of order."""
    from rrtmgp_tpu_torch.parallel.sharding import ColumnMesh

    mine = ColumnMesh([(0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu")])
    assert dist.process_column_range(NCOL, mine) == (0, 16)
    with pytest.raises(ValueError, match="does not divide"):
        dist.process_column_range(30, mine)
    with pytest.raises(ValueError, match="owns no entry"):
        dist.process_column_range(NCOL, ColumnMesh([(1, "cpu"), (1, "cpu")]))
    with pytest.raises(ValueError, match="not contiguous"):
        dist.process_column_range(NCOL, ColumnMesh([(0, "cpu"), (1, "cpu"), (0, "cpu"), (1, "cpu")]))


def test_initialize_reads_the_torchrun_environment(monkeypatch):
    """initialize() with no arguments joins the group MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK name (a world of one here); a second
    call keeps it; the mesh then comes from the group's exchange."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert not torch.distributed.is_initialized()
    try:
        dist.initialize()
        dist.initialize()
        assert torch.distributed.is_initialized() and torch.distributed.get_backend() == "gloo"
        mesh = dist.global_column_mesh(["cpu", "cpu"])
        assert [(e.process, str(e.device)) for e in mesh] == [(0, "cpu"), (0, "cpu")]
    finally:
        torch.distributed.destroy_process_group()
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        dist.initialize()
