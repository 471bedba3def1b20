"""Several processes solving one column split (counterpart of
``rrtmgp_tpu/parallel/distributed.py``).

RTE+RRTMGP needs no communication between processes: each process solves
its own columns and the host model owns the decomposition. The port keeps
that: one global 1-D column mesh over every process's devices, in rank
order, so that each process owns a contiguous column range; lookups are
replicated per process and no tensor of a solve crosses a process. The
process group (gloo) carries only the setup: one exchange of the device
lists. gloo, unlike NCCL, lets two ranks share one GPU.

Usage (one process per host or per GPU, e.g. under ``torchrun``):

    from rrtmgp_tpu_torch.parallel import distributed as dist
    dist.initialize()                       # MASTER_ADDR/PORT, WORLD_SIZE, RANK
    mesh = dist.global_column_mesh()
    lo, hi = dist.process_column_range(ncol_global, mesh)
    atm_local = build_my_columns(lo, hi)    # the host model's columns
    atm = dist.globalize(atm_local, mesh, ncol_global)
    solver = RRTMGPSolver(..., as_=atm, mesh=mesh)
    mine = dist.local_values(solver.flux_lw)

Every process runs the same program; each holds ``ColumnSharded`` values
of its own entries.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..states import tree_leaves, tree_unflatten
from .sharding import ColumnMesh, ColumnSharded, _shard, make_column_mesh, process_index

#: CUDA device indices of this process's mesh entries (``initialize``'s
#: ``local_device_ids``); None: all the process sees
_LOCAL_DEVICE_IDS: list[int] | None = None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Join the default ``torch.distributed`` process group (gloo);
    idempotent, and a group that already exists is kept.

    With no arguments it reads ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``, as ``torchrun`` sets them. A ``"host:port"``
    address becomes ``tcp://host:port``. ``local_device_ids`` names the
    CUDA devices of this process's mesh entries (default: all it sees)."""
    global _LOCAL_DEVICE_IDS
    dist = torch.distributed
    if local_device_ids is not None:
        _LOCAL_DEVICE_IDS = [int(i) for i in local_device_ids]
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("initialize: no coordinator_address and no MASTER_ADDR / MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    try:
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank)
    except (RuntimeError, ValueError) as e:  # another library made the group first
        if "already" not in str(e).lower():
            raise


def local_devices() -> list[torch.device]:
    """This process's CUDA devices (those ``initialize`` named, else all)."""
    ids = range(torch.cuda.device_count()) if _LOCAL_DEVICE_IDS is None else _LOCAL_DEVICE_IDS
    return [torch.device("cuda", i) for i in ids]


def global_column_mesh(devices=None) -> ColumnMesh:
    """1-D mesh over every process's devices, in rank order (so each
    process owns a contiguous column range). ``devices``: this process's
    (default ``local_devices()``); the lists are exchanged once, here."""
    devices = [str(torch.device(d)) for d in (local_devices() if devices is None else devices)]
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return make_column_mesh(devices)
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, devices)
    return ColumnMesh((rank, d) for rank, ds in enumerate(lists) for d in ds)


def process_column_range(ncol_global: int, mesh: ColumnMesh | None = None) -> tuple[int, int]:
    """[lo, hi) global column range of THIS process under the mesh.
    ``ValueError`` when ``ncol_global`` does not divide by the mesh size,
    when the process has no entry, or when its entries are not contiguous."""
    mesh = global_column_mesh() if mesh is None else mesh
    n = len(mesh)
    if not n or ncol_global % n:
        raise ValueError(f"ncol={ncol_global} does not divide over a mesh of {n} entries")
    per = ncol_global // n
    mine = list(mesh.local_indices())
    if not mine:
        raise ValueError(f"process {process_index()} owns no entry of the mesh")
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("this process's mesh entries are not contiguous; build the mesh with "
                         "global_column_mesh()")
    return mine[0] * per, (mine[-1] + 1) * per


def globalize(local_tree, mesh: ColumnMesh, ncol_global: int) -> ColumnSharded:
    """This process's column slice (``process_column_range`` columns) of a
    state or boundary-condition tree, split over its own entries with their
    global offsets. A tree of all ``ncol_global`` columns (one process) is
    split the same way; leaves that are not per column (lookups, global-mean
    VMRs, scalars) must be the same in every process and are copied to
    each device."""
    lo, hi = process_column_range(ncol_global, mesh)
    return _shard(local_tree, mesh, ncol_global, mesh.local_indices(), lo, hi - lo)


def _join(parts: list, size: int):
    """One leaf of every slice as one numpy array of this process's columns
    (the column axis trailing, or leading for the incident fluxes); a
    leaf every slice holds alike once."""
    arrays = [p.detach().cpu().numpy() for p in parts]
    if all(a.ndim and a.shape[-1] == size for a in arrays):
        return np.concatenate(arrays, axis=-1)
    if all(a.ndim and a.shape[0] == size for a in arrays):
        return np.concatenate(arrays, axis=0)
    return arrays[0]


def local_values(tree):
    """This process's contiguous columns of sharded values (a
    ``ColumnSharded``, or tuples, lists and dicts of them) as host numpy
    arrays, the inverse of ``globalize`` for results; a plain tensor as
    numpy."""
    if isinstance(tree, ColumnSharded):
        size = tree.ncol // len(tree.mesh)
        first = tree.shards[0]
        if isinstance(first, torch.Tensor):
            return np.asarray(tree)
        leaves = zip(*(tree_leaves(s) for s in tree.shards), strict=True)
        return tree_unflatten(first, [_join(list(parts), size) for parts in leaves])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: local_values(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(local_values(v) for v in tree)
    if isinstance(tree, tuple):
        return type(tree)(*(local_values(v) for v in tree))
    return tree
