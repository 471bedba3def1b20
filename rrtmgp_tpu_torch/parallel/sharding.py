"""Column sharding over a mesh of devices (counterpart of
``rrtmgp_tpu/parallel/sharding.py``).

The only parallel strategy of RTE+RRTMGP is a decomposition over columns:
every column is solved on its own, so a split needs no communication. Here
a ``ColumnMesh`` is an ordered, 1-D tuple of (process rank, device)
entries; ``shard_columns`` cuts the column tensors of a state or
boundary-condition tree into one contiguous slice per entry, ``replicate``
copies the lookups once to each device, and ``shard_solve`` runs a solve
once per entry of this process on that entry's columns. The shards launch
one after the other from one thread; CUDA launches are asynchronous, so
entries on separate GPUs run at the same time. The solve has no collective
and no host synchronisation.

An entry may repeat a device: the CPU tests split 8 ways over one CPU, and
one card can check a split of its own.

Not built on ``torch.distributed.tensor``: its ``DeviceMesh`` wants one
process per device, and the kernels take plain tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..states import _COLUMN_LEADING, TensorContainer, VmrGM, slice_columns, tree_map_columns

COLUMN_AXIS = "col"


def process_index() -> int:
    """This process's rank in the default ``torch.distributed`` group, 0
    without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index (``cuda`` alone means the
    current CUDA device)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class MeshEntry(NamedTuple):
    process: int
    device: torch.device


class ColumnMesh(tuple):
    """An ordered 1-D mesh over the column axis: a tuple of ``MeshEntry``.
    Entry ``k`` of a mesh of ``n`` holds columns ``[k * ncol // n, (k + 1) *
    ncol // n)``."""

    axis_names = (COLUMN_AXIS,)

    def __new__(cls, entries):
        return super().__new__(cls, (MeshEntry(int(p), _device(d)) for p, d in entries))

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(e.device for e in self)

    def local_indices(self) -> tuple[int, ...]:
        """Positions of this process's entries, in mesh order."""
        me = process_index()
        return tuple(k for k, e in enumerate(self) if e.process == me)


def make_column_mesh(devices=None) -> ColumnMesh:
    """1-D mesh over this process's CUDA devices, or over ``devices`` (in
    the order given; a device may repeat)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_column_mesh: no CUDA device; pass the devices, e.g. ['cpu'] * 8")
    me = process_index()
    return ColumnMesh((me, d) for d in devices)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where ``shard_columns`` / ``replicate`` put a tensor on a mesh: its
    trailing (column) axis split over the entries, or a whole copy on every
    device. The counterpart of a JAX ``NamedSharding``."""

    mesh: ColumnMesh
    split_columns: bool

    def put(self, tree, ncol: int | None = None):
        """Split ``tree`` of ``ncol`` columns over the mesh (a
        ``ColumnSharded`` of this process's entries), or copy it once to each
        device of this process's entries (``Replicas``)."""
        index = self.mesh.local_indices()
        if self.split_columns:
            return _shard(tree, self.mesh, ncol, index)
        return Replicas({d: _put(tree, d) for d in dict.fromkeys(self.mesh[k].device for k in index)})


def column_sharding(mesh: ColumnMesh) -> Placement:
    """Placement of a tensor whose LAST axis is columns."""
    return Placement(mesh, True)


def replicated(mesh: ColumnMesh) -> Placement:
    return Placement(mesh, False)


def _per_entry(ncol: int, mesh: ColumnMesh) -> int:
    if not len(mesh):
        raise ValueError("the mesh has no entries")
    if ncol % len(mesh):
        raise ValueError(f"ncol={ncol} does not divide over a mesh of {len(mesh)} entries")
    return ncol // len(mesh)


def _put(tree, device: torch.device):
    """``tree`` with its tensors on ``device``; the tree itself where they
    all are there already (so a lookup keeps its built kernel tables)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
        moved = {k: _put(v, device) for k, v in fields.items()}
        if all(moved[k] is fields[k] for k in fields):
            return tree
        return dataclasses.replace(tree, **moved)
    if isinstance(tree, tuple):
        moved = [_put(v, device) for v in tree]
        if all(a is b for a, b in zip(moved, tree)):
            return tree
        return type(tree)(*moved) if hasattr(tree, "_fields") else tuple(moved)
    return tree


class Replicas(dict):
    """A tree's copies keyed by device (``replicate``); ``shard_solve``
    hands each entry the copy on its device."""


def replicate(tree, mesh: ColumnMesh) -> Replicas:
    """Copy a tree (e.g. a ``LookupBundle``) once to each distinct device
    of this process's mesh entries; a device that already holds it gets the tree itself.
    Replicate at construction: a new copy of a lookup builds its kernel
    tables on first use."""
    return replicated(mesh).put(tree)


class ColumnSharded:
    """This process's column slices of a tree split over a mesh: for each
    of its mesh entries (``index``, in mesh order) that entry's columns as
    an ordinary state, boundary-condition or flux tree on the entry's
    device, of ``ncol`` columns in all.

    Reading a field (``sharded.flux_up``, ``sharded.cloud_state``) or an
    item (``sharded[0]``, tuple unpacking) reads it in every slice:
    column values stay sharded, a value every slice holds alike (a
    global-mean VMR, a static field) comes back once, and None where every
    slice has None. ``np.asarray`` of a sharded tensor gives the process's
    columns, concatenated, as a JAX global array does in one process."""

    __slots__ = ("mesh", "ncol", "index", "shards", "axis")

    def __init__(self, mesh: ColumnMesh, ncol: int, index, shards, axis: int = -1):
        self.mesh, self.ncol, self.index, self.shards, self.axis = mesh, ncol, tuple(index), tuple(shards), axis

    @property
    def offsets(self) -> tuple[int, ...]:
        """Global column offset of each slice."""
        per = self.ncol // len(self.mesh)
        return tuple(k * per for k in self.index)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(self.mesh[k].device for k in self.index)

    def _wrap(self, values, axis: int = -1, same_everywhere: bool = False):
        first = values[0]
        if all(v is None for v in values):
            return None
        if isinstance(first, torch.Tensor):
            per = self.ncol // len(self.mesh)
            if same_everywhere or first.ndim == 0 or first.shape[axis] != per:
                return first
            return ColumnSharded(self.mesh, self.ncol, self.index, values, axis)
        if isinstance(first, (TensorContainer, tuple)) and not isinstance(first, torch.Size):
            return ColumnSharded(self.mesh, self.ncol, self.index, values)
        if any(v != first for v in values[1:]):
            raise ValueError(f"the slices disagree on a value that is not per column: {values}")
        return first

    def map(self, fn):
        """``fn`` applied to every slice, wrapped like a field read."""
        return self._wrap([fn(s) for s in self.shards])

    def __getattr__(self, name):
        if name.startswith("__") or name in ColumnSharded.__slots__:
            raise AttributeError(name)
        values = [getattr(s, name) for s in self.shards]
        return self._wrap(values, axis=0 if name in _COLUMN_LEADING else -1,
                          same_everywhere=name == "vmr" and isinstance(self.shards[0], VmrGM))

    def __getitem__(self, key):
        return self._wrap([s[key] for s in self.shards])

    def __len__(self):
        return len(self.shards[0])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @property
    def shape(self) -> tuple[int, ...]:
        """Global shape of a sharded tensor."""
        shape = list(self.shards[0].shape)
        shape[self.axis] = self.ncol
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([s.detach().cpu().numpy() for s in self.shards], axis=self.axis)
        return out if dtype is None else out.astype(dtype)

    def __repr__(self):
        return (f"ColumnSharded({type(self.shards[0]).__name__}, ncol={self.ncol}, "
                f"entries {list(self.index)} of {len(self.mesh)})")


def _shard(tree, mesh: ColumnMesh, ncol: int, index, lo: int = 0, n_here: int | None = None):
    """The slices of the entries ``index`` of a tree that holds columns
    ``[lo, lo + n_here)`` of ``ncol`` (all of them by default): its column
    leaves cut by ``states.slice_columns`` (a leaf of all ``ncol`` columns
    is cut at the global offsets), every other leaf copied once to each
    device."""
    per = _per_entry(ncol, mesh)
    n_here = ncol if n_here is None else n_here
    copies = {}

    def put(x, device):
        if x.ndim and x.shape[-1] == per:  # an entry's columns
            return x.to(device)
        key = (x.data_ptr(), x.shape, x.stride(), x.dtype, device)
        if key not in copies:
            copies[key] = x.to(device)
        return copies[key]

    shards = []
    for k in index:
        a, b, device = k * per, (k + 1) * per, mesh[k].device
        part = slice_columns(tree, a - lo, b - lo, n_here)
        if n_here != ncol:
            part = slice_columns(part, a, b, ncol)
        shards.append(tree_map_columns(lambda x: put(x, device), lambda x: put(x, device), part))
    return ColumnSharded(mesh, ncol, index, shards)


def shard_columns(tree, mesh: ColumnMesh, ncol: int) -> ColumnSharded:
    """Split a state, boundary-condition or flux tree (or a tensor) of
    ``ncol`` columns over the mesh: this process's entries get their
    columns, cut through ``states.tree_map_columns`` (which knows the
    ``VmrGM`` vector and the column-leading incident fluxes); every other
    leaf is copied once to each device. ``ncol`` must divide by the mesh
    size (``ValueError``)."""
    return column_sharding(mesh).put(tree, ncol)


def column_ids(mesh: ColumnMesh, ncol: int) -> ColumnSharded:
    """The global column ids ``arange(ncol)`` split over the mesh and held
    on the host: a solve reads its slice's first id, its global column
    offset, with no device synchronisation."""
    per = _per_entry(ncol, mesh)
    index = mesh.local_indices()
    return ColumnSharded(mesh, ncol, index, [torch.arange(k * per, (k + 1) * per) for k in index])


def _shard_arg(x, mesh: ColumnMesh, ncol: int):
    """Per-entry values of one argument of ``shard_solve``."""
    index = mesh.local_indices()
    if isinstance(x, ColumnSharded):
        if x.mesh != mesh or x.ncol != ncol or x.index != index:
            raise ValueError(f"{x!r} is not split over this mesh at ncol={ncol}")
        return list(x.shards)
    if isinstance(x, Replicas):
        return [x[mesh[k].device] for k in index]
    if isinstance(x, (torch.Tensor, TensorContainer)):
        return list(shard_columns(x, mesh, ncol).shards)
    return [x] * len(index)


def shard_solve(fn, mesh: ColumnMesh, ncol: int):
    """``fn`` run once per entry of this process on that entry's columns.

    The returned function takes ``fn``'s arguments: ``ColumnSharded``
    trees (their slices), whole state / boundary-condition trees and
    tensors of ``ncol`` columns (split by ``shard_columns``), ``Replicas``
    (each entry gets the copy on its device) and static values (seeds,
    None), passed as they are. It returns ``fn``'s result per entry as a
    ``ColumnSharded``. Each call runs under ``torch.cuda.device`` of its
    entry. ``ncol`` must divide by the mesh size (``ValueError``).

    Inside ``fn``, read the slice's global column offset from a
    ``column_ids(mesh, ncol)`` argument (``int(col_ids[0])``) and pass it
    as ``col_offset`` to ``solve_lw`` / ``solve_sw``, so that the McICA
    sample does not depend on the mesh.
    """
    _per_entry(ncol, mesh)

    def wrapped(*args):
        index = mesh.local_indices()
        per_arg = [_shard_arg(x, mesh, ncol) for x in args]
        outs = []
        for j, k in enumerate(index):
            device = mesh[k].device
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                outs.append(fn(*(values[j] for values in per_arg)))
        return ColumnSharded(mesh, ncol, index, outs)

    return wrapped

