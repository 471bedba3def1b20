"""Atmospheric state containers and state precompute ops (counterpart of
``rrtmgp_tpu/states.py``).

Containers are plain dataclasses of tensors with a ``.to(device, dtype)``
method. Layout matches the JAX package: (nlay, ncol) / (nlay+1, ncol),
level 0 = surface.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops.bounds import at_least
from .parameters import RRTMGPParameters


class TensorContainer:
    """Mixin for dataclasses whose fields are tensors, None, or containers."""

    def to(self, device=None, dtype: torch.dtype | None = None):
        """Copy with every floating tensor moved to ``device`` and, when given,
        cast to ``dtype``; integer and bool tensors keep their dtype."""

        def move(x):
            cast = dtype if dtype is not None and x.is_floating_point() else None
            return x.to(device=device, dtype=cast)

        return tree_unflatten(self, [move(x) for x in tree_leaves(self)])


# ---------------------------------------------------------------------------
# Volume mixing ratios
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VmrGM(TensorContainer):
    """Global-mean VMRs: 2D h2o + o3, global means for all other gases.

    ``vmr`` is indexed by the 1-based gas index of the gas lookup
    (position 0 unused).
    """

    vmr_h2o: torch.Tensor  # (nlay, ncol)
    vmr_o3: torch.Tensor   # (nlay, ncol)
    vmr: torch.Tensor      # (ngas+1,)


@dataclasses.dataclass(frozen=True)
class Vmr(TensorContainer):
    """Fully 3D VMRs ``(ngas+1, nlay, ncol)``."""

    vmr: torch.Tensor


def get_vmr(vmr, ig: int) -> torch.Tensor:
    """VMR of gas ``ig`` (1-based index; 0 = none -> 1.0).

    For VmrGM, ig 1 = h2o and ig 3 = o3 are 2D; other gases are global means
    (0-dim tensors).
    """
    if isinstance(vmr, VmrGM):
        if ig == 0:
            return torch.ones((), dtype=vmr.vmr_h2o.dtype, device=vmr.vmr_h2o.device)
        if ig == 1:
            return vmr.vmr_h2o
        if ig == 3:
            return vmr.vmr_o3
        return vmr.vmr[ig]
    if isinstance(vmr, Vmr):
        if ig == 0:
            return torch.ones((), dtype=vmr.vmr.dtype, device=vmr.vmr.device)
        return vmr.vmr[ig]
    raise TypeError(f"unknown vmr container {type(vmr)}")


# ---------------------------------------------------------------------------
# Cloud / aerosol states
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CloudState(TensorContainer):
    """Cloud state, every field (nlay, ncol)."""

    cld_r_eff_liq: torch.Tensor
    cld_r_eff_ice: torch.Tensor
    cld_path_liq: torch.Tensor
    cld_path_ice: torch.Tensor
    cld_frac: torch.Tensor
    ice_rgh: int = 2  # 1 = none, 2 = medium, 3 = rough


@dataclasses.dataclass(frozen=True)
class AerosolState(TensorContainer):
    """Aerosol state: size and mass (n_aero, nlay, ncol) in MERRA type order
    (``ops.aerosol_optics`` index constants)."""

    aero_size: torch.Tensor
    aero_mass: torch.Tensor


# ---------------------------------------------------------------------------
# Atmospheric state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AtmosphericState(TensorContainer):
    """Full-physics atmospheric state."""

    p_lay: torch.Tensor    # (nlay, ncol)
    t_lay: torch.Tensor    # (nlay, ncol)
    p_lev: torch.Tensor    # (nlay+1, ncol)
    t_lev: torch.Tensor    # (nlay+1, ncol)
    t_sfc: torch.Tensor    # (ncol,)
    col_dry: torch.Tensor  # (nlay, ncol) molecules/cm^2
    vmr: VmrGM | Vmr
    rel_hum: torch.Tensor | None = None  # (nlay, ncol), aerosol path only
    cloud_state: CloudState | None = None
    aerosol_state: AerosolState | None = None
    lon: torch.Tensor | None = None
    lat: torch.Tensor | None = None

    @property
    def nlay(self) -> int:
        return self.p_lay.shape[0]

    @property
    def ncol(self) -> int:
        return self.p_lay.shape[-1]


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LwBCs(TensorContainer):
    """Longwave boundary conditions."""

    sfc_emis: torch.Tensor                 # (nbnd, ncol)
    inc_flux: torch.Tensor | None = None   # (ncol, ngpt)


@dataclasses.dataclass(frozen=True)
class SwBCs(TensorContainer):
    """Shortwave boundary conditions."""

    cos_zenith: torch.Tensor       # (ncol,)
    toa_flux: torch.Tensor         # (ncol,)
    sfc_alb_direct: torch.Tensor   # (nbnd, ncol)
    sfc_alb_diffuse: torch.Tensor  # (nbnd, ncol)
    inc_flux_diffuse: torch.Tensor | None = None  # (ncol, ngpt)


# ---------------------------------------------------------------------------
# Tree walks and column maps
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensors of a container, tuple or namedtuple tree (nested), in
    field order; None and static fields are not leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TensorContainer):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return []


def tree_unflatten(tree, leaves):
    """``tree`` with its tensors replaced, in ``tree_leaves`` order, by the
    items of ``leaves``; containers and namedtuples keep their type."""
    it = iter(leaves)

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, TensorContainer):
            return dataclasses.replace(x, **{f.name: rebuild(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            vals = [rebuild(t) for t in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    return rebuild(tree)


#: boundary-condition fields laid out (ncol, ngpt): the column axis leads
_COLUMN_LEADING = ("inc_flux", "inc_flux_diffuse")


def tree_map_columns(col_fn, other_fn, tree):
    """Map ``col_fn`` over the tensors of a state or boundary-condition
    container that may carry a trailing column axis, and ``other_fn`` over
    those known not to; None and static fields pass through.

    Column helpers (slice, chunk, shard) recognise a column tensor by the
    size of its trailing axis. One tensor defeats that test: the ``VmrGM``
    global-mean vector, shape (ngas+1,), looks like a column tensor whenever
    ncol == ngas+1, and slicing it would corrupt every gas concentration; it
    is excluded by type. The incident fluxes of ``LwBCs`` / ``SwBCs`` are
    (ncol, ngpt): ``col_fn`` sees them transposed, column axis trailing, and
    its result is transposed back into a contiguous tensor.
    """
    rec = lambda x: tree_map_columns(col_fn, other_fn, x)
    if isinstance(tree, VmrGM):
        return VmrGM(col_fn(tree.vmr_h2o), col_fn(tree.vmr_o3), other_fn(tree.vmr))
    if isinstance(tree, TensorContainer):
        new = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if f.name in _COLUMN_LEADING and isinstance(v, torch.Tensor):
                new[f.name] = col_fn(v.T).T.contiguous()
            else:
                new[f.name] = rec(v)
        return dataclasses.replace(tree, **new)
    if isinstance(tree, torch.Tensor):
        return col_fn(tree)
    return tree


def slice_columns(tree, lo: int, hi: int, ncol: int):
    """Columns [lo, hi) of a state or boundary-condition container of
    ``ncol`` columns, every cut tensor contiguous (the kernels need that)."""

    def cut(x):
        if x.ndim == 0 or x.shape[-1] != ncol:
            return x
        return x[..., lo:hi].contiguous()

    return tree_map_columns(cut, lambda x: x, tree)


# ---------------------------------------------------------------------------
# Precompute ops
# ---------------------------------------------------------------------------


def compute_col_gas(
    p_lev: torch.Tensor,
    params: RRTMGPParameters,
    vmr_h2o: torch.Tensor | None = None,
    lat: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hydrostatic column density of moist air [molecules/cm^2], (nlay, ncol).

    Helmert gravity when latitude is given.
    """
    helmert1 = params.grav
    helmert2 = 0.02586
    m2_to_cm2 = 1.0e4
    if lat is not None:
        g0 = (helmert1 - helmert2 * torch.cos(2.0 * torch.pi * lat / 180.0))[None, :]
    else:
        g0 = helmert1
    dp = p_lev[:-1] - p_lev[1:]  # positive: level 0 = surface
    vmr = 0.0 if vmr_h2o is None else vmr_h2o
    m_air = params.molmass_dryair + params.molmass_water * vmr
    return dp * params.avogad / (m2_to_cm2 * m_air * g0)


def compute_relative_humidity(
    p_lay: torch.Tensor,
    t_lay: torch.Tensor,
    vmr_h2o: torch.Tensor,
    params: RRTMGPParameters,
) -> torch.Tensor:
    """Relative humidity used by MERRA aerosol optics, (nlay, ncol)
    (Magnus-type formula)."""
    mwd = params.molmass_water / params.molmass_dryair
    t_ref = 273.16
    q_lay_min = 1e-7
    mmr_h2o = vmr_h2o * mwd
    q_lay = mmr_h2o / (1.0 + mmr_h2o)
    q_tmp = at_least(q_lay, q_lay_min)
    es_tmp = torch.exp((17.67 * (t_lay - t_ref)) / (t_lay - 29.65))
    return at_least(0.01 * (0.263 * p_lay * q_tmp) / es_tmp, 0.0)
