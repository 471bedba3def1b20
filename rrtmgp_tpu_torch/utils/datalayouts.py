"""Index-order-tagged data layouts for host-model interop (counterpart of
``rrtmgp_tpu/utils/datalayouts.py``): a host model hands over its arrays in
its own index order, tagged by ``RRTMGPData``, and broadcasts scalars,
columns or levels into the radiation grid with ``set_cols`` /
``set_domain``.

The wrappers are immutable, as in the JAX package: ``set_cols(data, value)``
returns a new wrapper. Orders, dimensions leading to trailing:

  NVCOrder  (N, vertical, column)
  VCOrder   (vertical, column)
  NCOrder   (N, column)
  NOrder    (N,)
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ..convert import default_device


class NVCOrder:
    ndim: ClassVar[int] = 3


class VCOrder:
    ndim: ClassVar[int] = 2


class NCOrder:
    ndim: ClassVar[int] = 2


class NOrder:
    ndim: ClassVar[int] = 1


@dataclasses.dataclass(frozen=True)
class RRTMGPData:
    """A tensor tagged with its index order."""

    array: torch.Tensor
    order: type = VCOrder

    def __post_init__(self):
        if self.array.ndim != self.order.ndim:
            raise ValueError(f"{self.order.__name__} expects {self.order.ndim}D, got {self.array.ndim}D")

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=default_device() if device is None else device)


def nvc_data(nlay: int, ncol: int, n: int = 1, dtype=torch.float32, device=None) -> RRTMGPData:
    return RRTMGPData(_zeros((n, nlay, ncol), dtype, device), NVCOrder)


def vc_data(nlay: int, ncol: int, dtype=torch.float32, device=None) -> RRTMGPData:
    return RRTMGPData(_zeros((nlay, ncol), dtype, device), VCOrder)


def nc_data(ncol: int, n: int = 1, dtype=torch.float32, device=None) -> RRTMGPData:
    return RRTMGPData(_zeros((n, ncol), dtype, device), NCOrder)


def n_data(n: int, dtype=torch.float32, device=None) -> RRTMGPData:
    return RRTMGPData(_zeros((n,), dtype, device), NOrder)


def set_cols(data: RRTMGPData, value) -> RRTMGPData:
    """``data`` filled from ``value``. For 2-D data (v, c): a scalar, (v, c),
    (v,) broadcast over the columns, (1, c) broadcast over the levels, and
    (c,) when v is 1; for 3-D data (n, v, c) with n 1: (v, c); otherwise the
    exact shape."""
    arr = data.array
    value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
    if value.ndim == 0:
        new = value.expand(arr.shape)
    elif arr.ndim == 2:
        if value.shape == arr.shape:
            new = value
        elif arr.shape[0] == 1 and value.shape == (arr.shape[1],):
            new = value[None, :]
        elif value.shape == (arr.shape[0],):
            new = value[:, None].expand(arr.shape)
        elif value.shape == (1, arr.shape[1]):
            new = value.expand(arr.shape)
        else:
            raise ValueError(f"cannot set {tuple(arr.shape)} from {tuple(value.shape)}")
    elif arr.ndim == 3 and arr.shape[0] == 1 and value.ndim == 2:
        new = value[None]
    elif value.shape == arr.shape:
        new = value
    else:
        raise ValueError(f"cannot set {tuple(arr.shape)} from {tuple(value.shape)}")
    return dataclasses.replace(data, array=new.clone())


def domain_view(isothermal_boundary_layer: bool, data):
    """``data`` without the isothermal boundary layer's top layer or level
    when the grid has one: a view of an ``RRTMGPData`` along its order's
    vertical axis (NVC, VC), or of a plain tensor along its leading axis
    (the solver's getters)."""
    if not isothermal_boundary_layer:
        return data
    if isinstance(data, torch.Tensor):
        return data[:-1]
    if data.order is NVCOrder:
        return dataclasses.replace(data, array=data.array[:, :-1, :])
    if data.order is VCOrder:
        return dataclasses.replace(data, array=data.array[:-1, :])
    raise TypeError(f"domain_view undefined for order {data.order.__name__}")


def set_domain(data: RRTMGPData, value, isothermal_boundary_layer: bool) -> RRTMGPData:
    """``data`` with its domain (all but the isothermal boundary layer) set
    from ``value`` as ``set_cols`` sets it; the boundary layer keeps its
    values."""
    if not isothermal_boundary_layer:
        return set_cols(data, value)
    inner = set_cols(domain_view(True, data), value)
    arr = data.array.clone()
    if data.order is NVCOrder:
        arr[:, :-1, :] = inner.array
    else:
        arr[:-1, :] = inner.array
    return dataclasses.replace(data, array=arr)
