"""Cloud band optics: the CUDA kernel and its plain torch twin.

``cloud_bands`` returns the cloud (tau, ssa, g) of every band, each
(nlay, ncol, nbnd) f32 and contiguous, delta-scaled when asked (the SW): the
layout the megakernels read. On CUDA tensors it launches
``csrc/cloud_bands.cu``, one launch a call, which stages the liquid table
and the chosen roughness of the ice table in each block's shared memory; on
CPU tensors it returns ``cloud_bands_ref``, ``cloud_optics_bands`` then
``delta_scale``. The kernel equals the twin on the card bit for bit.
``cloud_bands.launches`` counts the kernel's launches.

The kernel replaces no TPU kernel: the JAX package computes cloud optics in
XLA. The radius bounds stay 0-dim tensors on the card, read by the kernel,
so a call reads nothing back to the host.
"""

from __future__ import annotations

import ctypes

import torch

from ..data.lookups import CloudLookup
from ..states import CloudState
from . import _build
from ._launch import cuda_device, ptr, require, smem_limit, stream
from .cloud_optics import cloud_optics_bands, delta_scale

FIELDS = ("cld_r_eff_liq", "cld_r_eff_ice", "cld_path_liq", "cld_path_ice")
BOUNDS = ("radliq_lwr", "radliq_upr", "radice_lwr", "radice_upr")


def cloud_bands_ref(lkp: CloudLookup, cs: CloudState, delta_scaling: bool):
    """Plain twin of ``cloud_bands``."""
    bands = cloud_optics_bands(lkp, cs)
    if delta_scaling:
        bands = delta_scale(*bands)
    return tuple(x.contiguous() for x in bands)


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A (nlay, ncol) field whose columns are adjacent (a column slice of a
    state is), and the elements between its rows."""
    if x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def cloud_bands(lkp: CloudLookup, cs: CloudState, delta_scaling: bool):
    """Cloud (tau, ssa, g) of every band, each (nlay, ncol, nbnd),
    delta-scaled with ``delta_scaling``."""
    r_liq = cs.cld_r_eff_liq
    if r_liq.device.type == "cpu":
        return cloud_bands_ref(lkp, cs, delta_scaling)
    dev = cuda_device(r_liq, "cloud_bands")
    f32 = torch.float32
    if r_liq.dim() != 2:
        raise ValueError(f"cloud_bands: cld_r_eff_liq {tuple(r_liq.shape)}, expected (nlay, ncol)")
    nlay, ncol = r_liq.shape
    nbnd, nsize_liq, nsize_ice, nrgh = lkp.liq.shape[-1], lkp.nsize_liq, lkp.nsize_ice, lkp.nrghice
    if min(nsize_liq, nsize_ice) < 2:
        raise ValueError(f"cloud_bands: {nsize_liq} liquid and {nsize_ice} ice radii, the interpolation needs 2")
    rgh = cs.ice_rgh - 1
    if not -nrgh <= rgh < nrgh:
        raise IndexError(f"cloud_bands: ice_rgh {cs.ice_rgh}, the ice table has {nrgh} roughnesses")
    fields = []
    for name in FIELDS:
        x = getattr(cs, name)
        if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != f32 or tuple(x.shape) != (nlay, ncol):
            raise ValueError(f"cloud_bands: {name} must be a ({nlay}, {ncol}) float32 tensor on {dev}")
        fields.append(_rows(x))
    require(lkp.liq, "liq", (3, nsize_liq, nbnd), f32, dev)
    require(lkp.ice, "ice", (3, nsize_ice, nbnd, nrgh), f32, dev)
    for name in BOUNDS:
        require(getattr(lkp, name), name, (), f32, dev)
    staged = _build.library().rrtmgp_cloud_bands_smem(nbnd, nsize_liq, nsize_ice)
    if staged > smem_limit(dev):
        raise ValueError(f"cloud_bands: the tables ({nsize_liq} liquid and {nsize_ice} ice radii, {nbnd} bands) "
                         f"take {staged} bytes of shared memory, more than a block of {dev} may have "
                         f"({smem_limit(dev)})")
    out = [torch.empty((nlay, ncol, nbnd), dtype=f32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_cloud_bands(
            ptr(lkp.liq), ptr(lkp.ice), *(ptr(getattr(lkp, k)) for k in BOUNDS),
            *(ptr(x) for x, _ in fields), *map(ptr, out), *(ctypes.c_longlong(ld) for _, ld in fields),
            nlay, ncol, nbnd, nsize_liq, nsize_ice, nrgh, rgh % nrgh, int(bool(delta_scaling)), stream(dev),
        )
    _build.check(err, "cloud_bands", *out)
    cloud_bands.launches += 1
    return tuple(out)


cloud_bands.launches = 0
