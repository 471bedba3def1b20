"""MERRA aerosol band sums: the CUDA kernel and its plain torch twin
(counterpart of ``rrtmgp_tpu/ops/pallas_aerosol.py``).

``aerosol_bands`` returns the raw sums (tau, tau*ssa, tau*ssa*g), each
(nlay, nbnd, ncol) f32, the layout the megakernels read. On CUDA tensors it
launches ``csrc/aerosol_bands.cu``, which stages the tables in each block's
shared memory (``staged_bytes``; the wrapper refuses tables that do not fit
a block); on CPU tensors it returns ``aerosol_bands_ref``, the port's
``aerosol_optics_bands`` in that layout. ``aerosol_bands.launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..data.lookups import AerosolLookup
from ..states import AerosolState
from . import _build
from ._launch import cuda_device, ptr, require, smem_limit, stream
from .aerosol_optics import N_SPECIES, aerosol_optics_bands

TABLES = (
    "size_bin_limits", "rh_levels", "dust", "sea_salt", "sulfate", "black_carbon_rh",
    "black_carbon", "organic_carbon_rh", "organic_carbon",
)


def record_stride(nbnd: int) -> int:
    """Words between two staged records of nbnd (ext, ssa, asy) triples:
    3 nbnd made odd, so that the distinct records a warp reads fall in
    distinct shared-memory banks."""
    return 3 * nbnd | 1


def staged_bytes(nbnd: int, nbin: int, nrh: int) -> int:
    """Shared memory of one aerosol_bands block (csrc/aerosol_bands.cu
    ``AeroLayout``; ``rrtmgp_aerosol_bands_smem`` on the card): the bin
    limits and RH levels, then records of dust (one per bin), sea salt (per
    RH level and bin), sulfate, BC-RH and OC-RH (per RH level), BC and OC
    (one each), ``record_stride(nbnd)`` words apart, as f32."""
    records = nbin + nrh * nbin + 3 * nrh + 2
    return 4 * (2 * nbin + nrh + records * record_stride(nbnd))


def aerosol_bands_design(lkp: AerosolLookup, device: torch.device) -> dict:
    """How ``aerosol_bands`` launches for these tables on ``device`` (the
    card): the staged bytes of a block, the blocks that fit an SM at once
    with them (256 threads each) and the SMs; a launch's grid is their
    product, or fewer blocks when the rows need fewer."""
    nbnd, nbin, nrh = lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0]
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(_build.library().rrtmgp_aerosol_bands_blocks(nbnd, nbin, nrh, ctypes.byref(per_sm)),
                     "aerosol_bands occupancy")
    return dict(staged=staged_bytes(nbnd, nbin, nrh), blocks_per_sm=per_sm.value, threads=256,
                sms=torch.cuda.get_device_properties(device).multi_processor_count)


def aerosol_bands_ref(lkp: AerosolLookup, aero: AerosolState, rel_hum: torch.Tensor,
                      active_species: tuple | None = None):
    """Plain twin of ``aerosol_bands``."""
    out = aerosol_optics_bands(lkp, aero, rel_hum, active_species)
    return tuple(x.transpose(1, 2).contiguous() for x in out)


def species_mask(active_species: tuple | None) -> int:
    """The active MERRA species as a 15-bit mask (all when None)."""
    if active_species is None:
        return (1 << N_SPECIES) - 1
    bits = 0
    for i in active_species:
        if not 0 <= int(i) < N_SPECIES:
            raise ValueError(f"aerosol species index {i} not in 0..{N_SPECIES - 1}")
        bits |= 1 << int(i)
    return bits


def aerosol_bands(lkp: AerosolLookup, aero: AerosolState, rel_hum: torch.Tensor,
                  active_species: tuple | None = None):
    """Raw aerosol band sums (tau, tau*ssa, tau*ssa*g), each (nlay, nbnd,
    ncol), over ``active_species`` (MERRA indices; all 15 when None)."""
    if rel_hum.device.type == "cpu":
        return aerosol_bands_ref(lkp, aero, rel_hum, active_species)
    dev = cuda_device(rel_hum, "aerosol_bands")
    f32 = torch.float32
    if rel_hum.dim() != 2:
        raise ValueError(f"aerosol_bands: rel_hum {tuple(rel_hum.shape)}, expected (nlay, ncol)")
    nlay, ncol = rel_hum.shape
    nbnd, nbin, nrh = lkp.dust.shape[-1], lkp.size_bin_limits.shape[1], lkp.rh_levels.shape[0]
    if nrh < 2:
        raise ValueError(f"aerosol_bands: {nrh} RH levels, the interpolation needs 2")
    require(rel_hum, "rel_hum", (nlay, ncol), f32, dev)
    require(aero.aero_mass, "aero_mass", (N_SPECIES, nlay, ncol), f32, dev)
    require(aero.aero_size, "aero_size", (N_SPECIES, nlay, ncol), f32, dev)
    for name, shape in zip(TABLES, (
        (2, nbin), (nrh,), (3, nbin, nbnd), (3, nrh, nbin, nbnd), (3, nrh, nbnd), (3, nrh, nbnd),
        (3, nbnd), (3, nrh, nbnd), (3, nbnd),
    )):
        require(getattr(lkp, name), name, shape, f32, dev)
    staged = staged_bytes(nbnd, nbin, nrh)
    if staged > smem_limit(dev):
        raise ValueError(f"aerosol_bands: the tables ({nbin} size bins, {nrh} RH levels, {nbnd} bands) take "
                         f"{staged} bytes of shared memory, more than a block of {dev} may have "
                         f"({smem_limit(dev)})")
    out = [torch.empty((nlay, nbnd, ncol), dtype=f32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        err = _build.library().rrtmgp_aerosol_bands(
            *(ptr(getattr(lkp, k)) for k in TABLES),
            *map(ptr, (aero.aero_mass, aero.aero_size, rel_hum, *out)),
            nlay, ncol, nbnd, nbin, nrh, species_mask(active_species), stream(dev),
        )
    _build.check(err, "aerosol_bands", *out)
    aerosol_bands.launches += 1
    return tuple(out)


aerosol_bands.launches = 0
