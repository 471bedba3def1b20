"""Minimal NetCDF reader (counterpart of ``rrtmgp_tpu/data/netcdf.py``).

rrtmgp-data v1.9 ships NetCDF4 (= HDF5) files; classic NetCDF3 files occur
too (and are what scipy writes). The reader is chosen by the file's
signature, never by catching a failed attempt: ``CDF\\x01`` / ``CDF\\x02``
is NetCDF3, read with ``scipy.io.netcdf_file``; ``\\x89HDF`` is NetCDF4 /
HDF5, read with h5py, which is imported only there. An HDF5 file on a
machine without h5py raises ``ImportError`` naming h5py and the file; a
NetCDF3 file never needs h5py. Mirrors only what the loaders need: named
dimensions, variables as numpy arrays, each variable's dimension names and
attributes, and char-matrix -> string lists.
"""

from __future__ import annotations

import os

import numpy as np

#: leading bytes of a NetCDF3 (classic, 64-bit offset) and a NetCDF4 / HDF5 file
NETCDF3_SIGNATURES = (b"CDF\x01", b"CDF\x02")
HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def file_format(path: str) -> str:
    """``"netcdf3"`` or ``"hdf5"`` by the file's first bytes; raises
    ``FileNotFoundError`` for a missing file and ``ValueError`` for any other
    signature."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such NetCDF file: {path}")
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] in NETCDF3_SIGNATURES:
        return "netcdf3"
    if head == HDF5_SIGNATURE:
        return "hdf5"
    raise ValueError(f"{path}: not a NetCDF3 or NetCDF4/HDF5 file (starts with {head!r})")


class Dataset:
    """Read-only mapping view of a NetCDF file: ``ds.dims``, ``ds[varname]``."""

    def __init__(self, path: str):
        self.path = path
        self._vars: dict[str, np.ndarray] = {}
        self.dims: dict[str, int] = {}
        #: per-variable dimension NAMES in on-disk (C/row-major) axis order;
        #: () when the file carries no dimension metadata for a variable.
        #: The loaders permute by these names, falling back to size matching
        #: only when names are absent.
        self.var_dims: dict[str, tuple[str, ...]] = {}
        #: per-variable attributes (``units`` among them), values as stored
        self.var_attrs: dict[str, dict] = {}
        if file_format(path) == "hdf5":
            self._load_hdf5(path)
        else:
            self._load_netcdf3(path)

    def _load_hdf5(self, path: str) -> None:
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"{path} is a NetCDF4/HDF5 file, which needs h5py, and h5py is not "
                "installed; install h5py or convert the file to NetCDF3"
            ) from e

        with h5py.File(path, "r") as f:
            phony = {}

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    self._vars[name] = obj[()]
                    self.var_attrs[name] = dict(obj.attrs)
                    # NetCDF4 stores dimension scales; collect named dims
                    dim_names = []
                    for i, dim in enumerate(obj.dims):
                        names_i = [scale.name.lstrip("/") for scale in dim.values()]
                        for n in names_i:
                            phony[n] = obj.shape[i]
                        dim_names.append(names_i[0] if names_i else "")
                    if any(dim_names):
                        self.var_dims[name] = tuple(dim_names)

            f.visititems(visit)
            # netCDF4 dimensions appear as datasets with CLASS=DIMENSION_SCALE
            for name, arr in list(self._vars.items()):
                self.dims.setdefault(name, arr.shape[0] if arr.ndim else 1)
            self.dims.update(phony)

    def _load_netcdf3(self, path: str) -> None:
        from scipy.io import netcdf_file

        with netcdf_file(path, "r", mmap=False) as f:
            self.dims = {k: (v if v is not None else 0) for k, v in f.dimensions.items()}
            for name, var in f.variables.items():
                self._vars[name] = np.array(var[()])
                self.var_dims[name] = tuple(var.dimensions)
                self.var_attrs[name] = dict(var._attributes)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._vars[name]

    def __contains__(self, name: str) -> bool:
        return name in self._vars

    def keys(self):
        return self._vars.keys()


def char_to_strings(arr: np.ndarray) -> list[str]:
    """Decode a NetCDF (n, strlen) char matrix into stripped python strings."""
    if arr.dtype.kind in ("S", "U") and arr.ndim == 2:
        return ["".join(c.decode() if isinstance(c, bytes) else c for c in row).strip() for row in arr]
    if arr.dtype.kind in ("S", "U") and arr.ndim == 1:
        return [(s.decode() if isinstance(s, bytes) else s).strip() for s in arr]
    raise ValueError(f"cannot decode strings from array of dtype {arr.dtype}, ndim {arr.ndim}")
