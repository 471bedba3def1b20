"""The port's NetCDF reader (rrtmgp_tpu_torch.data.netcdf): the reader is
chosen by the file's signature, NetCDF3 never needs h5py, an HDF5 file
without h5py raises ImportError naming h5py, and with h5py a NetCDF4-style
HDF5 file reads as the JAX package's Dataset reads it."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from rrtmgp_tpu.data import netcdf as jn
from rrtmgp_tpu_torch.data import netcdf as pn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_netcdf3(path):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w")
    f.createDimension("x", 3)
    f.createDimension("y", 2)
    v = f.createVariable("a", "d", ("x", "y"))
    v[:] = np.arange(6.0).reshape(3, 2)
    v.units = "1e-06"
    f.close()


def _write_hdf5(path):
    """A NetCDF4-style HDF5 file: dimension scales attached to the variables'
    axes, as netCDF4 writes them."""
    import h5py

    with h5py.File(path, "w") as f:
        f["x"] = np.arange(3.0)
        f["y"] = np.arange(2.0)
        f["x"].make_scale("x")
        f["y"].make_scale("y")
        f["a"] = np.arange(6.0).reshape(3, 2)
        f["a"].dims[0].attach_scale(f["x"])
        f["a"].dims[1].attach_scale(f["y"])
        f["a"].attrs["units"] = "1e-06"
        f["b"] = np.arange(4.0).reshape(2, 2)


def test_format_by_signature(tmp_path):
    n3, h5, bad = str(tmp_path / "a.nc"), str(tmp_path / "b.nc"), str(tmp_path / "c.nc")
    _write_netcdf3(n3)
    with open(h5, "wb") as f:
        f.write(pn.HDF5_SIGNATURE + b"\0" * 64)
    with open(bad, "wb") as f:
        f.write(b"not a netcdf file")
    assert pn.file_format(n3) == "netcdf3"
    assert pn.file_format(h5) == "hdf5"
    with pytest.raises(ValueError, match="not a NetCDF3"):
        pn.Dataset(bad)


def test_missing_file_raises_file_not_found(tmp_path):
    path = str(tmp_path / "nowhere.nc")
    with pytest.raises(FileNotFoundError, match="nowhere.nc"):
        pn.Dataset(path)


def test_netcdf3_reads_as_jax(tmp_path):
    path = str(tmp_path / "a.nc")
    _write_netcdf3(path)
    ds, ref = pn.Dataset(path), jn.Dataset(path)
    assert ds.dims == ref.dims and ds.var_dims == ref.var_dims
    assert set(ds.keys()) == set(ref.keys())
    np.testing.assert_array_equal(ds["a"], ref["a"])
    assert ds.var_attrs["a"]["units"] in (b"1e-06", "1e-06")


def test_hdf5_reads_as_jax(tmp_path):
    pytest.importorskip("h5py")
    path = str(tmp_path / "a.h5")
    _write_hdf5(path)
    ds, ref = pn.Dataset(path), jn.Dataset(path)
    assert ds.dims == ref.dims
    assert ds.var_dims == ref.var_dims and ds.var_dims["a"] == ("x", "y")
    assert set(ds.keys()) == set(ref.keys())
    for k in ref.keys():
        np.testing.assert_array_equal(ds[k], ref[k])
    assert ds.var_attrs["a"]["units"] == "1e-06"


def test_without_h5py(tmp_path):
    """With h5py blocked: the package imports, a NetCDF3 file reads, an HDF5
    file raises ImportError naming h5py and the file (no fallback)."""
    n3, h5 = str(tmp_path / "a.nc"), str(tmp_path / "b.h5")
    _write_netcdf3(n3)
    with open(h5, "wb") as f:
        f.write(pn.HDF5_SIGNATURE + b"\0" * 64)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["h5py"] = None  # import h5py raises ImportError
        sys.path.insert(0, {ROOT!r})
        import rrtmgp_tpu_torch
        from rrtmgp_tpu_torch.data.netcdf import Dataset
        assert Dataset({n3!r})["a"].shape == (3, 2)
        try:
            Dataset({h5!r})
        except ImportError as e:
            assert "h5py" in str(e) and {h5!r} in str(e), str(e)
            print("OK")
    """)
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", (proc.stdout, proc.stderr[-2000:])


def test_char_to_strings_as_jax():
    arr = np.array([list("h2o  "), list("co2  ")], dtype="S1")
    assert pn.char_to_strings(arr) == jn.char_to_strings(arr) == ["h2o", "co2"]
    one = np.array([b"o3 ", b"n2o"])
    assert pn.char_to_strings(one) == jn.char_to_strings(one) == ["o3", "n2o"]
    with pytest.raises(ValueError):
        pn.char_to_strings(np.zeros(3))
