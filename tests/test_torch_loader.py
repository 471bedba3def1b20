"""The port's loaders and manifest (rrtmgp_tpu_torch.data.loader, .manifest)
against the JAX package's on the same files.

Files: the JAX tests' writers (tests/test_loader.py: gas LW / SW in normal
and reversed axis order and with the temperature == band size tie, cloud,
aerosol) and the fabricated-checkout writer (scripts/fabricate_rrtmgp_data.py)
with the hard cases real files have and the synthetic lookups lack: a minor
gas missing from gas_names (gas 0), two intervals over one g-point range,
density scaling without a scaling gas over part of a band, the h2o_self
alias, more intervals a side, a band whose upper key species is 0/0.

Tolerances: the lookups bit for bit (every table, its dtype, every metadata
field) in f64 and in f32; the hard-case file against the lookup it was
written from within 1e-12 of each table's largest entry (the pressure grid
is written as exp of its log grid), integer metadata exactly; torch-path
fluxes on the hard-case lookups within 1e-10 of the JAX XLA solve's
largest flux in f64 (tests/test_torch_solve.py's f64 tolerance).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import fabricate_rrtmgp_data as fab  # noqa: E402
import test_loader as tl  # noqa: E402

from rrtmgp_tpu.data import loader as jl  # noqa: E402
from rrtmgp_tpu.data import manifest as jm  # noqa: E402
from rrtmgp_tpu.data import netcdf as jn  # noqa: E402
from rrtmgp_tpu.data import synthetic as jsyn  # noqa: E402
from rrtmgp_tpu.models import rrtmgp as jmod  # noqa: E402
from rrtmgp_tpu.states import LwBCs as JLwBCs, SwBCs as JSwBCs  # noqa: E402
from rrtmgp_tpu_torch import convert, solve_lw, solve_sw  # noqa: E402
from rrtmgp_tpu_torch.data import loader as pl  # noqa: E402
from rrtmgp_tpu_torch.data import manifest as pm  # noqa: E402
from rrtmgp_tpu_torch.data import netcdf as pn  # noqa: E402
from rrtmgp_tpu_torch.data.synthetic import synthetic_gas_lookup  # noqa: E402

DTYPES = [np.float64, np.float32]
KINDS = {
    "gas": (convert.GAS_LOOKUP_ARRAYS, convert.GAS_LOOKUP_META, jl.load_gas_lookup, pl.load_gas_lookup),
    "cloud": (convert.CLOUD_LOOKUP_ARRAYS, convert.CLOUD_LOOKUP_META, jl.load_cloud_lookup, pl.load_cloud_lookup),
    "aerosol": (convert.AEROSOL_LOOKUP_ARRAYS, convert.AEROSOL_LOOKUP_META, jl.load_aerosol_lookup,
                pl.load_aerosol_lookup),
}
HARD_TOL = 1e-12
SOLVE_TOL = 1e-10


def assert_same_lookup(kind, ref, out):
    """Every table bitwise equal, of the same dtype, contiguous (the kernels
    take no other); every metadata field equal."""
    arrays, meta, _, _ = KINDS[kind]
    for k in arrays:
        a, b = getattr(ref, k), getattr(out, k)
        if a is None:
            assert b is None, k
            continue
        assert b.is_contiguous(), k
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (k, np.abs(a.astype(np.float64) - b).max())
    for k in meta:
        assert getattr(ref, k) == getattr(out, k), k


def load_both(kind, path, dtype):
    _, _, jload, pload = KINDS[kind]
    return jload(path, dtype), pload(path, dtype, device="cpu")


GAS_FILES = {  # name -> (longwave, reverse, nbnd, ntemp)
    "lw": (True, False, tl.NBND, tl.NTEMP), "lw_reversed": (True, True, tl.NBND, tl.NTEMP),
    "sw": (False, False, tl.NBND, tl.NTEMP), "sw_reversed": (False, True, tl.NBND, tl.NTEMP),
    "lw_tie": (True, False, 8, 8), "lw_tie_reversed": (True, True, 8, 8),
    "sw_tie": (False, False, 8, 8), "sw_tie_reversed": (False, True, 8, 8),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(GAS_FILES))
def test_gas_lookup_equals_jax(tmp_path, case, dtype):
    longwave, reverse, nbnd, ntemp = GAS_FILES[case]
    path = str(tmp_path / "gas.nc")
    tl._write_gas_nc(path, longwave=longwave, reverse=reverse, nbnd=nbnd, ntemp=ntemp)
    ref, out = load_both("gas", path, dtype)
    assert_same_lookup("gas", ref, out)
    assert out.kmajor.device.type == "cpu"
    if nbnd == ntemp and longwave:
        assert out.totplnk.shape == (tl.NPLNK, nbnd)  # oriented by name, not by size


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["cloud", "aerosol"])
def test_cloud_aerosol_lookup_equals_jax(tmp_path, kind, dtype):
    path = str(tmp_path / f"{kind}.nc")
    (tl._write_cloud_nc if kind == "cloud" else tl._write_aerosol_nc)(path)
    ref, out = load_both(kind, path, dtype)
    assert_same_lookup(kind, ref, out)


@pytest.mark.parametrize("reverse", [False, True], ids=["file_order", "reversed"])
def test_colliding_dim_sizes(tmp_path, reverse):
    """tests/test_loader.py::test_load_colliding_dim_sizes on the port:
    nbnd == ntemp (the g224 hazard: temperature == nbnd_sw == 14); size
    matching alone cannot orient totplnk / eta tables, names must resolve
    it, in either on-disk axis order."""
    nb = nt = 8
    pc, px = str(tmp_path / "c.nc"), str(tmp_path / "x.nc")
    tl._write_gas_nc(pc, longwave=True, nbnd=nb, ntemp=nt)
    tl._write_gas_nc(px, longwave=True, reverse=reverse, nbnd=nb, ntemp=nt)
    a = pl.load_gas_lookup(pc, device="cpu")
    b = pl.load_gas_lookup(px, device="cpu")
    assert_same_lookup("gas", a, b)
    assert a.n_bnd == nb and a.n_temp == nt
    assert a.totplnk.shape == (tl.NPLNK, nb)


# ---------------------------------------------------------------------------
# The hard cases: fabricated files written from a lookup in memory
# ---------------------------------------------------------------------------

HARD = dict(n_gpt=48, n_bnd=6, n_press=20, n_temp=6, n_t_plnk=30)


def _hard_spec(longwave):
    lkp = synthetic_gas_lookup(longwave=longwave, seed=0 if longwave else 1, device="cpu", **HARD)
    return fab.with_hard_cases(*fab.lookup_numpy(lkp, fab.GAS_ARRAYS, fab.GAS_META))


@pytest.fixture(scope="module")
def hard_files(tmp_path_factory):
    """name -> (path, expected arrays, expected metadata)."""
    root = tmp_path_factory.mktemp("hard")
    out = {}
    for longwave in (True, False):
        arrays, meta, names = _hard_spec(longwave)
        for reverse in (False, True):
            name = f"{'lw' if longwave else 'sw'}{'_reversed' if reverse else ''}"
            path = str(root / f"{name}.nc")
            rev = ("kmajor", "kminor_lower", "plank_fraction", "totplnk", "rayl_upper", "key_species",
                   "vmr_ref", "minor_limits_gpt_upper") if reverse else ()
            fab.write_gas_file(path, arrays, meta, names, reverse=rev)
            out[name] = (path, arrays, meta)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["lw", "lw_reversed", "sw", "sw_reversed"])
def test_hard_cases_equal_jax(hard_files, name, dtype):
    path, _, _ = hard_files[name]
    ref, out = load_both("gas", path, dtype)
    assert_same_lookup("gas", ref, out)


@pytest.mark.parametrize("name", ["lw", "lw_reversed", "sw", "sw_reversed"])
def test_hard_cases_round_trip(hard_files, name):
    """The loaded lookup is the one written: tables within 1e-12 of their
    largest entry, integer metadata exact, the hard cases where expected."""
    path, arrays, meta = hard_files[name]
    out = pl.load_gas_lookup(path, device="cpu")
    for k, a in arrays.items():
        if a is None:
            assert getattr(out, k) is None, k
            continue
        b = getattr(out, k).numpy()
        assert np.abs(b - a).max() <= HARD_TOL * np.abs(a).max(), k
    for k, v in meta.items():
        if isinstance(v, float):
            assert abs(getattr(out, k) - v) <= HARD_TOL * max(abs(v), 1.0), k
        else:
            assert getattr(out, k) == v, k
    gas_names = list(out.gas_names)
    for side in ("lower", "upper"):
        itv = getattr(out, f"minor_{side}")
        assert len(itv) == 7  # the synthetic lookup's 3 + 4 hard cases
        assert itv[3].gas == 0 and "cfc11" not in gas_names  # missing gas
        assert (itv[4].gpt0, itv[4].gpt1) == (itv[0].gpt0, itv[0].gpt1)  # shared range
        assert itv[5].scaling_gas == 0 and itv[5].scales_with_density  # no scaling gas
        assert itv[6].gas == out.idx_h2o  # h2o_self alias
    assert (2, 2) in [pair[1] for pair in out.key_species]  # written 0/0
    assert pm.validate_structure(pn.Dataset(path), "gas_lw" if name.startswith("lw") else "gas_sw") == []


def test_hard_cases_solve_matches_jax(hard_files):
    """Torch-path solves on the hard-case lookups against the JAX XLA solves
    on the JAX loader's lookups of the same files (f64, 1e-10)."""
    ncol, nlay = 16, 8
    ja = jsyn.synthetic_atmosphere(ncol=ncol, nlay=nlay, dtype=np.float64)
    ta = convert.atmosphere_from_object(ja, device="cpu")
    for name in ("lw", "sw"):
        path = hard_files[name][0]
        jlk, plk = jl.load_gas_lookup(path), pl.load_gas_lookup(path, device="cpu")
        rng = np.random.default_rng(3)
        if name == "lw":
            emis = rng.uniform(0.9, 1.0, (plk.n_bnd, ncol))
            ref, _ = jax.jit(lambda a, b: jmod.solve_lw(jlk, a, b))(ja, JLwBCs(sfc_emis=jnp.asarray(emis)))
            out, _ = solve_lw(plk, ta, convert.lw_bcs_from_numpy(sfc_emis=emis, device="cpu"), impl="torch")
        else:
            bc = dict(cos_zenith=rng.uniform(0.05, 1.0, ncol), toa_flux=np.full(ncol, 1361.0),
                      sfc_alb_direct=rng.uniform(0.05, 0.4, (plk.n_bnd, ncol)),
                      sfc_alb_diffuse=rng.uniform(0.05, 0.4, (plk.n_bnd, ncol)))
            ref, _ = jax.jit(lambda a, b: jmod.solve_sw(jlk, a, b))(ja, JSwBCs(**{k: jnp.asarray(v) for k, v in bc.items()}))
            out, _ = solve_sw(plk, ta, convert.sw_bcs_from_numpy(**bc, device="cpu"), impl="torch")
        for field in ("flux_up", "flux_dn"):
            r, o = np.asarray(getattr(ref, field)), getattr(out, field).numpy()
            assert np.all(np.isfinite(o))
            assert np.abs(o - r).max() <= SOLVE_TOL * np.abs(r).max(), (name, field)


# ---------------------------------------------------------------------------
# Manifest: the port accepts and rejects exactly what the JAX manifest does
# ---------------------------------------------------------------------------


def _drop(name):
    def f(ds):
        del ds._vars[name]
    return f


def _rename_dim(name, dims):
    def f(ds):
        ds.var_dims[name] = dims
    return f


def _set(name, value):
    def f(ds):
        ds._vars[name] = np.asarray(value)
    return f


def _set_dim(name, value):
    def f(ds):
        ds.dims[name] = value
    return f


MUTATIONS = {  # the band set's own table: totplnk in LW, rayl_lower in SW
    "valid": lambda ds: None,
    "missing_kmajor": _drop("kmajor"),
    "missing_own_table": lambda ds: _drop("totplnk" if "totplnk" in ds else "rayl_lower")(ds),
    "misnamed_own_table": lambda ds: _rename_dim(*(("totplnk", ("bogus_dim", "bnd")) if "totplnk" in ds else
                                                   ("rayl_lower", ("gpt", "bogus_dim", "mixing_fraction"))))(ds),
    "pressure_interp": _set_dim("pressure_interp", tl.NPRESS + 3),
    "band_limits_short": _set("bnd_limits_gpt", [[1, 16], [17, 30]]),
    "kminor_overflow": _set("kminor_start_lower", [1, 30]),
}


@pytest.mark.parametrize("longwave", [True, False], ids=["lw", "sw"])
@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_manifest_structure_as_jax(tmp_path, longwave, mutation):
    path = str(tmp_path / "gas.nc")
    tl._write_gas_nc(path, longwave=longwave)
    kind = "gas_lw" if longwave else "gas_sw"
    jds, pds = jn.Dataset(path), pn.Dataset(path)
    for ds in (jds, pds):
        MUTATIONS[mutation](ds)
    want = jm.validate_structure(jds, kind)
    assert pm.validate_structure(pds, kind) == want
    assert bool(want) == (mutation != "valid")


def test_manifest_lookup_kinds_as_jax(tmp_path):
    """Cloud and aerosol files, and a gas file validated as the wrong kind."""
    cp, ap, gp = str(tmp_path / "c.nc"), str(tmp_path / "a.nc"), str(tmp_path / "g.nc")
    tl._write_cloud_nc(cp)
    tl._write_aerosol_nc(ap)
    tl._write_gas_nc(gp, longwave=False)
    for path, kind in ((cp, "cloud"), (ap, "aerosol"), (gp, "gas_lw"), (cp, "aerosol")):
        assert pm.validate_structure(pn.Dataset(path), kind) == jm.validate_structure(jn.Dataset(path), kind)
    assert pm.validate_structure(pn.Dataset(gp), "gas_lw") != []


def test_manifest_data_dir_as_jax(tmp_path):
    """Empty checkout: every file reported missing, no raise; a synthetic-size
    gas file passes relaxed mode; strict v1.9 mode raises the same
    ManifestError message."""
    root = str(tmp_path)
    assert pm.validate_rrtmgp_data(root, strict_v19=False) == jm.validate_rrtmgp_data(root, strict_v19=False)
    assert all(p == ["file not present"] for p in pm.validate_rrtmgp_data(root, strict_v19=False).values())
    tl._write_gas_nc(str(tmp_path / "rrtmgp-gas-lw-g256.nc"), longwave=True)
    report = pm.validate_rrtmgp_data(root, strict_v19=False)
    assert report == jm.validate_rrtmgp_data(root, strict_v19=False)
    assert report["rrtmgp-gas-lw-g256.nc"] == []
    with pytest.raises(jm.ManifestError) as jerr:
        jm.validate_rrtmgp_data(root, strict_v19=True)
    with pytest.raises(pm.ManifestError) as perr:
        pm.validate_rrtmgp_data(root, strict_v19=True)
    assert str(perr.value) == str(jerr.value)
    assert issubclass(pm.ManifestError, ValueError)
    assert pm.V19_GAS_DIMS == jm.V19_GAS_DIMS and pm.V19_FILES == jm.V19_FILES


def test_full_width_checkout_validates_strict(tmp_path):
    """The fabricated checkout at the v1.9 sizes (LW 256 / SW 224 g-points,
    the cloud and aerosol files) passes the strict v1.9 validation."""
    from rrtmgp_tpu_torch.data.synthetic import synthetic_aerosol_lookup, synthetic_cloud_lookup

    specs = {}
    for key, lw, n, b, seed in (("gas_lw", True, 256, 16, 0), ("gas_sw", False, 224, 14, 1)):
        lkp = synthetic_gas_lookup(longwave=lw, n_gpt=n, n_bnd=b, seed=seed, device="cpu")
        specs[key] = fab.with_hard_cases(*fab.lookup_numpy(lkp, fab.GAS_ARRAYS, fab.GAS_META))
    for key, b, seed in (("cloud_lw", 16, 3), ("cloud_sw", 14, 5)):
        specs[key] = fab.lookup_numpy(synthetic_cloud_lookup(n_bnd=b, seed=seed, device="cpu"),
                                      fab.CLOUD_ARRAYS, fab.CLOUD_META)
    for key, b, seed in (("aerosol_lw", 16, 4), ("aerosol_sw", 14, 6)):
        arrays, meta = fab.lookup_numpy(synthetic_aerosol_lookup(n_bnd=b, seed=seed, device="cpu"),
                                        fab.AEROSOL_ARRAYS, fab.AEROSOL_META)
        specs[key] = ({**arrays, "bnd_lims_wn": fab.aerosol_band_limits(b)}, meta)
    fab.write_checkout(str(tmp_path), specs, reverse=("kmajor", "extice", "aero_salt_tbl"))
    assert pm.validate_rrtmgp_data(str(tmp_path)) == {f: [] for f in pm.V19_FILES.values()}
    aero = pl.load_aerosol_lookup(str(tmp_path / fab.FILES["aerosol_sw"]), device="cpu")
    assert aero.iband_550nm == specs["aerosol_sw"][1]["iband_550nm"] == 1
