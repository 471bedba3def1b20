"""The port's data layouts (``rrtmgp_tpu_torch.utils.datalayouts``) after
the JAX package's ``tests/test_datalayouts.py``, and against its functions
on the same inputs (exact: the layouts only move values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrtmgp_tpu_torch as rt
from rrtmgp_tpu.utils import datalayouts as jdl
from rrtmgp_tpu_torch.utils import datalayouts as dl


def test_constructors_and_order_validation():
    assert dl.nvc_data(4, 6, n=3, device="cpu").shape == (3, 4, 6)
    assert dl.vc_data(4, 6, device="cpu").shape == (4, 6)
    assert dl.nc_data(6, n=2, device="cpu").shape == (2, 6)
    assert dl.n_data(5, device="cpu").shape == (5,)
    assert dl.vc_data(4, 6, dtype=torch.float64, device="cpu").dtype == torch.float64
    assert dl.vc_data(4, 6).array.device == rt.convert.default_device()
    with pytest.raises(ValueError):
        dl.RRTMGPData(torch.zeros((2, 3)), dl.NVCOrder)
    with pytest.raises(ValueError):
        dl.RRTMGPData(torch.zeros((2, 3, 4)), dl.VCOrder)


def test_set_cols_scalar_fill():
    for d in (dl.nvc_data(3, 5, n=2, device="cpu"), dl.vc_data(3, 5, device="cpu"),
              dl.nc_data(5, n=2, device="cpu"), dl.n_data(4, device="cpu")):
        out = dl.set_cols(d, 2.5)
        assert out.shape == d.shape and out.order is d.order
        assert torch.all(out.array == 2.5)
        assert torch.all(d.array == 0.0)  # a new wrapper; the old is unchanged


def test_set_cols_vc_broadcasts():
    d = dl.vc_data(3, 5, device="cpu")
    full = torch.arange(15.0).reshape(3, 5)
    assert torch.equal(dl.set_cols(d, full).array, full)
    out = dl.set_cols(d, torch.tensor([1.0, 2.0, 3.0])).array
    assert torch.equal(out, torch.tensor([[1.0], [2.0], [3.0]]).expand(3, 5))
    out = dl.set_cols(d, torch.arange(5.0)[None, :]).array
    assert torch.equal(out, torch.arange(5.0).expand(3, 5))
    with pytest.raises(ValueError):
        dl.set_cols(d, torch.zeros((4, 5)))


def test_set_cols_nc_singleton_vector():
    out = dl.set_cols(dl.nc_data(5, n=1, device="cpu"), torch.arange(5.0)).array
    assert torch.equal(out, torch.arange(5.0)[None, :])


def test_set_cols_nvc_singleton_matrix():
    mat = torch.arange(15.0).reshape(3, 5)
    out = dl.set_cols(dl.nvc_data(3, 5, n=1, device="cpu"), mat).array
    assert torch.equal(out, mat[None])
    with pytest.raises(ValueError):
        dl.set_cols(dl.nvc_data(3, 5, n=2, device="cpu"), mat)


def test_domain_view_strips_extra_top_layer():
    nvc = dl.RRTMGPData(torch.arange(2 * 4 * 3.0).reshape(2, 4, 3), dl.NVCOrder)
    vc = dl.RRTMGPData(torch.arange(12.0).reshape(4, 3), dl.VCOrder)
    assert dl.domain_view(False, nvc) is nvc
    assert dl.domain_view(True, nvc).shape == (2, 3, 3)
    assert dl.domain_view(True, vc).shape == (3, 3)
    assert torch.equal(dl.domain_view(True, vc).array, vc.array[:-1])
    with pytest.raises(TypeError):
        dl.domain_view(True, dl.n_data(4, device="cpu"))
    # one implementation: the API's name is this function
    assert rt.domain_view is dl.domain_view
    assert rt.domain_view(True, torch.zeros(11, 4)).shape == (10, 4)


def test_set_domain_preserves_boundary_layer():
    vc = dl.RRTMGPData(torch.full((4, 3), 9.0), dl.VCOrder)
    out = dl.set_domain(vc, 1.0, isothermal_boundary_layer=True).array
    assert torch.all(out[:-1] == 1.0) and torch.all(out[-1] == 9.0)
    assert torch.all(vc.array == 9.0)
    out = dl.set_domain(vc, 1.0, isothermal_boundary_layer=False).array
    assert torch.all(out == 1.0)
    nvc = dl.RRTMGPData(torch.full((2, 4, 3), 9.0), dl.NVCOrder)
    out = dl.set_domain(nvc, torch.zeros((2, 3, 3)), True).array
    assert torch.all(out[:, :-1, :] == 0.0) and torch.all(out[:, -1, :] == 9.0)


CASES = [
    ("vc", (3, 5), 2.5), ("vc", (3, 5), "full"), ("vc", (3, 5), "lev"), ("vc", (3, 5), "row"),
    ("vc", (1, 5), "cols"), ("nc", (1, 5), "cols"), ("nvc", (1, 3, 5), "mat"), ("nvc", (2, 3, 5), "full"),
    ("n", (4,), "full"), ("n", (4,), -1.0),
]


def _value(kind, shape, rng):
    if not isinstance(kind, str):
        return kind
    v, c = shape[-2] if len(shape) > 1 else 1, shape[-1]
    return {"full": rng.uniform(size=shape), "lev": rng.uniform(size=(v,)), "row": rng.uniform(size=(1, c)),
            "cols": rng.uniform(size=(c,)), "mat": rng.uniform(size=(v, c))}[kind]


@pytest.mark.parametrize("order,shape,kind", CASES)
@pytest.mark.parametrize("ibl", [False, True])
def test_matches_jax_layouts(order, shape, kind, ibl):
    """set_cols, and set_domain / domain_view with and without the
    isothermal boundary layer, equal the JAX package's exactly."""
    rng = np.random.default_rng(len(shape) * 7 + len(str(kind)))
    base = rng.uniform(size=shape)
    jorder, torder = ({"vc": (jdl.VCOrder, dl.VCOrder), "nc": (jdl.NCOrder, dl.NCOrder),
                       "nvc": (jdl.NVCOrder, dl.NVCOrder), "n": (jdl.NOrder, dl.NOrder)}[order])
    jd, td = jdl.RRTMGPData(jnp.asarray(base), jorder), dl.RRTMGPData(torch.from_numpy(base), torder)
    value = _value(kind, shape, rng)
    jv = value if np.isscalar(value) else jnp.asarray(value)
    tv = value if np.isscalar(value) else torch.from_numpy(value)
    np.testing.assert_array_equal(dl.set_cols(td, tv).array.numpy(), np.asarray(jdl.set_cols(jd, jv).array))
    if order in ("vc", "nvc") and shape[-2] > 1:
        np.testing.assert_array_equal(dl.domain_view(ibl, td).array.numpy(),
                                      np.asarray(jdl.domain_view(ibl, jd).array))
        if ibl and kind in ("full", "mat", "lev"):  # values shaped for the domain
            value = value[:-1] if kind == "lev" else value[..., :-1, :]
            jv, tv = jnp.asarray(value), torch.from_numpy(value)
        np.testing.assert_array_equal(dl.set_domain(td, tv, ibl).array.numpy(),
                                      np.asarray(jdl.set_domain(jd, jv, ibl).array))
