"""The port's McICA sampler (rrtmgp_tpu_torch.ops.threefry, ops.cloud_optics)
against the JAX package's off-TPU sampler, bit for bit.

The port reimplements jax.random's threefry2x32 stream (partitionable bits,
the default of the installed jax): ``jax.random.key``, ``fold_in`` and
``uniform``. So ``build_cloud_mask_mcica`` draws the same mask as the JAX
``build_cloud_mask_mcica(jax.random.key(seed), ...)`` for every
``col_offset`` (None: one key over the whole batch; an int: one key per
global column), and the CUDA kernels, which call the same stream
(csrc/mcica.cuh), match both; chip_smoke.py holds them on the card.

The cloud fraction is fractional (two cloudy blocks with a clear gap, as in
tests_tpu/test_tpu_mcica_structure.py): with cf in {0, 1} the mask would
not depend on the draws at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.ops import cloud_optics as jcld
from rrtmgp_tpu_torch.ops import cloud_optics as tcld
from rrtmgp_tpu_torch.ops import mega, threefry

NLAY, NCOL = 30, 24


def _multiblock_cf(nlay, ncol):
    """Two cloudy blocks (layers 20-24 and 8-14) separated by a clear gap,
    cf varying by layer and column."""
    cf = np.zeros((nlay, ncol), np.float32)
    cols = np.linspace(0.3, 0.95, ncol, dtype=np.float32)
    for l in range(20, 25):
        cf[l] = cols * (0.5 + 0.1 * (l - 20))
    for l in range(8, 15):
        cf[l] = np.clip(cols * (1.2 - 0.05 * (l - 8)), 0.0, 0.97)
    return cf


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_primitives_match_jax_random(seed):
    key = jax.random.key(seed)
    words = np.asarray(jax.random.key_data(key), np.uint32)
    assert threefry.seed_key(seed) == tuple(int(w) for w in words)
    cols = np.arange(0, 5000, 997, dtype=np.int64)
    k0, k1 = threefry.fold_in(threefry.seed_key(seed), torch.from_numpy(cols))
    for c, a, b in zip(cols, k0.tolist(), k1.tolist()):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(key, int(c))), np.uint32)
        assert (a, b) == (int(ref[0]), int(ref[1]))
    idx = torch.arange(3 * 37, dtype=torch.int64)
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        ref = np.asarray(jax.random.uniform(key, (3, 37), dtype=jd)).reshape(-1)
        port = threefry.uniform_from_counter(threefry.seed_key(seed), idx, td).numpy()
        assert np.array_equal(port, ref), jd


@pytest.mark.parametrize("n_gpt", [32, 17])
@pytest.mark.parametrize("col_offset", [None, 0, 384])
def test_mask_matches_jax_bitwise(n_gpt, col_offset):
    cf = _multiblock_cf(NLAY, NCOL)
    ref = np.asarray(jcld.build_cloud_mask_mcica(jax.random.key(5), jnp.asarray(cf), n_gpt,
                                                 col_offset=col_offset))
    port = tcld.build_cloud_mask_mcica(torch.from_numpy(cf), n_gpt, 5, col_offset)
    assert port.dtype == torch.bool and port.shape == (NLAY, NCOL, n_gpt)
    assert np.array_equal(port.numpy(), ref)
    # the draws matter: some cells of a fractional layer are clear, some cloudy
    frac = port.numpy()[8:15][:, cf[8:15].max(axis=0) < 0.97]
    assert frac.any() and not frac.all()
    cover = tcld.cloud_cover_from_mask(port)
    np.testing.assert_allclose(cover.numpy(), np.asarray(jcld.cloud_cover_from_mask(jnp.asarray(ref))),
                               rtol=1e-6)
    assert cover.dtype == torch.float32


def test_f64_cloud_fraction_matches_jax_bitwise():
    cf = _multiblock_cf(NLAY, NCOL).astype(np.float64)
    ref = np.asarray(jcld.build_cloud_mask_mcica(jax.random.key(3), jnp.asarray(cf), 16, col_offset=40))
    assert np.array_equal(tcld.build_cloud_mask_mcica(torch.from_numpy(cf), 16, 3, 40).numpy(), ref)


def test_column_split_invariance():
    cf = torch.from_numpy(_multiblock_cf(NLAY, NCOL))
    whole = tcld.build_cloud_mask_mcica(cf, 32, 9, 1000)
    half = NCOL // 2
    left = tcld.build_cloud_mask_mcica(cf[:, :half].contiguous(), 32, 9, 1000)
    right = tcld.build_cloud_mask_mcica(cf[:, half:].contiguous(), 32, 9, 1000 + half)
    assert torch.equal(torch.cat([left, right], dim=1), whole)


def test_export_twin_matches_the_mask_and_the_jax_draws():
    cf = _multiblock_cf(NLAY, NCOL)
    u, m = mega.mcica_mask_export(torch.from_numpy(cf), 11, 384, 32)  # CPU: the twin
    assert u.dtype == m.dtype == torch.float32 and u.shape == (NLAY, NCOL, 32)
    assert torch.equal(m.bool(), tcld.build_cloud_mask_mcica(torch.from_numpy(cf), 32, 11, 384))
    assert torch.equal(u, mega.mcica_mask_export_ref(torch.from_numpy(cf), 11, 384, 32)[0])
    # the raw draws: jax.random.uniform of fold_in(key, column) over (nlay, ngpt)
    key = jax.random.key(11)
    for c in (0, 5, NCOL - 1):
        ref = np.asarray(jax.random.uniform(jax.random.fold_in(key, 384 + c), (NLAY, 32), jnp.float32))
        assert np.array_equal(u[:, c].numpy(), ref)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert mega.mcica_mask_export.launches == 0


def test_cloud_fraction_one_and_zero_are_deterministic():
    cf = np.zeros((6, 4), np.float32)
    cf[2:4] = 1.0
    m = tcld.build_cloud_mask_mcica(torch.from_numpy(cf), 8, 1, 0)
    assert m[2:4].all() and not m[:2].any() and not m[4:].any()
    assert torch.equal(tcld.cloud_cover_from_mask(m), torch.ones(4))
