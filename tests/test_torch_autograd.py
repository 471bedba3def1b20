"""Gradients through the port's plain RTE (``rrtmgp_tpu_torch.ops.rte``).

The recurrences of ``lw_noscat``, ``lw_2stream``, ``sw_2stream`` (with its
adding) and the cumulative sum of ``sw_noscat`` keep each level in its own
tensor and stack the levels at the end, so autograd passes through them.
Each solve is held by ``torch.autograd.gradcheck`` in f64 at 3 layers x 2
columns x 4 g-points (every floating input differentiable), and its
gradient of a weighted sum of the fluxes against ``jax.vjp`` of the JAX
package's function on the same numpy inputs (f64, 1e-10 of the largest
gradient entry).

Inputs stay away from the kinks of the solves (the Clough series threshold,
the energy clamps of the SW coefficients, the Meador-Weaver pole k mu0 = 1),
where a one-sided derivative and a finite difference disagree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrtmgp_tpu.ops import rte as jrte
from rrtmgp_tpu_torch.ops import rte

NLAY, NCOL, NGPT = 3, 2, 4
B = (NCOL, NGPT)


def _inputs(solve):
    """Numpy f64 arguments of ``solve`` (None for an absent incident flux)."""
    rng = np.random.default_rng(7)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape)
    tau = u(0.05, 1.5, NLAY, *B)
    if solve == "lw_noscat":
        return (tau, u(0.5, 1.5, NLAY, *B), u(0.5, 1.5, NLAY + 1, *B), u(0.5, 1.5, *B), u(0.8, 1.0, *B),
                1.66, 0.5, u(0.0, 0.3, *B))
    if solve == "lw_2stream":
        return (tau, u(0.1, 0.8, NLAY, *B), u(0.1, 0.7, NLAY, *B), u(0.5, 1.5, NLAY + 1, *B), u(0.5, 1.5, *B),
                u(0.8, 1.0, *B), u(0.0, 0.3, *B))
    mu0 = u(0.3, 0.9, NCOL, 1)
    if solve == "sw_noscat":
        return tau, mu0, u(100.0, 1400.0, *B)
    return (tau, u(0.1, 0.8, NLAY, *B), u(0.1, 0.7, NLAY, *B), mu0, u(100.0, 1400.0, *B), u(0.05, 0.4, *B),
            u(0.05, 0.4, *B), u(0.0, 5.0, *B))


def _torch_args(args):
    return tuple(torch.tensor(a, dtype=torch.float64, requires_grad=True) if isinstance(a, np.ndarray) else a
                 for a in args)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


SOLVES = ("lw_noscat", "lw_2stream", "sw_noscat", "sw_2stream")


@pytest.mark.parametrize("solve", SOLVES)
def test_gradcheck_f64(solve):
    """Analytic gradients of every flux with respect to every floating input
    equal finite differences (torch.autograd.gradcheck, f64 defaults)."""
    args = _torch_args(_inputs(solve))
    tensors = [a for a in args if isinstance(a, torch.Tensor)]

    def fn(*ts):
        it = iter(ts)
        full = tuple(next(it) if isinstance(a, torch.Tensor) else a for a in args)
        return _as_tuple(getattr(rte, solve)(*full))

    assert torch.autograd.gradcheck(fn, tensors)


@pytest.mark.parametrize("solve", SOLVES)
def test_backward_matches_jax_vjp(solve):
    """loss.backward() of a weighted sum of the fluxes against jax.vjp of the
    JAX package's function, same numpy inputs, f64: 1e-10 of the largest
    gradient entry of each input. The forward fluxes agree as well."""
    args = _inputs(solve)
    targs = _torch_args(args)
    out = _as_tuple(getattr(rte, solve)(*targs))
    weights = [np.random.default_rng(i).uniform(-1.0, 1.0, tuple(o.shape)) for i, o in enumerate(out)]
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, weights))
    loss.backward()

    idx = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def jfn(*arrays):
        full = list(args)
        for i, a in zip(idx, arrays):
            full[i] = a
        return _as_tuple(getattr(jrte, solve)(*full))

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(args[i]) for i in idx))
    grads = vjp(tuple(jnp.asarray(w) for w in weights))
    for o, jo in zip(out, jout):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-12, atol=1e-12 * np.abs(jo).max())
    for i, g in zip(idx, grads):
        port = targs[i].grad.numpy()
        ref = np.asarray(g)
        scale = np.abs(ref).max()
        assert scale > 0.0, i
        assert np.abs(port - ref).max() <= 1e-10 * scale, (i, np.abs(port - ref).max() / scale)
