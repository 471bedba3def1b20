"""Bounds on values that carry a gradient, written as the JAX package writes
them (``jnp.maximum``, ``jnp.minimum``, ``jnp.clip``).

At a tie, where the value sits exactly on its bound, JAX passes half the
cotangent to each side; ``torch.clamp`` passes all of it to the value, while
``torch.maximum`` / ``torch.minimum`` of two tensors pass half, as JAX does.
So a bound is a maximum or minimum against a 0-dim tensor. The values are
those of ``torch.clamp`` (a -0.0 input may come out as +0.0).
"""

from __future__ import annotations

import torch


def at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``."""
    return torch.maximum(x, x.new_full((), lo))


def unit_interval(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0.0, 1.0)``: the maximum, then the minimum."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def nonnegative(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``, written into ``x`` when autograd records
    nothing for it (a full-size temporary less)."""
    zero = x.new_zeros(())
    if x.requires_grad:
        return torch.maximum(x, zero)
    return torch.maximum(x, zero, out=x)
