"""Threefry-2x32 counter-based random numbers in plain torch, bit-for-bit
the stream of ``jax.random`` (threefry2x32 keys, ``jax_threefry_partitionable``
on, the default of jax 0.9) for the calls the McICA sampler makes:

- ``seed_key(seed)``: ``jax.random.key(seed)`` (``threefry_seed``);
- ``fold_in(key, data)``: ``jax.random.fold_in``;
- ``uniform_from_counter(key, idx, dtype)``: element ``idx`` of the flattened
  ``jax.random.uniform(key, shape, dtype)`` in [0, 1): each element is a pure
  function of (key, flat index), whatever the shape.

Words are uint32 values held in int64 tensors (or Python ints for scalar
keys), masked after every add and shift. ``csrc/mcica.cuh`` is the CUDA
counterpart; the two give the same bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) of key (k0, k1) on the counter
    words (x0, x1); arguments broadcast, each word a uint32 value."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` as its two uint32 words, for 0 <= seed < 2**63."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed}: McICA seeds are non-negative")
    return (seed >> 32) & M32, seed & M32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the key words of threefry of the
    counter (0, data); ``data`` may be a tensor of uint32 values."""
    return threefry2x32(key[0], key[1], 0, data)


def uniform_from_counter(key, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Element ``idx`` (int64 tensor) of the flattened
    ``jax.random.uniform(key, ..., dtype)``: threefry of the counter
    (idx >> 32, idx & M32), mantissa bits OR'd into 1.0, minus 1."""
    b0, b1 = threefry2x32(key[0], key[1], (idx >> 32) & M32, idx & M32)
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise TypeError(f"uniform_from_counter: dtype {dtype}, takes float32 or float64")
