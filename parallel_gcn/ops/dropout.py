"""Inverted dropout with a counter-based keep mask.

Reference: src/module.cu:3-99 — in-place inverted dropout with a Philox pool,
mask kept only when the input needs grad, no-op in evaluation. Here the keep
mask is a pure function of (element index, seed): a murmur3-style integer mix
of the row-major element counter, compared against ``keep · 2³²``. It is
plain elementwise XLA code, so the bit generation, compare, select, scale and
any neighbouring ReLU fuse into one kernel, and the backward pass either
regenerates the identical mask or reuses it — the reference's Philox re-walk
(src/module.cu:80-99) without a stream to walk. The VJP of
``where(keep, x / keep_prob, 0)`` is exactly the reference's backward kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def keep_threshold(rate: float) -> int:
    """uint32 threshold with P(bits < threshold) = 1 - rate."""
    return min(int(round((1.0 - rate) * 2.0**32)), 2**32 - 1)


def hash_bits(shape, seed) -> jnp.ndarray:
    """uint32 pseudo-random bits for every element of ``shape``: the
    murmur3 finalizer over (row-major counter · golden-ratio constant + seed).
    The counter wraps past 2³² elements."""
    k = jnp.zeros(shape, jnp.uint32)
    stride = 1
    for dim in reversed(range(len(shape))):
        k = k + lax.broadcasted_iota(jnp.uint32, shape, dim) * jnp.uint32(
            stride & 0xFFFFFFFF
        )
        stride *= shape[dim]
    k = k * jnp.uint32(0x9E3779B1) + seed.astype(jnp.uint32)
    k = k ^ (k >> 16)
    k = k * jnp.uint32(0x7FEB352D)
    k = k ^ (k >> 15)
    k = k * jnp.uint32(0x846CA68B)
    return k ^ (k >> 16)


def dropout(x: jnp.ndarray, rate: float, key: jax.Array, training: bool = True):
    """Keep each element with prob ``1-rate`` and scale survivors by 1/(1-rate).

    ``rate`` and ``training`` are trace-time constants: at rate 0 or in eval
    this compiles to nothing (reference: src/module.cu:67-68).
    """
    if not training or rate <= 0.0:
        return x
    seed = jax.random.bits(key, (), jnp.uint32)
    keep = hash_bits(x.shape, seed) < jnp.uint32(keep_threshold(rate))
    scale = jnp.asarray(1.0 / (1.0 - rate), dtype=x.dtype)
    return jnp.where(keep, x * scale, jnp.zeros((), x.dtype))
