"""Dropout (ops/dropout.py): the counter-hash keep mask as plain XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gcn.ops.dropout import dropout, hash_bits, keep_threshold

SHAPE = (1000, 257)


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.6, 0.9])
def test_keep_fraction_within_5_sigma(rate):
    x = jnp.ones(SHAPE, jnp.float32)
    out = np.asarray(dropout(x, rate, jax.random.PRNGKey(0)))
    keep = 1.0 - rate
    frac = (out != 0).mean()
    sigma = np.sqrt(keep * (1 - keep) / out.size)
    assert abs(frac - keep) < 5 * sigma, (frac, keep)
    np.testing.assert_allclose(np.unique(out[out != 0]), 1 / keep, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_commutes_with_the_mask(dtype):
    x = jax.random.normal(jax.random.PRNGKey(1), SHAPE).astype(dtype)
    key = jax.random.PRNGKey(2)
    a = dropout(jax.nn.relu(x), 0.3, key)
    b = jax.nn.relu(dropout(x, 0.3, key))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_gradient_is_the_forward_mask(rate):
    x = jnp.abs(jax.random.normal(jax.random.PRNGKey(3), SHAPE)) + 1.0
    key = jax.random.PRNGKey(4)
    out, vjp = jax.vjp(lambda h: dropout(h, rate, key), x)
    (dx,) = vjp(jnp.ones_like(x))
    out, dx = np.asarray(out), np.asarray(dx)
    np.testing.assert_array_equal(out != 0, dx != 0)
    np.testing.assert_allclose(dx[dx != 0], 1 / (1 - rate), rtol=1e-6)


def test_eval_and_zero_rate_are_identity():
    x = jax.random.normal(jax.random.PRNGKey(5), (64, 32))
    key = jax.random.PRNGKey(6)
    assert dropout(x, 0.5, key, training=False) is x
    assert dropout(x, 0.0, key) is x


def test_mask_is_a_function_of_key_and_shape():
    x = jnp.ones(SHAPE)
    k1, k2 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    a = np.asarray(dropout(x, 0.5, k1))
    np.testing.assert_array_equal(a, np.asarray(dropout(x, 0.5, k1)))
    assert (a != np.asarray(dropout(x, 0.5, k2))).mean() > 0.4
    # jit and eager agree bitwise
    np.testing.assert_array_equal(
        a, np.asarray(jax.jit(dropout, static_argnums=1)(x, 0.5, k1)))


@pytest.mark.parametrize("shape", [(4096,), (64, 33), (7, 9, 11)])
def test_hash_bits_are_uniform_and_shape_general(shape):
    bits = np.asarray(hash_bits(shape, jnp.uint32(12345)), np.uint64)
    assert bits.shape == shape
    n = bits.size
    # each of the top 4 bits is set about half the time
    for b in range(28, 32):
        p = ((bits >> b) & 1).mean()
        assert abs(p - 0.5) < 5 * np.sqrt(0.25 / n), (b, p)
    # distinct counters give (almost surely) distinct words
    assert len(np.unique(bits)) > 0.99 * n


def test_keep_threshold_bounds():
    assert keep_threshold(0.0) == 2**32 - 1
    assert keep_threshold(0.5) == 2**31
    assert keep_threshold(1.0 - 2**-33) == 0
