"""The port's host-side threefry keys and the fused generator's hash bits
equal JAX's bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace_torch.ops import rng
from uvtrace_torch.ops.traverse_mxu import hash_uniforms

SEEDS = [0, 1, 3, 12345, 2**31 - 1, 2**31, 2**32 - 1]


def _kd(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(rng.PRNGKey(seed), _kd(k))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(rng.split(rng.PRNGKey(seed), num), _kd(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    for d in [0, 1, 2, 7, 1000, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1]:
        np.testing.assert_array_equal(rng.fold_in(rng.PRNGKey(seed), d), _kd(jax.random.fold_in(k, d)))
    # launch.py folds an int32 global chunk index: negative values wrap to 2^32 - |d|
    gi = jnp.int32(-3)
    np.testing.assert_array_equal(rng.fold_in(rng.PRNGKey(seed), -3), _kd(jax.random.fold_in(k, gi)))


def test_simulator_key_chain():
    """The key schedule of Simulator._single_light + launch_counts: per
    waypoint key, rng_in = split(key), chunk keys fold_in(rng_in, gi)."""
    jk, pk = jax.random.PRNGKey(0), rng.PRNGKey(0)
    for _ in range(6):
        jk, j_in = jax.random.split(jk)
        pk, p_in = rng.split(pk)
        np.testing.assert_array_equal(pk, _kd(jk))
        for gi in (0, 1, 31):
            np.testing.assert_array_equal(rng.fold_in(p_in, gi), _kd(jax.random.fold_in(j_in, gi)))
    np.testing.assert_array_equal(rng.fold_in(rng.split(rng.fold_in(pk, 9), 3)[2], 4),
                                  _kd(jax.random.fold_in(jax.random.split(jax.random.fold_in(jk, 9), 3)[2], 4)))


def _jax_uniforms(key_words, g, packet):
    """The fused TPU kernel's counter hash (uvtrace/ops/traverse_mxu.py:688-705)
    in int32 jnp: wrapping multiplies and logical shifts."""
    def wang(x):
        x = (x ^ 61) ^ jax.lax.shift_right_logical(x, 16)
        x = x * 9
        x = x ^ jax.lax.shift_right_logical(x, 4)
        x = x * jnp.int32(0x27D4EB2D)
        return x ^ jax.lax.shift_right_logical(x, 15)

    k0, k1 = (jnp.asarray(np.uint32(w)).astype(jnp.int32) for w in key_words)
    rows = []
    for pid in range(g):
        ctr = (jax.lax.broadcasted_iota(jnp.int32, (3, packet), 0) * packet
               + jax.lax.broadcasted_iota(jnp.int32, (3, packet), 1) + pid * (3 * packet))
        h = wang(wang(ctr ^ k0) ^ k1)
        rows.append(jax.lax.shift_right_logical(h, 8).astype(jnp.float32) * np.float32(1.0 / (1 << 24)))
    return np.stack([np.asarray(r) for r in rows], axis=1)  # (3, g, packet)


@pytest.mark.parametrize("seed,gi", [(0, 0), (3, 1), (7, 2**31 + 1)])
def test_hash_uniforms_exact(seed, gi):
    key = rng.fold_in(rng.PRNGKey(seed), gi)
    u = hash_uniforms(key, 4, 1024, "cpu").numpy()
    np.testing.assert_array_equal(u, _jax_uniforms(key, 4, 1024))
    assert u.dtype == np.float32 and (u >= 0).all() and (u < 1).all()


@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
@pytest.mark.parametrize("seed,gi", [(0, 0), (3, 7919), (2**32 - 1, 2**31 + 5)])
def test_uniform_bit_equal(seed, gi, n):
    """Device uniforms equal jax.random.uniform bit for bit, in the default
    [0, 1) form and in the minval/maxval forms the samplers use."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gi)
    words = _kd(key)
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (0.0, 2.0 * np.pi)]:
        j = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval=lo, maxval=hi))
        p = rng.uniform(words, n, "cpu", minval=lo, maxval=hi).numpy()
        assert p.dtype == np.float32 and p.shape == (n,)
        np.testing.assert_array_equal(p.view(np.uint32), j.view(np.uint32))


def test_random_bits_bit_equal():
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    j = np.asarray(jax.random.bits(key, (5000,), jnp.uint32))
    np.testing.assert_array_equal(rng.random_bits(_kd(key), 5000, "cpu").numpy().astype(np.uint32), j)
