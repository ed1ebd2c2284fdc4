"""The port's host-side threefry keys and the fused generator's hash bits
equal JAX's bit for bit."""

import os

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


@pytest.mark.parametrize("n", [1, 1000, 1023, 1 << 16, (1 << 16) + 37])
@pytest.mark.parametrize("seed,gi", [(0, 0), (3, 7919), (2**32 - 1, 2**31 + 5)])
def test_uniform_bit_equal(seed, gi, n):
    """Device uniforms equal jax.random.uniform bit for bit, in the default
    [0, 1) form and in the minval/maxval forms the samplers use, also at
    sizes that are not a whole number of the kernel's 256-thread blocks."""
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


@pytest.mark.parametrize("shape", [(4, 202, 1), (8, 1), (3, 5, 7)])
@pytest.mark.parametrize("seed,gi", [(0, 0), (5, 11), (2**32 - 1, 2**31 + 5)])
def test_uniform_of_nd_shapes_bit_equal(seed, gi, shape):
    """An N-D draw is the 1-D draw reshaped: the partitionable threefry
    counts the elements of a shape in row-major order. The keys of
    split(key, 3) feed the draws, as `irradiance` does."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gi)
    keys = jax.random.split(key, 3)
    np.testing.assert_array_equal(rng.split(_kd(key), 3), _kd(keys))
    for k in keys:
        j = np.asarray(jax.random.uniform(k, shape))
        p = rng.uniform(_kd(k), shape, "cpu").numpy()
        assert p.shape == shape and p.dtype == np.float32
        np.testing.assert_array_equal(p.view(np.uint32), j.view(np.uint32))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 255, 256, 4097, 70001])
def test_cumsum_in_xla_order(n):
    """`cumsum_f32` is jnp.cumsum on XLA:CPU bit for bit: a blocked scan of
    base 16, recursive. A sequential f32 sum differs at these sizes."""
    p = np.random.default_rng(n).uniform(0.0, 1.0, n).astype(np.float32)
    np.testing.assert_array_equal(rng.cumsum_f32(p), np.asarray(jnp.cumsum(jnp.asarray(p))))


def _jax_sources(areas, words, n_sources):
    """`_source_field`'s jax.random.choice (uvtrace/diff/estimator.py:403-405)."""
    a = jnp.asarray(areas)
    key = jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))
    return np.asarray(jax.random.choice(key, a.shape[0], (n_sources,), p=a / jnp.sum(a)))


def _source_keys(n_waypoints: int):
    """keys[0] of every waypoint's bounce term in route_dose with PRNGKey(0):
    split(fold_in(fold_in(key, w), 1), 4)[0]."""
    return [rng.split(rng.fold_in(rng.fold_in(rng.PRNGKey(0), w), 1), 4)[0] for w in range(n_waypoints)]


def test_choice_equals_jax_on_box_room_areas():
    """The bounce estimator's area-weighted source triangles equal
    jax.random.choice's: the area total is the f32 rounding of the exact sum
    (XLA's total here), the cumulative sum is XLA's, and the draw
    r = cdf[-1] (1 - u) searched from the left."""
    from uvtrace.geometry.procedural import make_box_room
    from uvtrace_torch.diff.estimator import area_cdf

    areas = make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0).areas
    cdf, total = area_cdf(areas)
    cdf = torch.from_numpy(cdf)
    assert np.float32(total) == np.float32(jnp.sum(jnp.asarray(areas)))
    for words in _source_keys(12):
        j = _jax_sources(areas, words, 64)
        np.testing.assert_array_equal(rng.choice_from_cdf(words, (64,), cdf).numpy(), j)
        p = np.asarray(areas / jnp.sum(jnp.asarray(areas)))
        np.testing.assert_array_equal(rng.choice(words, len(areas), (64,), p).numpy(), j)


def test_choice_source_flips_on_testroom_are_counted():
    """On testroomopt's 44,866 areas, over the 12 waypoints' keys of config
    4 (64 sources each): every source index equals JAX's, or the flip is
    counted and its draw lies within 4 ulp of the cumulative boundary it
    crossed. None flips with these keys."""
    from uvtrace.geometry.gltf import load_glb
    from uvtrace_torch.diff.estimator import area_cdf

    areas = load_glb(os.path.join(os.path.dirname(__file__), "..", "assets", "testroomopt.glb")).areas
    cdf, total = area_cdf(areas)
    cdf = torch.from_numpy(cdf)
    assert np.float32(total) == np.float32(jnp.sum(jnp.asarray(areas)))
    c = cdf.numpy()
    flips = 0
    for words in _source_keys(12):
        p = rng.choice_from_cdf(words, (64,), cdf).numpy()
        j = _jax_sources(areas, words, 64)
        for i in np.nonzero(p != j)[0]:
            flips += 1
            r = c[-1] * (np.float32(1) - rng.uniform(words, 64, "cpu").numpy()[i])
            edge = c[min(p[i], j[i])]
            assert abs(float(r) - float(edge)) <= 4 * float(np.spacing(edge)), (i, r, edge)
    assert flips == 0
