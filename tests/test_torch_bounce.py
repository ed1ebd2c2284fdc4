"""The port's bounce and probe functions against the JAX package, on the
same inputs made with numpy from a seed.

Tolerances, with their reasons: the roulette uniforms are threefry bits and
f32 arithmetic on both sides, so `alive` is bit-equal; new directions go
through sqrt, cos and sin, whose XLA-CPU and torch versions differ by an
ulp, so origins and directions agree within 1e-6; the coherence sort is
stable on both sides, so its permutation is identical; probe rays are f32
arithmetic only and bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.ops.bounce import bounce_rays as jax_bounce_rays
from uvtrace.ops.bounce import coherence_sort as jax_coherence_sort
from uvtrace.ops.bounce import cosine_hemisphere as jax_cosine_hemisphere
from uvtrace.ops.bounce import orthonormal_basis as jax_orthonormal_basis
from uvtrace.ops.probes import first_hits_skip_ceiling as jax_first_hits
from uvtrace.ops.probes import probe_rays as jax_probe_rays
from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort, cosine_hemisphere, orthonormal_basis
from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays


def _kw(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_orthonormal_basis_matches_jax():
    n = _unit(np.random.default_rng(0), 2000)
    n[:3] = [(0, 0, 1), (0, 0, -1), (1, 0, 0)]
    for j, p in zip(jax_orthonormal_basis(jnp.asarray(n)), orthonormal_basis(torch.from_numpy(n))):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 9])
def test_cosine_hemisphere_matches_jax(seed):
    n = _unit(np.random.default_rng(seed), 4096)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    j = np.asarray(jax_cosine_hemisphere(key, jnp.asarray(n)))
    p = cosine_hemisphere(_kw(key), torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
    assert ((p * n).sum(1) >= -1e-6).all()


@pytest.mark.parametrize("seed,rho", [(1, 0.5), (4, 0.25)])
def test_bounce_rays_matches_jax(seed, rho):
    g = np.random.default_rng(seed)
    r, t_count = 4096, 300
    orig = g.uniform(-2, 2, (r, 3)).astype(np.float32)
    direction = _unit(g, r)
    t_hit = g.uniform(0.1, 3.0, r).astype(np.float32)
    hit = g.integers(-1, t_count, r).astype(np.int32)
    t_hit[hit < 0] = 1e30
    normals = _unit(g, t_count)
    refl = np.full(t_count, rho, np.float32)
    refl[::7] = 0.9
    alive = g.uniform(size=r) < 0.8
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 7919), 2)
    jo, jd, ja = (np.asarray(x) for x in jax_bounce_rays(
        key, *(jnp.asarray(a) for a in (orig, direction, t_hit, hit, normals, refl, alive))))
    po, pd, pa = (x.numpy() for x in bounce_rays(
        _kw(key), *(torch.from_numpy(a) for a in (orig, direction, t_hit, hit, normals, refl, alive))))
    np.testing.assert_array_equal(pa, ja)
    assert 0 < pa.sum() < r
    np.testing.assert_allclose(po, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(po[~pa], 1e6)
    np.testing.assert_array_equal(pd[~pa], np.broadcast_to([1.0, 0.0, 0.0], pd[~pa].shape))


@pytest.mark.parametrize("with_index", [False, True])
def test_coherence_sort_matches_jax(with_index):
    g = np.random.default_rng(3)
    r = 5000
    orig = g.uniform(-4, 4, (r, 3)).astype(np.float32)
    orig[:40] = [0.5, 0.5, 0.5]  # many equal keys: the sort must be stable
    direction = _unit(g, r)
    direction[:40] = [0.3, 0.3, 0.9]
    alive = g.uniform(size=r) < 0.6
    index = np.arange(r, dtype=np.int32) if with_index else None
    kw = dict(index=jnp.asarray(index)) if with_index else {}
    j = [np.asarray(x) for x in jax_coherence_sort(jnp.asarray(orig), jnp.asarray(direction),
                                                   jnp.asarray(alive), **kw)]
    kw = dict(index=torch.from_numpy(index)) if with_index else {}
    p = [x.numpy() for x in coherence_sort(torch.from_numpy(orig), torch.from_numpy(direction),
                                           torch.from_numpy(alive), **kw)]
    assert len(p) == len(j) == 3 + with_index
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a, b)
    assert not p[2][alive.sum():].any()  # dead lanes sort to the end


@pytest.mark.parametrize("res,pad", [(16, 0), (48, 768)])
def test_probe_rays_match_jax(res, pad):
    lo = np.array([-2.31, -1.4, -3.07], np.float32)
    hi = np.array([2.9, 1.35, 3.3], np.float32)
    jo, jd = (np.asarray(x) for x in jax_probe_rays(lo, hi, res, pad=pad))
    po, pd = probe_rays(lo, hi, res, pad=pad)
    np.testing.assert_array_equal(po.numpy(), jo)
    np.testing.assert_array_equal(pd.numpy(), jd)


@pytest.mark.parametrize("skip_ceiling", [True, False])
def test_first_hits_skip_ceiling_matches_jax(skip_ceiling):
    """The re-cast logic on a synthetic two-level world (ceiling at y=2, floor
    at y=0, some probes miss): the same extend function on both sides."""
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    hi = np.array([4.0, 2.0, 4.0], np.float32)

    def world(o, where):
        y = o[:, 1]
        inside = (o[:, 0] > 0.5) & (o[:, 0] < 3.5)
        ceiling = inside & (y > 2.0)
        t = where(ceiling, y - 2.0, where(y > 0.0, y, np.float32(1e30)))
        return t, where(ceiling, 1, where(y > 0.0, 0, -1))

    jf = lambda o, d: world(o, jnp.where)  # noqa: E731
    pf = lambda o, d: world(o, torch.where)  # noqa: E731
    jo, jd = jax_probe_rays(lo, hi, 8)
    po, pd = probe_rays(lo, hi, 8)
    jt, jh = (np.asarray(x) for x in jax_first_hits(jf, jo, jd, 0.0, 2.0, skip_ceiling=skip_ceiling))
    pt, ph = (x.numpy() for x in first_hits_skip_ceiling(pf, po, pd, 0.0, 2.0, skip_ceiling=skip_ceiling))
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pt, jt)
    assert (ph == 1).any() != skip_ceiling
