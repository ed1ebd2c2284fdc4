"""The port's fine-BVH walk (uvtrace_torch/ops/traverse.py) and the
Simulator's "jax" traversal against the JAX package on the CPU
(uvtrace/ops/traverse.py, run as tests/test_traverse.py runs it), on JAX's
cases: room interior rays, a random triangle soup, a single leaf and
axis-aligned rays.

Both sides walk the same numpy BVH (the numpy builder; JAX's FlatBVH goes
into the port as it is) with the same f32 operations and the same rules, so
the hit ids are held equal. t is held within rtol 2e-6 (a few ulps): XLA:CPU
contracts some of Möller–Trumbore's multiply-adds when it compiles JAX's
while_loop (jax.jit(intersect_tri) differs from JAX's eager ops by the same
ulps on a random soup's rays), while the port rounds every product; on rays
from a lamp it is bit-equal. The Simulator's maps bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvtrace.bvh.native
import uvtrace_torch.bvh.native
from uvtrace.bvh.builder import build_bvh, single_leaf_bvh
from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.ops import traverse as J
from uvtrace.ops.generate import generate_native, generate_stratified
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace_torch.bvh import builder as port_builder
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import traverse as P
from uvtrace_torch.ops.intersect import brute_force_closest_hit
from uvtrace_torch.sim import SimParams, Simulator

ROUTE = [(0.0, 0.0, 1.0), (1.0, -1.5, 2.0)]


@pytest.fixture(scope="module")
def small_room():
    return make_box_room(subdivisions=4, clutter=3, seed=1)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


def _both(bvh, o, d, max_leaf=None):
    """((t, hit) of JAX, (t, hit) of the port) of the same rays."""
    max_leaf = bvh.max_leaf_size if max_leaf is None else max_leaf
    jt, jh = J.traverse(J.scene_arrays(bvh), jnp.asarray(o), jnp.asarray(d), max_leaf=max_leaf)
    pt, ph = P.traverse(P.scene_arrays(bvh, device="cpu"), torch.from_numpy(np.array(o)),
                        torch.from_numpy(np.array(d)), max_leaf=max_leaf)
    assert pt.dtype == torch.float32 and ph.dtype == torch.int32
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=2e-6, atol=0)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    return pt, ph


def _soup(rng, n, spread):
    base = rng.uniform(-1, 1, size=(n, 1, 3))
    return (base + rng.uniform(-spread, spread, size=(n, 3, 3))).astype(np.float32)


def _random_rays(rng, n):
    o = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_room_interior_rays(small_room):
    bvh = build_bvh(small_room.tris, max_leaf_size=8)
    rays = generate_native(jax.random.PRNGKey(0), 2000, (0.0, 0.0, 0.0), 1.0)
    pt, ph = _both(bvh, rays.orig, rays.dir)
    assert (ph >= 0).all()  # interior rays of a closed room all hit
    jt = J.traverse(J.scene_arrays(bvh), rays.orig, rays.dir, max_leaf=bvh.max_leaf_size)[0]
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))  # from a lamp: bit-equal
    bt, bh = brute_force_closest_hit(torch.from_numpy(np.array(rays.orig)), torch.from_numpy(np.array(rays.dir)),
                                     torch.from_numpy(small_room.tris))
    torch.testing.assert_close(pt, bt, rtol=1e-5, atol=0)


def test_random_soup(rng):
    tris = _soup(rng, 400, 0.15)
    _both(build_bvh(tris), *_random_rays(rng, 1000))


def test_single_leaf_equals_bvh(rng):
    """One leaf of every triangle (the walk tests them all) and the SAH
    tree: equal t; each held to JAX's, and a max_leaf below the leaf size
    cuts the leaf short in both."""
    tris = _soup(rng, 64, 0.2)
    o, d = _random_rays(rng, 256)
    slb, b = single_leaf_bvh(tris), build_bvh(tris)
    t1, _ = _both(slb, o, d)
    t2, _ = _both(b, o, d)
    torch.testing.assert_close(t1, t2, rtol=1e-5, atol=0)
    _both(slb, o, d, max_leaf=16)


def test_axis_aligned_rays(small_room):
    """Zero direction components: the slab test's 1e30 inverse."""
    bvh = build_bvh(small_room.tris, max_leaf_size=8)
    o = np.array([[0, 0, 0], [0.1, 0.2, 0.3], [0, 0, 0], [0.5, -0.5, 0.5]], np.float32)
    d = np.array([[0, -1, 0], [0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32)
    _, ph = _both(bvh, o, d)
    assert (ph >= 0).all()


@pytest.mark.parametrize("check_every", [1, 3])
def test_done_checks_and_compaction_change_no_value(small_room, monkeypatch, check_every):
    """Finished lanes are frozen: reading `done` every step or every third,
    and dropping finished lanes, gives the same t and hits; the port's BVH
    copy (bvh/builder.py) is JAX's."""
    bvh = port_builder.build_bvh(small_room.tris, max_leaf_size=4)
    jbvh = build_bvh(small_room.tris, max_leaf_size=4)
    np.testing.assert_array_equal(bvh.left_first, jbvh.left_first)
    rays = generate_stratified(jax.random.PRNGKey(2), 2048, (0.3, 0.0, -0.2), 1.0, packet=1024)
    ref = _both(jbvh, rays.orig, rays.dir)
    monkeypatch.setattr(P, "CHECK_EVERY", check_every)
    t, hit, steps = P.traverse(P.scene_arrays(bvh, "cpu"), torch.from_numpy(np.array(rays.orig)),
                               torch.from_numpy(np.array(rays.dir)), max_leaf=4, with_steps=True)
    assert torch.equal(t, ref[0]) and torch.equal(hit, ref[1]) and steps % check_every == 0 and steps > 0


def test_native_bvh_against_brute_force(small_room):
    """The fine BVH of the port's native builder (node order fixed), walked:
    t equal to brute force within rtol 1e-5, ids equal but on ties."""
    if not uvtrace_torch.bvh.native.available():
        pytest.skip("g++ did not build the native builder here")
    bvh = uvtrace_torch.bvh.native.build_bvh_native(small_room.tris, max_leaf_size=8)
    assert bvh.max_leaf_size <= 8
    rays = generate_native(jax.random.PRNGKey(4), 4096, (0.2, 0.0, 0.1), 1.0)
    o, d = torch.from_numpy(np.array(rays.orig)), torch.from_numpy(np.array(rays.dir))
    t, hit = P.traverse(P.scene_arrays(bvh, "cpu"), o, d, max_leaf=bvh.max_leaf_size)
    bt, bh = brute_force_closest_hit(o, d, torch.from_numpy(small_room.tris))
    torch.testing.assert_close(t, bt, rtol=1e-5, atol=0)
    assert (hit != bh).float().mean() < 1e-3


@pytest.fixture
def numpy_builders(monkeypatch):
    monkeypatch.setattr(uvtrace.bvh.native, "available", lambda: False)
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)


def _params(**kw):
    return dict(dict(photon_count=2 * 3000, max_iterations=1, seed=3, traversal="jax"), **kw)


@pytest.mark.parametrize("case", ["stratified", "native_leaf_4", "bounces", "jax_bvh"])
def test_simulator_jax_traversal_matches_jax(small_room, numpy_builders, case):
    """The "jax" traversal's photon maps bit-equal to JAX's: its fine BVH
    from the numpy builder with max_leaf_size (4 or 8), or JAX's own numpy
    FlatBVH passed as bvh=, which selects the traversal whatever
    params.traversal says."""
    kw = dict(stratified=dict(), native_leaf_4=dict(sampler="native"), bounces=dict(max_bounces=2, reflectance=0.5),
              jax_bvh=dict(traversal="auto"))[case]
    leaf = 4 if case == "native_leaf_4" else 8
    bvh = build_bvh(small_room.tris, max_leaf_size=leaf) if case == "jax_bvh" else None
    js = JaxSimulator(small_room, JaxSimParams(**_params(**kw)), route=[JaxLightPos(*w) for w in ROUTE],
                      ray_chunk=1024, max_leaf_size=leaf, bvh=bvh)
    js.compute()
    ps = Simulator(small_room, SimParams(**_params(**kw)), route=[LightPos(*w) for w in ROUTE], ray_chunk=1024,
                   max_leaf_size=leaf, bvh=bvh, device="cpu")
    ps.compute()
    assert ps.backend == js.backend == "jax" and ps.bvh.max_leaf_size == js.bvh.max_leaf_size <= leaf
    np.testing.assert_array_equal(ps.photon_map.numpy(), np.asarray(js.photon_map))
    np.testing.assert_array_equal(ps.dose_grid(res=16), js.dose_grid(res=16))
    assert ps.photon_map.sum() > 0


def test_scene_arrays_match_jax(small_room):
    bvh = build_bvh(small_room.tris, max_leaf_size=8)
    ja, pa = J.scene_arrays(bvh), P.scene_arrays(bvh, device="cpu")
    for name in ja._fields:
        np.testing.assert_array_equal(getattr(pa, name).numpy(), np.asarray(getattr(ja, name)))
    assert P.STACK_DEPTH == J.STACK_DEPTH == 48
    fn = functools.partial(P.traverse, P.scene_arrays(bvh, "cpu"))
    t, hit = fn(torch.zeros((0, 3)), torch.zeros((0, 3)))  # no rays, no steps
    assert t.shape == hit.shape == (0,)
