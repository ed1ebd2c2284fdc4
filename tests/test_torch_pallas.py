"""The port's gen-1 packet DFS (plain version of TPU kernel B3) and its
intersection primitives against the JAX package.

JAX runs its Pallas kernel in interpret mode, as tests/test_traverse_pallas.py
does on the CPU, on that file's scenes and rays; each interpret-mode trace
runs once, in a module fixture. The port runs `traverse_pallas` on CPU
tensors, which is its plain version. Tolerances, with their reasons:
  - against JAX interpret mode: triangle ids equal and t within rtol 1e-6.
    Both evaluate the same slab tests and Möller–Trumbore formulas in the same
    f32 order and visit the same nodes, so bit-equality is expected, and was
    seen on every case here; the rtol leaves room for XLA:CPU contracting a
    product and a sum into one multiply-add inside a fused loop;
  - against the brute-force closest hit: t within rtol 1e-5 and the same
    misses, as tests/test_traverse_pallas.py holds the JAX kernel; ids equal
    on at least 99.9% of rays (a t-tie between clusters goes to the first
    visited, the brute force takes the lowest id);
  - intersect.py against JAX with jit disabled: bit-equal (each jnp op is
    then its own computation, with nothing contracted).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops import intersect as jax_intersect
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.generate import generate_native, generate_stratified
from uvtrace.ops.traverse_pallas import build_pallas_scene as jax_build_pallas_scene
from uvtrace.ops.traverse_pallas import traverse_pallas as jax_traverse_pallas
from uvtrace_torch.ops import intersect
from uvtrace_torch.ops import traverse_pallas as tp
from uvtrace_torch.ops.cluster import build_clusters

def _mixed_rays():
    """A stratified packet whose every eighth column (8 consecutive rays)
    carries native iid rays from another lamp, and 40 parked dead lanes:
    leaves with one to three active columns among full ones."""
    s = generate_stratified(jax.random.PRNGKey(4), 1024, (0.0, 0.2, 0.0), 1.0)
    n = generate_native(jax.random.PRNGKey(5), 1024, (0.3, -0.2, 0.1), 0.5)
    o, d = np.array(s.orig).reshape(-1, 8, 8, 3), np.array(s.dir).reshape(-1, 8, 8, 3)
    o[:, 0], d[:, 0] = np.array(n.orig).reshape(-1, 8, 8, 3)[:, 0], np.array(n.dir).reshape(-1, 8, 8, 3)[:, 0]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    o[600:640], d[600:640] = 1e6, (1.0, 0.0, 0.0)
    return types.SimpleNamespace(orig=jnp.asarray(o), dir=jnp.asarray(d))


# (scene, rays) of tests/test_traverse_pallas.py, and the mixed packet
CASES = {
    "stratified": (dict(subdivisions=6, clutter=3, seed=2),
                   lambda: generate_stratified(jax.random.PRNGKey(0), 2048, (0.0, 0.2, 0.0), 1.0)),
    "native": (dict(subdivisions=6, clutter=3, seed=2),
               lambda: generate_native(jax.random.PRNGKey(9), 1024, (0.3, -0.2, 0.1), 0.5)),
    "single_cluster": (dict(subdivisions=2),
                       lambda: generate_stratified(jax.random.PRNGKey(1), 1024, (0.0, 0.3, 0.0), 0.5)),
    "mixed": (dict(subdivisions=6, clutter=3, seed=2), _mixed_rays),
}


@pytest.fixture(scope="module")
def traced():
    """Each case's room, rays and the JAX kernel's (t, ids) in interpret mode."""
    out = {}
    for name, (room_kw, make_rays) in CASES.items():
        room = make_box_room(**room_kw)
        rays = make_rays()
        jt, jh = jax_traverse_pallas(jax_build_pallas_scene(jax_build_clusters(room.tris, cluster_size=128)),
                                     rays.orig, rays.dir, interpret=True)
        out[name] = (room, np.array(rays.orig), np.array(rays.dir), np.asarray(jt), np.asarray(jh))
    return out


def _port(room, o, d, **kw):
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    return scene, tp.traverse_pallas(scene, torch.from_numpy(o), torch.from_numpy(d), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_interpret(traced, case):
    room, o, d, jt, jh = traced[case]
    _, (pt, ph) = _port(room, o, d)
    assert pt.dtype == torch.float32 and ph.dtype == torch.int32
    np.testing.assert_array_equal(ph.numpy(), jh)
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-6)
    assert ((ph.numpy() < 0) == (pt.numpy() >= tp.BIG)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_brute_force(traced, case):
    room, o, d, _, _ = traced[case]
    scene, (pt, ph, stats) = _port(room, o, d, with_stats=True)
    bt, bh = intersect.brute_force_closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                               torch.from_numpy(room.tris))
    np.testing.assert_allclose(pt.numpy(), bt.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(ph.numpy() < 0, bh.numpy() < 0)
    assert (ph == bh).float().mean() > 0.999
    leaves, columns = stats.numpy().T
    assert stats.shape == (o.shape[0] // tp.PACKET, 2)
    assert (leaves >= 1).all() and (leaves <= scene.n_clusters).all()
    assert (columns <= leaves * (tp.PACKET // 8)).all() and (columns > 0).all()


def test_wrapper_on_cpu_runs_the_plain_version_and_checks_shapes(traced):
    room, o, d, _, _ = traced["native"]
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    po, pd = torch.from_numpy(o), torch.from_numpy(d)
    before = tp.traverse_pallas.launches
    a = tp.traverse_pallas(scene, po, pd, with_stats=True)
    b = tp.traverse_pallas_reference(scene, po, pd, with_stats=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 3
    assert tp.traverse_pallas.launches == before  # the kernel did not run
    with pytest.raises(ValueError, match="1024"):
        tp.traverse_pallas(scene, po[:1000], pd[:1000])


def test_parked_zero_axis_and_nan_rays(traced):
    """Parked lanes (origin 1e6, direction +x) miss; straight-down probes (x
    and z direction exactly 0) hit what the brute force hits; a NaN ray
    misses without changing its packet's other rays."""
    room, o, d, _, _ = traced["native"]
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    o, d = o.copy(), d.copy()
    o[:100], d[:100] = 1e6, (1.0, 0.0, 0.0)
    lo, hi = room.tris.reshape(-1, 3).min(0), room.tris.reshape(-1, 3).max(0)
    g = np.random.default_rng(3)
    o[100:300] = np.stack([g.uniform(lo[0], hi[0], 200), np.full(200, hi[1] + 0.1), g.uniform(lo[2], hi[2], 200)], 1)
    d[100:300] = (0.0, -1.0, 0.0)
    d[300] = np.nan
    po, pd = torch.from_numpy(o), torch.from_numpy(d)
    t, hit = tp.traverse_pallas(scene, po, pd)
    assert (hit[:100] == -1).all() and (t[:100] == tp.BIG).all()
    assert hit[300] == -1 and t[300] == tp.BIG
    keep = torch.ones(o.shape[0], dtype=torch.bool)
    keep[300] = False
    bt, bh = intersect.brute_force_closest_hit(po[keep], pd[keep], torch.from_numpy(room.tris))
    np.testing.assert_allclose(t[keep].numpy(), bt.numpy(), rtol=1e-5)
    assert (hit[keep] >= 0).sum() == (bh >= 0).sum() and (hit[100:300] >= 0).all()


def test_top_tree_deeper_than_the_stack_raises(monkeypatch):
    room = make_box_room(subdivisions=6, clutter=3, seed=2)
    cs = build_clusters(room.tris, cluster_size=128)
    assert tp.build_pallas_scene(cs, device="cpu").depth == 3
    monkeypatch.setattr(tp, "STACK_DEPTH", 2)
    with pytest.raises(ValueError, match="stack"):
        tp.build_pallas_scene(cs, device="cpu")
    with pytest.raises(ValueError, match="128"):
        tp.build_pallas_scene(build_clusters(room.tris, cluster_size=64), device="cpu")


@pytest.mark.parametrize("room_kw", [dict(subdivisions=6, clutter=3, seed=2), dict(subdivisions=2)])
def test_scene_arrays_and_slots_in_use_match_the_jax_scene(room_kw):
    """The arrays the kernel reads equal the JAX PallasScene's (tolerance 0),
    and tri_used, up to which the kernel tests a cluster's slots, counts its
    real triangles: the slots behind are the all-zero padding."""
    room = make_box_room(**room_kw)
    jscene = jax_build_pallas_scene(jax_build_clusters(room.tris, cluster_size=128))
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    for name in ("node_box", "node_meta", "tri", "tri_idx_flat"):
        np.testing.assert_array_equal(getattr(scene, name).numpy().reshape(-1),
                                      np.asarray(getattr(jscene, name)).reshape(-1), err_msg=name)
    real = np.asarray(jscene.tri_idx_flat).reshape(-1, tp.LANES) >= 0
    used = scene.tri_used.numpy()
    assert scene.tri_used.dtype == torch.int32
    np.testing.assert_array_equal(used, real.sum(1))
    assert all((scene.tri[l, :, u:] == 0).all() for l, u in enumerate(used))


def test_weighted_column_statistic(traced):
    """column_weight counts an active column of cluster c as weight[c]: with
    ones the plain statistic, with tri_used on a one-cluster scene the
    columns times the cluster's triangles; t and ids do not move."""
    room, o, d, _, _ = traced["single_cluster"]
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    po, pd = torch.from_numpy(o), torch.from_numpy(d)
    plain = tp.traverse_pallas_reference(scene, po, pd, with_stats=True)
    ones = tp.traverse_pallas_reference(scene, po, pd, with_stats=True,
                                        column_weight=torch.ones(scene.n_clusters, dtype=torch.int64))
    used = tp.traverse_pallas_reference(scene, po, pd, with_stats=True, column_weight=scene.tri_used.long())
    assert all(torch.equal(a, b) for a, b in zip(plain, ones))
    assert torch.equal(used[0], plain[0]) and torch.equal(used[1], plain[1])
    assert scene.n_clusters == 1 and torch.equal(used[2][:, 1], plain[2][:, 1] * int(scene.tri_used[0]))


def test_used_slots_is_one_past_the_last_non_zero_slot():
    nonzero = np.zeros((4, 8), bool)
    nonzero[1, :3] = True
    nonzero[2, 5] = True  # a hole before it still counts: the kernels test slots 0..5
    nonzero[3] = True
    np.testing.assert_array_equal(tp.used_slots(nonzero), [0, 3, 6, 8])


def _rays_and_tris(seed: int, n: int = 2000, t_count: int = 150):
    g = np.random.default_rng(seed)
    o = g.normal(size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:20, 0] = 0.0  # zero components: the 1e-30 guard of safe_inv_dir
    tris = (2 * g.normal(size=(t_count, 3, 3))).astype(np.float32)
    return o, d, tris


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_primitives_match_jax(seed):
    o, d, tris = _rays_and_tris(seed)
    po, pd, pt = (torch.from_numpy(a) for a in (o, d, tris))
    box_min, box_max = tris.min(1), tris.max(1)
    t_best = np.random.default_rng(seed + 10).uniform(0, 5, (o.shape[0], 1)).astype(np.float32)
    with jax.disable_jit():
        j_tri = np.asarray(jax_intersect.intersect_tri(o[:, None], d[:, None], tris[None, :, 0], tris[None, :, 1],
                                                       tris[None, :, 2]))
        j_inv = np.asarray(jax_intersect.safe_inv_dir(jnp.asarray(d)))
        j_box = np.asarray(jax_intersect.intersect_aabb(o[:, None], j_inv[:, None], box_min[None], box_max[None],
                                                        t_best))
        j_t, j_id = (np.asarray(x) for x in jax_intersect.brute_force_closest_hit(o, d, jnp.asarray(tris), chunk=500))
    p_tri = intersect.intersect_tri(po[:, None], pd[:, None], pt[None, :, 0], pt[None, :, 1], pt[None, :, 2])
    np.testing.assert_array_equal(p_tri.numpy(), j_tri)
    assert (j_tri < 1e30).sum() > 1000  # real hits, not only misses
    p_inv = intersect.safe_inv_dir(pd)
    np.testing.assert_array_equal(p_inv.numpy(), j_inv)
    p_box = intersect.intersect_aabb(po[:, None], p_inv[:, None], torch.from_numpy(box_min)[None],
                                     torch.from_numpy(box_max)[None], torch.from_numpy(t_best))
    np.testing.assert_array_equal(p_box.numpy(), j_box)
    p_t, p_id = intersect.brute_force_closest_hit(po, pd, pt, chunk=500)
    np.testing.assert_array_equal(p_t.numpy(), j_t)
    np.testing.assert_array_equal(p_id.numpy(), j_id)
