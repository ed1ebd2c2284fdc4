"""The split kernel's per-ray tree walk (TPU kernel B2, csrc/traverse_mxu.cu)
in its plain version: the top tree it walks, its conservative visit rule and
its (ray, leaf) statistic.

The kernel returns each ray's lexicographic (t, slot) minimum over the
clusters it visits, so it equals the brute-force `closest_hits` exactly when
every winning slot lies in a cluster that the visit rule keeps at the ray's
final t. These tests hold that property on ordinary rays and on adversarial
ones (rays through shared edges and corners of axis-aligned walls, whose
clusters have flat boxes; rays parallel to an axis; origins on box faces;
grazing rays; the differentiable layer's shadow rays from points on
triangles to points on triangles of other clusters, among long thin
triangles and far from the origin), and hold the replayed walk's leaf tests between the clusters a ray needs
and the clusters it enters at all. The trees are compared with the gen-1
scene's and with the tree built from a JAX scene's arrays.
"""

import os

import jax
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room as jax_box_room
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.generate import generate_stratified as jax_generate_stratified
from uvtrace.ops.probes import probe_rays as jax_probe_rays
from uvtrace.ops.traverse_mxu import build_mxu_scene as jax_build_mxu_scene
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops import traverse_pallas as tp
from uvtrace_torch.ops.cluster import build_clusters

SIZES = (32, 64, 128)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=8, clutter=4, seed=3)


@pytest.fixture(scope="module")
def scenes(room):
    return {c: tm.build_mxu_scene(build_clusters(room.tris, cluster_size=c), device="cpu") for c in SIZES}


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays(kind: str, room, n: int):
    """f32[n, 3] origins and directions, made with numpy from a seed."""
    g = np.random.default_rng(17)
    verts = room.tris.reshape(-1, 3)
    lo, hi = verts.min(0), verts.max(0)
    inside = (lo + (hi - lo) * g.uniform(0.02, 0.98, (n, 3))).astype(np.float32)
    if kind == "stratified":
        lamp = np.array([0.2, room.floor_height + 0.8, -0.3], np.float32)
        r = jax_generate_stratified(jax.random.PRNGKey(6), n, lamp, 1.0)
        return np.array(r.orig), np.array(r.dir)
    if kind == "incoherent":
        return inside, _unit(g.normal(size=(n, 3)))
    if kind == "parked":  # dead bounce lanes among live ones, and an all-dead packet
        o, d = inside, _unit(g.normal(size=(n, 3)))
        dead = g.uniform(size=n) < 0.4
        dead[: n // 4] = True
        o[dead] = 1e6
        d[dead] = (1.0, 0.0, 0.0)
        return o, d
    if kind == "probes":  # a top-down grid padded with parked probes
        side = int(np.sqrt(n // 2))
        o, d = jax_probe_rays(lo, hi, side, pad=n - side * side)
        return np.array(o), np.array(d)
    tri = room.tris[g.integers(0, len(room.tris), n)]
    if kind == "corners":  # aimed at triangle vertices: shared by neighbours in other clusters
        return inside, _unit(tri[np.arange(n), g.integers(0, 3, n)] - inside)
    if kind == "edges":  # aimed at edge midpoints
        k = g.integers(0, 3, n)
        target = 0.5 * (tri[np.arange(n), k] + tri[np.arange(n), (k + 1) % 3])
        return inside, _unit(target - inside)
    if kind == "axis":  # parallel to an axis, both ways
        d = np.zeros((n, 3), np.float32)
        d[np.arange(n), g.integers(0, 3, n)] = g.choice([-1.0, 1.0], n)
        return inside, d
    if kind == "on_face":  # origins on triangle vertices (box faces), half in-plane, half random
        o = tri[np.arange(n), g.integers(0, 3, n)].astype(np.float32)
        e = tri[:, 1] - tri[:, 0]
        d = np.where(g.uniform(size=(n, 1)) < 0.5, e, g.normal(size=(n, 3)))
        return o, _unit(d)
    if kind == "grazing":  # nearly in a triangle's plane, |n . d| from 1e-5 to 1e-3, aimed at its centroid
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]).astype(np.float64)
        size = np.linalg.norm(nrm, axis=1, keepdims=True)
        in_plane = np.cross(nrm / size, g.normal(size=(n, 3)))
        in_plane /= np.linalg.norm(in_plane, axis=1, keepdims=True)
        den = 10.0 ** g.uniform(-5.0, -3.0, (n, 1)) * g.choice([-1.0, 1.0], (n, 1))
        d = _unit(in_plane + den / size * (nrm / size))
        return (tri.mean(1) - g.uniform(0.2, 2.0, (n, 1)) * d).astype(np.float32), d
    raise ValueError(kind)


def _walk(scene, o, d):
    """Brute force (t, slot) and the replayed walk's (tests, best t) per ray."""
    t, slot, t_cl = tm.closest_hits(scene, tm.ray_features(o, d), per_cluster=True)
    tests, best = tm.walk_tests(scene, o, d, t_cl)
    return t, slot, tests, best


def _assert_conservative(scene, o, d, t, slot, tests, best):
    """Every winning slot lies in a cluster the visit rule keeps at the final
    t; the walk finds the brute-force t; it tests at least the clusters a ray
    needs and at most those it enters."""
    hit = slot >= 0
    cid = slot[hit].long() // scene.cluster_size
    assert tm.may_visit(scene.box6[cid], o[hit], d[hit], t[hit]).all()
    assert torch.equal(best, t)
    needed = tm.clusters_within(scene, o, d, t)
    entered = tm.clusters_within(scene, o, d, torch.full_like(t, tm.BIG))
    assert (needed <= tests).all() and (tests <= entered).all()
    # the work the ray needs: every needed cluster holds 1 to C real triangles
    needed_tris = tm.clusters_within(scene, o, d, t, triangles=True)
    assert (needed <= needed_tris).all() and (needed_tris <= needed * scene.cluster_size).all()
    return needed


@pytest.mark.parametrize("c_sz", SIZES)
@pytest.mark.parametrize("kind", ["stratified", "incoherent", "parked", "probes"])
def test_walk_statistic_lies_between_needed_and_entered(scenes, room, kind, c_sz):
    """The plain statistic: per packet, the (ray, leaf) tests of the replayed
    walk, between the clusters its rays need and those they enter; parked
    lanes and all-dead packets test nothing; probes cull by their origin."""
    scene = scenes[c_sz]
    n, packet = 2048, 512
    o, d = (torch.from_numpy(a) for a in _rays(kind, room, n))
    t, slot, tests, best = _walk(scene, o, d)
    needed = _assert_conservative(scene, o, d, t, slot, tests, best)
    pt, ps, visits = tm.traverse_mxu_padded_reference(scene, o, d, packet=packet, with_visits=True)
    assert torch.equal(pt, t) and torch.equal(ps, slot)
    assert visits.dtype == torch.int32 and torch.equal(visits, tests.view(-1, packet).sum(1, dtype=torch.int32))
    parked = (o == 1e6).all(1)
    assert (tests[parked] == 0).all() and (slot[parked] == -1).all()
    if kind == "parked":
        assert visits[0] == 0 and visits[1:].sum() > 0
    if kind == "probes":  # a probe needs the clusters under it, not every cluster below the grid
        assert needed[~parked].float().mean() < 0.5 * scene.n_clusters
    assert tests[~parked].sum() > 0


def _thin_room():
    """A 4 x 3 x 4 m box whose faces are strips 5 cm wide (two triangles a
    strip, 80:1), and 64 long slivers (2-3 m by 1-2 cm) across its inside."""
    g = np.random.default_rng(23)
    tris = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (0.0, 1.0):
            for k in range(80):
                q = np.zeros((4, 3))
                q[:, axis] = side
                q[:, u] = [k / 80, (k + 1) / 80, (k + 1) / 80, k / 80]
                q[:, v] = [0.0, 0.0, 1.0, 1.0]
                tris += [q[[0, 1, 2]], q[[0, 2, 3]]]
    tris = np.array(tris) * np.array([4.0, 3.0, 4.0]) - np.array([2.0, 1.0, 2.0])
    a = g.uniform([-1.8, -0.8, -1.8], [1.8, 1.8, 1.8], (64, 3))
    along = g.normal(size=(64, 3))
    along /= np.linalg.norm(along, axis=1, keepdims=True)
    b = a + g.uniform(2.0, 3.0, (64, 1)) * along
    c = 0.5 * (a + b) + g.uniform(0.01, 0.02, (64, 1)) * _unit(np.cross(along, g.normal(size=(64, 3))))
    tris = np.concatenate([tris, np.stack([a, b, c], 1)])
    return TriangleMesh(tris=tris.astype(np.float32))


SURFACE_ROOMS = {"surface": None, "surface_thin": _thin_room, "surface_far": None}
FAR = np.array([100.0, 0.0, -100.0], np.float32)  # the box room moved 141 m from the origin


@pytest.fixture(scope="module")
def surface_scenes(room):
    """(room, {C: scene}) of each surface-ray kind: the box room, the thin
    strips and slivers, the box room far from the origin."""
    rooms = {"surface": room, "surface_thin": _thin_room(), "surface_far": TriangleMesh(tris=room.tris + FAR)}
    return {k: (r, {c: tm.build_mxu_scene(build_clusters(r.tris, cluster_size=c), device="cpu") for c in SIZES})
            for k, r in rooms.items()}


def _surface_rays(room, scene, n: int):
    """Shadow rays of the bounce estimator: origins at random points on
    triangles, each aimed at a random point on a triangle of another
    cluster (f32, made with numpy from a seed)."""
    g = np.random.default_rng(29)
    t_count = room.triangle_count
    slot_tri = scene.tri_idx_flat.numpy()
    cluster_of = np.empty(t_count, np.int64)
    cluster_of[slot_tri[slot_tri >= 0]] = np.nonzero(slot_tri >= 0)[0] // scene.cluster_size
    src = g.integers(0, t_count, n)
    dst = g.integers(0, t_count, n)
    while (same := cluster_of[src] == cluster_of[dst]).any():
        dst[same] = g.integers(0, t_count, int(same.sum()))

    def point(ids):
        w = g.dirichlet(np.ones(3), len(ids)).astype(np.float32)
        return np.einsum("nk,nkc->nc", w, room.tris[ids]).astype(np.float32)

    o = point(src)
    return o, _unit(point(dst) - o)


@pytest.mark.parametrize("c_sz", SIZES)
@pytest.mark.parametrize("kind", ["corners", "edges", "axis", "on_face", "grazing", *SURFACE_ROOMS])
def test_visit_rule_keeps_every_winner_on_adversarial_rays(scenes, room, surface_scenes, kind, c_sz):
    """Rays through shared edges and corners of axis-aligned walls (flat
    cluster boxes, ties between clusters), rays parallel to an axis (zero
    direction components: inv = 1e30), origins on box faces, grazing rays
    (|den| down to the hit rule's 1e-5, where t = q3 / den is least exact),
    and the differentiable layer's surface-to-surface shadow rays (origins
    on triangles, targets on triangles of other clusters) in the box room,
    among long thin strips and slivers, and 141 m from the origin: brute
    force and the walk's visit set agree."""
    if kind not in SURFACE_ROOMS:
        scene = scenes[c_sz]
        o, d = (torch.from_numpy(a) for a in _rays(kind, room, 2048))
        t, slot, tests, best = _walk(scene, o, d)
        _assert_conservative(scene, o, d, t, slot, tests, best)
        assert (slot >= 0).float().mean() > 0.4
        return
    room, by_size = surface_scenes[kind]
    scene = by_size[c_sz]
    o, d = (torch.from_numpy(a) for a in _surface_rays(room, scene, 2048))
    t, slot, tests, best = _walk(scene, o, d)
    # A ray from a point on a wall to another point of the same wall lies in
    # the wall's plane: |n . d| of a few 1e-6, where the f32 Plücker t of
    # the wall's triangles is rounding noise and brute force may report a
    # hit that the exact ray misses by metres (u, v far outside [0, 1]),
    # outside its cluster's box: 141 m from the origin, the walk skips such
    # phantom winners (ROADMAP.md §C). Its bounce weight cos * cos is below
    # 1e-8. Every other ray keeps its winner.
    hit = slot >= 0
    nrm = torch.from_numpy(room.normals)[scene.tri_idx_flat[slot.clamp_min(0).long()].long()]
    in_plane = hit & ((nrm * d).sum(1).abs() < 1e-4)
    keep = ~in_plane
    _assert_conservative(scene, o[keep], d[keep], t[keep], slot[keep], tests[keep], best[keep])
    assert int(in_plane.sum()) <= 2048 // 100 and hit.float().mean() > 0.4
    if kind != "surface_far":
        _assert_conservative(scene, o, d, t, slot, tests, best)


def test_visit_rule_needs_its_slack_and_nan_rays_miss(scenes, room):
    """Without the slack the rule would drop a winner on the flat walls of the
    box room (a hit t a few ulps short of its box's slab interval); a NaN ray
    visits nothing, misses, and leaves its neighbours' results alone."""
    scene = scenes[64]
    o, d = (torch.from_numpy(a) for a in _rays("corners", room, 4096))
    t, slot = tm.closest_hits(scene, tm.ray_features(o, d))
    hit = slot >= 0
    box = scene.box6[slot[hit].long() // 64]
    lo, exit_ = tm._slab(box, o[hit], d[hit], tm.safe_inv_dir(d[hit]), 0.0)  # the box itself
    assert not (lo <= torch.minimum(exit_, t[hit])).all()  # the strict rule loses winners here
    assert tm.may_visit(box, o[hit], d[hit], t[hit]).all()
    o_nan = o[:512].clone()
    o_nan[7] = float("nan")
    t2, slot2, visits = tm.traverse_mxu_padded_reference(scene, o_nan, d[:512], packet=512, with_visits=True)
    assert slot2[7] == -1 and t2[7] == tm._BIG32
    keep = torch.arange(512) != 7
    assert torch.equal(t2[keep], t[:512][keep]) and torch.equal(slot2[keep], slot[:512][keep])
    assert visits[0] > 0


@pytest.mark.parametrize("scene_kind", ["box", "testroom"])
def test_mxu_scene_tree_equals_the_gen1_scene_tree(scene_kind):
    """MxuScene carries the same top tree arrays as PallasScene (one helper,
    `cluster_top_tree`), here at the gen-1 kernel's cluster size."""
    if scene_kind == "box":
        tris = make_box_room(subdivisions=6, clutter=3, seed=2).tris
    else:
        tris = load_glb(os.path.join(os.path.dirname(__file__), "..", "assets", "testroomopt.glb")).tris
    cs = build_clusters(tris, cluster_size=128)
    ms, ps = tm.build_mxu_scene(cs, device="cpu"), tp.build_pallas_scene(cs, device="cpu")
    assert torch.equal(ms.node_box, ps.node_box) and torch.equal(ms.node_meta, ps.node_meta)
    assert ms.depth == ps.depth <= tm.STACK_DEPTH
    # every leaf names one cluster, each cluster once
    meta = ms.node_meta.view(-1, 2)
    leaves = meta[meta[:, 1] == 1, 0]
    assert torch.equal(leaves.sort().values, torch.arange(cs.n_clusters, dtype=torch.int32))


@pytest.mark.parametrize("c_sz", SIZES)
def test_scene_from_jax_arrays_gives_the_same_tree(c_sz):
    """scene_from_numpy on a JAX MxuScene's arrays (boxes in its padded
    (6, 8, L8) layout) builds the tree and the triangle-major features that
    build_mxu_scene builds from the clusters."""
    tris = jax_box_room(subdivisions=6, clutter=3, seed=2).tris
    jscene = jax_build_mxu_scene(jax_build_clusters(tris, cluster_size=c_sz))
    again = tm.scene_from_numpy(np.asarray(jscene.boxes), np.asarray(jscene.feat), np.asarray(jscene.tri_idx_flat),
                                device="cpu")
    port = tm.build_mxu_scene(build_clusters(tris, cluster_size=c_sz), device="cpu")
    assert again.depth == port.depth
    for name in ("node_box", "node_meta", "tri_feat", "box6"):
        assert torch.equal(getattr(again, name), getattr(port, name)), name
    # row k of triangle j holds feat[:, k, q*C + j] for q = 0..3
    j, k = c_sz // 2, 7
    np.testing.assert_array_equal(again.tri_feat[:, j, k].numpy(),
                                  np.asarray(jscene.feat)[:, k, [j, c_sz + j, 2 * c_sz + j, 3 * c_sz + j]])
