"""The split kernel's per-ray tree walk (TPU kernel B2, csrc/traverse_mxu.cu)
in its plain version: the tree of two levels it walks (the top tree of the
clusters, each cluster the root of a sub-tree over its real triangles), its
conservative visit rule and its (ray, leaf) and (ray, triangle) statistics.

The kernel returns each ray's lexicographic (t, slot) minimum over the
leaves it visits, so it equals the brute-force `closest_hits` exactly when
every winning slot lies in a leaf that the visit rule keeps at the ray's
final t. These tests replay the walk (`walk_tests`, its (t, slot) bit-equal
to brute force) on ordinary rays and on adversarial ones (rays through
shared edges and corners of axis-aligned walls, whose leaves have flat
boxes; rays parallel to an axis; origins on box faces; grazing rays; NaN
rays and parked dead lanes; the differentiable layer's shadow rays from
points on triangles to points on triangles of other clusters, among long
thin triangles and far from the origin), in the box room and in the test
room's clusters, and hold the replayed walk's leaf tests between the leaves
a ray needs and the leaves it enters at all. The top trees are compared
with the gen-1 scene's and with the tree built from a JAX scene's arrays,
and every real slot lies in exactly one leaf.
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
from uvtrace_torch.bvh import native
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops import traverse_pallas as tp
from uvtrace_torch.ops.cluster import build_clusters

SIZES = (32, 64, 128)
TESTROOM = os.path.join(os.path.dirname(__file__), "..", "assets", "testroomopt.glb")


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
    if kind == "nan":  # NaN origins and directions among incoherent rays
        o, d = inside, _unit(g.normal(size=(n, 3)))
        o[::7, g.integers(0, 3)] = np.nan
        d[3::11, g.integers(0, 3)] = np.nan
        return o, d
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
    """Brute force (t, slot) and the replayed walk's ((ray, leaf) tests,
    (ray, triangle) tests, t, slot) per ray."""
    t, slot, leaf_key = tm.closest_hits(scene, tm.ray_features(o, d), per_leaf=True)
    return (t, slot) + tm.walk_tests(scene, o, d, leaf_key)


def _assert_conservative(scene, o, d, t, slot, tests, tri_tests, wt, ws):
    """Every winning slot lies in a leaf the visit rule keeps at the final
    t; the walk's (t, slot) is brute force's, bit for bit; it tests at least
    the leaves (and their triangles) a ray needs and at most those it
    enters. Returns the clusters each ray needs."""
    hit = slot >= 0
    leaf = tm._walk_leaves(scene)[1][slot[hit].long()]
    meta = scene.walk_meta.view(-1, 2)
    leaf_box = scene.walk_box.view(-1, 8)[meta[:, 1] >= 0]
    assert tm.may_visit(leaf_box[leaf], o[hit], d[hit], t[hit]).all()
    assert torch.equal(wt, t) and torch.equal(ws, slot)
    big = torch.full_like(t, tm.BIG)
    for stat, tri in ((tests, False), (tri_tests, True)):
        assert (tm.leaves_within(scene, o, d, t, triangles=tri) <= stat).all()
        assert (stat <= tm.leaves_within(scene, o, d, big, triangles=tri)).all()
    # the work the ray needs: every needed cluster holds 1 to C real triangles
    needed = tm.clusters_within(scene, o, d, t)
    needed_tris = tm.clusters_within(scene, o, d, t, triangles=True)
    assert (needed <= needed_tris).all() and (needed_tris <= needed * scene.cluster_size).all()
    return needed


@pytest.mark.parametrize("c_sz", SIZES)
@pytest.mark.parametrize("kind", ["stratified", "incoherent", "parked", "probes"])
def test_walk_statistic_lies_between_needed_and_entered(scenes, room, kind, c_sz):
    """The plain statistics: per packet, the (ray, leaf) and (ray, triangle)
    tests of the replayed walk, between the leaves its rays need and those
    they enter; parked lanes and all-dead packets test nothing; probes cull
    by their origin."""
    scene = scenes[c_sz]
    n, packet = 2048, 512
    o, d = (torch.from_numpy(a) for a in _rays(kind, room, n))
    t, slot, tests, tri_tests, wt, ws = _walk(scene, o, d)
    needed = _assert_conservative(scene, o, d, t, slot, tests, tri_tests, wt, ws)
    pt, ps, visits, tri_visits = tm.traverse_mxu_padded_reference(scene, o, d, packet=packet, with_visits=True)
    assert torch.equal(pt, t) and torch.equal(ps, slot)
    assert visits.dtype == torch.int32 and torch.equal(visits, tests.view(-1, packet).sum(1, dtype=torch.int32))
    assert tri_visits.dtype == torch.int32
    assert torch.equal(tri_visits, tri_tests.view(-1, packet).sum(1, dtype=torch.int32))
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
        walk = _walk(scene, o, d)
        _assert_conservative(scene, o, d, *walk)
        assert (walk[1] >= 0).float().mean() > 0.4
        return
    room, by_size = surface_scenes[kind]
    scene = by_size[c_sz]
    o, d = (torch.from_numpy(a) for a in _surface_rays(room, scene, 2048))
    walk = _walk(scene, o, d)
    t, slot = walk[:2]
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
    _assert_conservative(scene, o[keep], d[keep], *(w[keep] for w in walk))
    assert int(in_plane.sum()) <= 2048 // 100 and hit.float().mean() > 0.4
    if kind != "surface_far":
        _assert_conservative(scene, o, d, *walk)


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
    t2, slot2, visits, tri_visits = tm.traverse_mxu_padded_reference(scene, o_nan, d[:512], packet=512,
                                                                     with_visits=True)
    assert slot2[7] == -1 and t2[7] == tm._BIG32
    keep = torch.arange(512) != 7
    assert torch.equal(t2[keep], t[:512][keep]) and torch.equal(slot2[keep], slot[:512][keep])
    assert visits[0] > 0 and tri_visits[0] >= visits[0]


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


@pytest.fixture(scope="module")
def testroom():
    """The test room and its scene from the native cluster builder, as the
    Simulator and the diff layer build it."""
    mesh = load_glb(TESTROOM)
    build = native.build_clusters_native if native.available() else build_clusters
    cs = build(mesh.tris)
    return mesh, cs, tm.build_mxu_scene(cs, device="cpu")


@pytest.mark.parametrize("kind", ["corners", "edges", "axis", "on_face", "grazing", "nan", "parked", "incoherent"])
def test_two_level_walk_is_brute_force_on_the_test_room(testroom, kind):
    """The adversarial families through the walk of the test room's 525
    clusters, each a sub-tree with leaves of at most SUB_LEAF triangles
    (many of them flat on its walls and floor): the replayed walk's (t,
    slot) is brute force's bit for bit, every winner's leaf is kept at its
    t, and the walk tests between the leaves a ray needs and those it
    enters; NaN rays and parked lanes miss and test nothing."""
    mesh, _, scene = testroom
    o, d = (torch.from_numpy(a) for a in _rays(kind, mesh, 1024))
    walk = _walk(scene, o, d)
    _assert_conservative(scene, o, d, *walk)
    dead = (o == 1e6).all(1) | o.isnan().any(1) | d.isnan().any(1)
    assert (walk[2][dead] == 0).all() and (walk[1][dead] == -1).all()
    assert (walk[1][~dead] >= 0).float().mean() > 0.4
    # a ray tests a small share of the triangles of the clusters it needs
    assert walk[3][~dead].sum() < 0.5 * tm.clusters_within(scene, o, d, walk[0], triangles=True)[~dead].sum()


@pytest.mark.parametrize("scene_kind", ["box32", "box128", "testroom", "jax_arrays"])
def test_every_real_slot_lies_in_exactly_one_leaf(scene_kind, scenes, room, testroom):
    """The walk tree: the top tree's nodes at their ids, inner ones (left
    child, -1); its leaves cover every real slot once and no padded slot,
    in leaf_slot's order, with leaf_feat the slots' tri_feat; a leaf's box
    holds its triangles and a node's box its children's; leaves hold at
    most SUB_LEAF triangles, or a whole cluster's real slots when
    scene_from_numpy has no vertices; the box room's walls give flat leaf
    boxes."""
    if scene_kind == "testroom":
        _, cs, scene = testroom
    else:
        cs = build_clusters(room.tris, cluster_size=32 if scene_kind == "box32" else 128)
        scene = scenes[cs.cluster_size]
    if scene_kind == "jax_arrays":
        scene = tm.scene_from_numpy(scene.boxes.numpy(), scene.feat.numpy(), scene.tri_idx_flat.numpy(), device="cpu")
    n_top = scene.node_meta.shape[0] // 2
    meta, box = scene.walk_meta.view(-1, 2).long(), scene.walk_box.view(-1, 8)
    top = scene.node_meta.view(-1, 2).long()
    assert torch.equal(box[:n_top], scene.node_box.view(-1, 8))
    assert torch.equal(meta[:n_top][top[:, 1] == 0], torch.stack([top[top[:, 1] == 0, 0], -torch.ones_like(
        top[top[:, 1] == 0, 0])], 1))
    leaf = meta[:, 1] >= 0
    first, count = meta[leaf, 0], meta[leaf, 1]
    pos = torch.cat([torch.arange(f, f + c) for f, c in zip(first.tolist(), count.tolist())])
    real = torch.nonzero(scene.tri_idx_flat >= 0).flatten()
    assert torch.equal(pos.sort().values, torch.arange(real.numel()))  # each place of leaf_slot in one leaf
    assert torch.equal(scene.leaf_slot.long().sort().values, real)  # each real slot once, no padded one
    assert torch.equal(scene.leaf_feat, scene.tri_feat.reshape(-1, tm.KROWS, 4)[scene.leaf_slot.long()])
    if scene_kind == "jax_arrays":  # a cluster is one leaf of its real slots
        assert int(leaf.sum()) == scene.n_clusters and n_top == meta.shape[0]
        cid = top[top[:, 1] == 1, 0]
        assert torch.equal(count, (scene.tri_idx_flat.view(scene.n_clusters, -1)[cid] >= 0).sum(1))
    else:
        assert int(count.max()) <= tm.SUB_LEAF and int(count.min()) >= 1
    verts = torch.from_numpy(cs.tris.reshape(-1, 3, 3))[scene.leaf_slot.long()]
    leaf_of = torch.repeat_interleave(torch.arange(int(leaf.sum())), count[torch.argsort(first)])
    lb = box[leaf][torch.argsort(first)][leaf_of]  # each triangle's leaf box, in leaf_slot's order
    assert (verts.amin(1) >= lb[:, :3]).all() and (verts.amax(1) <= lb[:, 3:6]).all()
    inner = torch.nonzero(~leaf).flatten()
    for child in (meta[inner, 0], meta[inner, 0] + 1):
        assert (box[child, :3] >= box[inner, :3]).all() and (box[child, 3:6] <= box[inner, 3:6]).all()
    assert scene.walk_depth <= tm.STACK_DEPTH
    if scene_kind.startswith("box"):
        assert ((box[leaf, 3:6] - box[leaf, :3]) == 0).any(1).float().mean() > 0.25
