"""The port's fused generate + trace + histogram against the JAX kernel.

JAX runs its Pallas kernel in interpret mode at precision="highest" (f32), as
its own tests do on the CPU; the port runs its plain PyTorch version (the
wrapper's CPU route). Tolerances, with their reasons:
  - ray origins and dir.y come from the hash and f32 arithmetic only: exact;
  - dir.x/z go through cos/sin, whose XLA-CPU and torch implementations
    differ by an ulp: atol 2e-6;
  - slots agree on at least 99.9% of rays; a mismatch must be a tie or an edge
    flip from the ulp-level ray or summation differences, so its t agrees to
    rtol 1e-5 (JAX breaks t-ties across clusters by visit order, the port by
    the lowest slot).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.traverse_mxu import build_mxu_scene as jax_build_mxu_scene
from uvtrace.ops.traverse_mxu import fused_trace_counts as jax_fused
from uvtrace.ops.traverse_mxu import traverse_mxu_counts as jax_counts
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.utils import timing

PACKET = 1024
TESTROOM = os.path.join(os.path.dirname(__file__), "..", "assets", "testroomopt.glb")


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


@pytest.fixture(scope="module")
def scenes(room):
    out = {}
    for c in (64, 128):
        out[c] = (jax_build_mxu_scene(jax_build_clusters(room.tris, cluster_size=c)),
                  tm.build_mxu_scene(build_clusters(room.tris, cluster_size=c), device="cpu"))
    return out


def _jax_key(seed, gi):
    k = jax.random.PRNGKey(seed)
    return k if gi is None else jax.random.fold_in(k, gi)


def _port_key(seed, gi):
    k = rng.PRNGKey(seed)
    return k if gi is None else rng.fold_in(k, gi)


def _assert_slots_agree(jt, js, pt, ps):
    mism = js != ps
    assert mism.mean() <= 1e-3, f"{mism.sum()} slot mismatches of {mism.size}"
    np.testing.assert_allclose(pt, jt, rtol=1e-5)
    return int(mism.sum())


# (cluster size, seed, chunk index folded in, lamp offset from the floor, packet, n)
CASES = [
    (64, 3, None, (0.0, 0.8, 0.0), 1024, 4 * PACKET),
    (128, 6, None, (0.3, 0.5, -0.7), 2048, 4 * PACKET),
    (64, 11, 2**31 + 3, (0.2, 0.8, -0.1), 1024, 8 * PACKET),
    (128, 0, 5, (-2.5, 1.2, 3.5), 1024, 4 * PACKET),
]


@pytest.mark.parametrize("c_sz,seed,gi,lamp_off,packet,n", CASES)
def test_plain_matches_jax_fused(scenes, room, c_sz, seed, gi, lamp_off, packet, n):
    jscene, pscene = scenes[c_sz]
    lamp = np.array([lamp_off[0], room.floor_height + lamp_off[1], lamp_off[2]], np.float32)
    jt, js, jc, jo, jd = (np.asarray(x) for x in jax_fused(
        jscene, _jax_key(seed, gi), jnp.asarray(lamp), 1.0, n,
        interpret=True, precision="highest", with_rays=True, packet=packet))
    pt, ps, pc, po, pd = (x.numpy() for x in tm.fused_trace_counts_reference(
        pscene, _port_key(seed, gi), lamp.tolist(), 1.0, n, packet=packet, with_rays=True))
    assert pt.shape == (n,) and ps.dtype == np.int32 and pc.shape == jc.shape
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pd[:, 1], jd[:, 1])
    np.testing.assert_allclose(pd, jd, rtol=0, atol=2e-6)
    mism = _assert_slots_agree(jt, js, pt, ps)
    assert int(pc.sum()) == int(jc.sum()) == n  # closed room: every ray lands
    assert np.abs(pc.astype(np.int64) - jc).sum() <= 2 * mism


def test_plain_trace_on_jax_rays(scenes, room):
    """The brute-force closest hit on JAX's own rays agrees with JAX's split
    kernel (traverse_mxu_counts) on them: the trace apart from the generator."""
    jscene, pscene = scenes[64]
    lamp = jnp.array([0.4, room.floor_height + 0.9, 0.3], jnp.float32)
    n = 4 * PACKET
    _, _, _, jo, jd = jax_fused(jscene, jax.random.PRNGKey(21), lamp, 1.0, n,
                                interpret=True, precision="highest", with_rays=True)
    jt, js, jc = (np.asarray(x) for x in jax_counts(jscene, jo, jd, interpret=True, precision="highest"))
    rf = tm.ray_features(torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd)))
    pt, ps = (x.numpy() for x in tm.closest_hits(pscene, rf))
    mism = _assert_slots_agree(jt, js, pt, ps)
    pc = np.bincount(ps[ps >= 0], minlength=jc.shape[0])
    assert np.abs(pc - jc).sum() <= 2 * mism and pc.sum() == n


@pytest.fixture(scope="module")
def testroom_scene():
    mesh = load_glb(TESTROOM)
    return mesh, tm.build_mxu_scene(build_clusters(mesh.tris, cluster_size=128), device="cpu")


@pytest.mark.parametrize("lamp_off,seed", [((0.0, 0.8, 0.0), 0), ((1.5, 0.3, -2.0), 1)])
def test_frustum_culling_is_conservative(testroom_scene, lamp_off, seed):
    """What the CUDA kernel relies on, checked on the plain functions: every
    closest hit lies in a cluster the packet frustum keeps, no nearer than
    the frustum's entry, and the near-first walk that stops once the entry
    exceeds the packet bound (the `visits` the kernel reports) already finds
    every ray's closest hit."""
    mesh, scene = testroom_scene
    n, c_sz = 4 * PACKET, scene.cluster_size
    lamp = (lamp_off[0], mesh.floor_height + lamp_off[1], lamp_off[2])
    t, slot, counts, orig, direction, visits = tm.fused_trace_counts_reference(
        scene, rng.PRNGKey(seed), lamp, 1.0, n, with_rays=True, with_visits=True)
    _, _, pb = tm.generate_fused_rays(rng.PRNGKey(seed), lamp, 1.0, n)
    ent = tm.frustum_entries(scene.box6, pb)  # [g, L]
    hit = slot >= 0
    assert hit.float().mean() > 0.5
    packet_of = torch.arange(n) // PACKET
    e_hit = ent[packet_of[hit], slot[hit].long() // c_sz]
    assert (e_hit <= t[hit]).all()
    _, _, t_cl = tm.closest_hits(scene, tm.ray_features(orig, direction), per_cluster=True)
    order = torch.sort(ent, dim=1, stable=True).indices
    for p in range(n // PACKET):
        v = int(visits[p])
        assert 1 <= v <= int((ent[p] < tm.BIG).sum())
        walk = t_cl[p * PACKET:(p + 1) * PACKET][:, order[p, :v]].amin(1)
        assert torch.equal(walk, t[p * PACKET:(p + 1) * PACKET])


def test_wrapper_on_cpu_runs_the_plain_version(scenes, room):
    _, pscene = scenes[128]
    lamp = (0.0, room.floor_height + 0.8, 0.0)
    before = timing.counters()["launches.fused_trace_launch"]
    a = tm.fused_trace_counts(pscene, rng.PRNGKey(2), lamp, 1.0, 2 * PACKET, with_rays=True)
    b = tm.fused_trace_counts_reference(pscene, rng.PRNGKey(2), lamp, 1.0, 2 * PACKET, with_rays=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert timing.counters()["launches.fused_trace_launch"] == before  # the kernel did not run


def _soup(seed: int, t_count: int = 700):
    """A seeded triangle soup in a 6 m box, edges up to about 0.5 m."""
    g = np.random.default_rng(seed)
    centre = g.uniform(-3.0, 3.0, (t_count, 1, 3))
    return (centre + g.normal(scale=0.25, size=(t_count, 3, 3))).astype(np.float32)


@pytest.mark.parametrize("c_sz", [32, 64, 128])
def test_triangle_major_tiles_hold_the_jax_features(c_sz):
    """The layout the fused and the split kernel read: row k of triangle j of
    cluster l, tri_feat[l, j, k], is the four quantities feat[l, k, q * C + j]
    of the JAX scene, and box6 its AABB planes; tolerance 0, from the port's
    own build and from the JAX scene's arrays through scene_from_numpy."""
    tris = _soup(c_sz)
    jscene = jax_build_mxu_scene(jax_build_clusters(tris, cluster_size=c_sz))
    jfeat, jboxes = np.asarray(jscene.feat), np.asarray(jscene.boxes)
    l_count = jfeat.shape[0]
    want = jfeat[:, :tm.KROWS].reshape(l_count, tm.KROWS, 4, c_sz).transpose(0, 3, 1, 2)
    for scene in (tm.build_mxu_scene(build_clusters(tris, cluster_size=c_sz), device="cpu"),
                  tm.scene_from_numpy(jboxes, jfeat, np.asarray(jscene.tri_idx_flat), device="cpu")):
        assert scene.tri_feat.shape == (l_count, c_sz, tm.KROWS, 4) and scene.tri_feat.is_contiguous()
        np.testing.assert_array_equal(scene.tri_feat.numpy(), want)
        np.testing.assert_array_equal(scene.feat.numpy(), jfeat)
        np.testing.assert_array_equal(scene.box6.numpy().T, jboxes.swapaxes(1, 2).reshape(6, -1)[:, :l_count])
        # the slots in use: the cluster's real triangles, the padding behind them all zeros
        used = scene.tri_used.numpy()
        np.testing.assert_array_equal(used, (np.asarray(jscene.tri_idx_flat).reshape(l_count, c_sz) >= 0).sum(1))
        assert all((want[l, u:] == 0).all() for l, u in enumerate(used))
    assert (jfeat[:, tm.KROWS:] == 0).all()  # the rows the tiles leave out


@pytest.mark.parametrize("c_sz,seed", [(64, 0), (128, 1)])
def test_closest_hits_from_the_tiles_match_jax(scenes, room, c_sz, seed):
    """The fused kernel's leaf loop in plain torch, on its own tiles: for each
    triangle the four sums over the 10 rows of tri_feat, then the hit rule and
    the (t, slot) minimum. On rays made from a seed it finds what JAX's split
    kernel finds on them: slots on 99.9% of rays, t to rtol 1e-5 (the sums
    run in another order than the kernel's matrix product)."""
    jscene, scene = scenes[c_sz]
    g = np.random.default_rng(seed)
    n = PACKET
    lo, hi = room.tris.reshape(-1, 3).min(0), room.tris.reshape(-1, 3).max(0)
    o = (lo + (hi - lo) * g.uniform(0.3, 0.7, (n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jt, js, _ = (np.asarray(x) for x in jax_counts(jscene, jnp.asarray(o), jnp.asarray(d), interpret=True,
                                                   precision="highest"))
    rf = tm.ray_features(torch.from_numpy(o), torch.from_numpy(d))
    q = torch.zeros(n, scene.n_clusters * c_sz, 4)
    for k in range(tm.KROWS):  # row order, as the kernel accumulates
        q = q + scene.tri_feat[:, :, k].reshape(1, -1, 4) * rf[:, k, None, None]
    side, den = q[..., :3], q[..., :3].sum(-1)
    ok = (side.amin(-1) * side.amax(-1) >= 0.0) & (den.abs() >= 1e-5)
    t = q[..., 3] / torch.where(den == 0.0, 1.0, den)
    t = torch.where(ok & (t > 1e-4), t, torch.tensor(tm.BIG))
    pt, ps = t.min(1)
    ps = torch.where(pt >= tm._BIG32, -1, ps)
    assert (js >= 0).mean() > 0.9
    _assert_slots_agree(jt, js, pt.numpy(), ps.numpy().astype(np.int32))


def test_launch_shape_checks():
    """The TPU wrapper's packet fallback, and its alignment asserts as
    ValueError (uvtrace/ops/traverse_mxu.py:837-844)."""
    assert tm._launch_shape(6144, 4096, 4)[:2] == (2048, 3)
    assert tm._launch_shape(640, 1024, 4)[:2] == (640, 1)
    assert tm._launch_shape(1 << 20, 1024, 4) == (1024, 1024, (4, 16, 16))
    for n, packet in [(1000, 1024), (3 * 1024 + 64, 1024), (192, 1024)]:
        with pytest.raises(ValueError):
            tm._launch_shape(n, packet, 4)

