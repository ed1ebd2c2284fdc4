"""The port's split path against the JAX package: `generate_stratified`, the
split trace (`traverse_mxu_slots` / `_counts` / `traverse_mxu`, the wrappers
of TPU kernel B2) and `hit_counts`.

JAX runs its Pallas kernel in interpret mode at precision="highest" (f32), as
its own tests do on the CPU; the port runs the plain PyTorch version (the
wrapper's CPU route). Both get the same rays, made with numpy from a seed.
Tolerances, with their reasons:
  - origins and dir.y of generate_stratified come from threefry bits and f32
    arithmetic only: bit-equal; dir.x/z go through cos/sin, whose XLA-CPU and
    torch versions differ by an ulp: within 2 ulp of 1 (2.4e-7);
  - slots agree on at least 99.9% of rays; a differing slot is a tie or an
    edge flip of f32 sums taken in another order, so its t still agrees to
    rtol 1e-5 (JAX breaks t-ties across clusters by visit order, the port by
    the lowest slot); counts move by at most one per differing slot, so they
    agree within twice the mismatches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops.accumulate import hit_counts as jax_hit_counts
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.generate import generate_stratified as jax_generate_stratified
from uvtrace.ops.probes import probe_rays as jax_probe_rays
from uvtrace.ops.traverse_mxu import build_mxu_scene as jax_build_mxu_scene
from uvtrace.ops.traverse_mxu import traverse_mxu as jax_traverse_mxu
from uvtrace.ops.traverse_mxu import traverse_mxu_counts as jax_counts
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops.accumulate import hit_counts
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.generate import generate_stratified
from uvtrace_torch.utils import timing

TWO_ULP_OF_ONE = 2 * float(np.spacing(np.float32(1)))


def _key_words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


@pytest.mark.parametrize("seed,gi,n,packet,lamp", [
    (0, 0, 4096, 1024, (0.0, -0.6, 0.0)),
    (7, 2**31 + 1, 1 << 16, 1024, (0.3, -0.2, 1.1)),
    (3, 5, 8192, 4096, (-1.5, 0.4, 2.0)),
    (11, 3, 35 * 1024, 1024, (0.2, -0.9, -0.4)),  # a (1, 5, 7) grid: divisions that are not exact
])
def test_generate_stratified_matches_jax(seed, gi, n, packet, lamp):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gi)
    j = jax_generate_stratified(key, n, np.array(lamp, np.float32), 1.0, packet=packet)
    p = generate_stratified(_key_words(key), n, lamp, 1.0, packet=packet)
    jo, jd = np.asarray(j.orig), np.asarray(j.dir)
    assert p.count == n and p.orig.dtype == torch.float32
    np.testing.assert_array_equal(p.orig.numpy(), jo)
    np.testing.assert_array_equal(p.dir.numpy()[:, 1], jd[:, 1])
    np.testing.assert_allclose(p.dir.numpy(), jd, rtol=0, atol=TWO_ULP_OF_ONE)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


@pytest.fixture(scope="module")
def scenes(room):
    """32-triangle clusters, so that the packet frustum has clusters to cull."""
    return (jax_build_mxu_scene(jax_build_clusters(room.tris, cluster_size=32)),
            tm.build_mxu_scene(build_clusters(room.tris, cluster_size=32), device="cpu"))


def _rays(kind: str, room, n: int):
    """f32[n, 3] origins and directions, made with numpy from a seed."""
    g = np.random.default_rng(11)
    lo, hi = room.tris.reshape(-1, 3).min(0), room.tris.reshape(-1, 3).max(0)
    if kind == "stratified":
        r = jax_generate_stratified(jax.random.PRNGKey(4), n, np.array([0.1, room.floor_height + 0.8, -0.2],
                                                                        np.float32), 1.0)
        return np.array(r.orig), np.array(r.dir)
    if kind == "probes":  # a 48 x 48 grid padded with parked probes to 3 packets
        o, d = jax_probe_rays(lo, hi, 48, pad=n - 48 * 48)
        return np.array(o), np.array(d)
    o = (lo + (hi - lo) * g.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if kind == "parked":  # bounce rays: a mixed packet, then an all-dead one
        dead = np.zeros(n, bool)
        dead[g.uniform(size=n) < 0.3] = True
        dead[1024:2048] = True
        o[dead] = 1e6
        d[dead] = (1.0, 0.0, 0.0)
    return o, d


CASES = [  # (ray kind, n, packet asked for)
    ("stratified", 4096, 1024),
    ("stratified", 8192, 4096),
    ("incoherent", 6144, 4096),  # falls back to 2048-ray packets
    ("incoherent", 4096, 1024),
    ("parked", 4096, 1024),
    ("probes", 3072, 1024),
]


@pytest.mark.parametrize("kind,n,packet", CASES)
def test_split_trace_matches_jax(scenes, room, kind, n, packet):
    jscene, pscene = scenes
    o, d = _rays(kind, room, n)
    jt, js, jc = (np.asarray(x) for x in jax_counts(jscene, jnp.asarray(o), jnp.asarray(d), interpret=True,
                                                    precision="highest", packet=packet))
    po, pd = torch.from_numpy(o), torch.from_numpy(d)
    pt, ps, pc = (x.numpy() for x in tm.traverse_mxu_counts(pscene, po, pd, packet=packet))
    st, ss = (x.numpy() for x in tm.traverse_mxu_slots(pscene, po, pd, packet=packet))
    np.testing.assert_array_equal(st, pt)
    np.testing.assert_array_equal(ss, ps)
    assert pt.dtype == np.float32 and ps.dtype == np.int32 and pc.shape == jc.shape
    mism = js != ps
    assert mism.mean() <= 1e-3, f"{mism.sum()} slot mismatches of {n}"
    np.testing.assert_allclose(pt, jt, rtol=1e-5)
    assert ((ps < 0) == (pt >= tm.BIG)).all()
    assert np.abs(pc.astype(np.int64) - jc).sum() <= 2 * int(mism.sum())
    assert pc.sum() == (ps >= 0).sum()


def test_parked_packets_cull_and_mixed_packets_are_exact(scenes, room):
    """An all-dead packet (every lane parked at 1e6 looking along +x) makes
    no (ray, leaf) or (ray, triangle) test and misses; a packet that mixes
    parked and live lanes gives the brute-force result on every lane, and
    its live rays test at most every leaf and every triangle each."""
    _, pscene = scenes
    o, d = (torch.from_numpy(a) for a in _rays("parked", room, 4096))
    t, slot, visits, tri_visits = tm.traverse_mxu_padded(pscene, o, d, with_visits=True)
    assert visits[1] == 0 and tri_visits[1] == 0 and (slot[1024:2048] == -1).all()
    live = (o != 1e6).any(1).view(-1, 1024).sum(1)
    n_leaves = int((pscene.walk_meta.view(-1, 2)[:, 1] >= 0).sum())
    assert visits[0] > 0 and (visits <= live * n_leaves).all()
    assert (visits <= tri_visits).all() and (tri_visits <= live * room.triangle_count).all()
    bt, bs = tm.closest_hits(pscene, tm.ray_features(o, d))
    assert torch.equal(t, bt) and torch.equal(slot, bs)


def test_traverse_mxu_returns_triangle_ids(scenes, room):
    jscene, pscene = scenes
    o, d = _rays("incoherent", room, 2048)
    jt, jh = (np.asarray(x) for x in jax_traverse_mxu(jscene, jnp.asarray(o), jnp.asarray(d), interpret=True,
                                                      precision="highest"))
    pt, ph = (x.numpy() for x in tm.traverse_mxu(pscene, torch.from_numpy(o), torch.from_numpy(d)))
    assert (jh != ph).mean() <= 1e-3 and ph.max() < room.triangle_count
    np.testing.assert_allclose(pt, jt, rtol=1e-5)


def test_split_wrapper_on_cpu_runs_the_plain_version(scenes, room):
    _, pscene = scenes
    o, d = (torch.from_numpy(a) for a in _rays("incoherent", room, 2048))
    before = timing.counters()["launches.traverse_mxu_launch"]
    a = tm.traverse_mxu_padded(pscene, o, d, with_counts=True, with_visits=True)
    b = tm.traverse_mxu_padded_reference(pscene, o, d, with_counts=True, with_visits=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 5
    assert timing.counters()["launches.traverse_mxu_launch"] == before  # the kernel did not run
    with pytest.raises(ValueError):
        tm.traverse_mxu_slots(pscene, o[:1000], d[:1000])  # not whole 128-ray packets


@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_counts_onehot_matches_jax(n):
    """The one-hot histogram (f32 sums over 2048-ray tiles, the last tile
    padded) against JAX's counts_onehot, and equal to the index_add_ one."""
    from uvtrace.ops.accumulate import counts_onehot as jax_counts_onehot
    from uvtrace_torch.ops.accumulate import counts_onehot

    ids = np.random.default_rng(n).integers(-3, 300, n).astype(np.int32)
    got = counts_onehot(torch.from_numpy(ids), 300)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_counts_onehot(jnp.asarray(ids), 300)))
    assert torch.equal(got, hit_counts(torch.from_numpy(ids), 300, "onehot"))
    assert torch.equal(got, hit_counts(torch.from_numpy(ids), 300))
    with pytest.raises(ValueError, match="method"):
        hit_counts(torch.from_numpy(ids), 300, "scatter")


@pytest.mark.parametrize("num_bins", [1, 37, 500])
def test_hit_counts_matches_jax(num_bins):
    ids = np.random.default_rng(num_bins).integers(-3, num_bins, 5000).astype(np.int32)
    got = hit_counts(torch.from_numpy(ids), num_bins)
    assert got.dtype == torch.int32
    for method in ("segment", "sort"):
        want = np.asarray(jax_hit_counts(jnp.asarray(ids), num_bins, method))
        np.testing.assert_array_equal(got.numpy(), want)
