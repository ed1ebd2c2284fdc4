"""The port's clustered traversal (uvtrace_torch/ops/traverse_clustered.py),
the Simulator's "clustered" traversal with its budget audit (launches,
probes, two gloo ranks) and the testroom golden, against the JAX package on
the CPU (uvtrace/ops/traverse_clustered.py, plain jnp, run as its own tests
run it).

Both sides take the same numpy clusters (the numpy builder: JAX's native one
orders its clusters differently from build to build) and the same numpy
rays. The JAX module is plain jnp on the CPU and the port plain torch with
the same f32 operations, so t is held bit-equal and hit ids and overflows
equal, budgets that drop clusters included; Simulator maps bit-equal.
"""

import dataclasses
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvtrace.bvh.native
import uvtrace_torch.bvh.native
from tests.test_torch_parallel import one_thread, spawn_ranks
from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.ops import traverse_clustered as J
from uvtrace.ops.cluster import ClusteredScene, build_clusters
from uvtrace.ops.generate import generate_native, generate_stratified
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import traverse_clustered as P
from uvtrace_torch.sim import SimParams, Simulator, ViewMode

ROUTE = [(0.0, 0.0, 1.0), (1.0, -1.5, 2.0)]


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=3, seed=1)  # 222 triangles


@pytest.fixture(scope="module")
def clusters16(room):
    return build_clusters(room.tris, cluster_size=16)  # 18 clusters


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    """Both Simulators cluster with the numpy builder (same cluster order)."""
    monkeypatch.setattr(uvtrace.bvh.native, "available", lambda: False)
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)


def _rays(kind: str, n: int, seed: int = 5):
    if kind == "coherent":
        rays = generate_stratified(jax.random.PRNGKey(seed), n, (0.0, 0.2, 0.0), 1.0, packet=1024)
    else:
        rays = generate_native(jax.random.PRNGKey(seed), n, (0.2, 0.1, -0.3), 1.0)
    return np.array(rays.orig), np.array(rays.dir)


def _both(cs, o, d, **kw):
    """((t, hit, overflow) of JAX, (t, hit, overflow) of the port)."""
    jt, jh, jo = J.traverse_clustered(J.cluster_arrays(cs), jnp.asarray(o), jnp.asarray(d), return_overflow=True,
                                      **kw)
    pt, ph, po = P.traverse_clustered(P.cluster_arrays(cs, device="cpu"), torch.from_numpy(o), torch.from_numpy(d),
                                      return_overflow=True, **kw)
    assert pt.dtype == torch.float32 and ph.dtype == torch.int32 and po.dtype == torch.int32
    return (np.asarray(jt), np.asarray(jh), int(jo)), (pt.numpy(), ph.numpy(), int(po))


def _assert_equal(j, p):
    np.testing.assert_array_equal(p[0], j[0])  # t bit-equal
    np.testing.assert_array_equal(p[1], j[1])
    assert p[2] == j[2]


@pytest.mark.parametrize("budget", [1, 2, 8, "all"])
@pytest.mark.parametrize("kind", ["coherent", "incoherent"])
def test_traverse_clustered_matches_jax(clusters16, kind, budget):
    """Stratified packets and iid rays at budgets that drop clusters (1, 2,
    8) and at the cluster count (exact, no overflow)."""
    k = clusters16.n_clusters if budget == "all" else budget
    j, p = _both(clusters16, *_rays(kind, 4096), max_clusters=k)
    _assert_equal(j, p)
    assert (p[2] == 0) == (budget == "all")
    assert (p[1] >= 0).mean() > (0.99 if budget == "all" else 0.2)


@pytest.mark.parametrize("n", [3000, 17 * 1024 + 5])
def test_ray_count_not_a_whole_packet(room, n):
    """R padded to whole packets (3000 -> 3 packets) and, past one group of
    16 packets, to whole groups (17 packets + 5 rays -> 32): the dummy rays
    count in their packets' overflow, as in JAX."""
    cs = build_clusters(room.tris, cluster_size=32)
    j, p = _both(cs, *_rays("incoherent", n), max_clusters=2)
    _assert_equal(j, p)
    assert p[0].shape == (n,) and p[2] > 0


def test_tied_cluster_entries(clusters16):
    """Entry distances that tie: every cluster twice (equal boxes, equal
    entries, the second copy's triangle ids shifted by 1000, so a hit tells
    which copy won the argmin), and rays that start on box corners (entries
    of +0 and -0, which XLA's top_k orders -0 first). The port selects and
    reports as lax.top_k and argmin do."""
    cs = clusters16
    twice = ClusteredScene(tris=np.concatenate([cs.tris, cs.tris]), box_min=np.concatenate([cs.box_min, cs.box_min]),
                           box_max=np.concatenate([cs.box_max, cs.box_max]),
                           tri_idx=np.concatenate([cs.tri_idx, np.where(cs.tri_idx >= 0, cs.tri_idx + 1000, -1)]))
    o, d = _rays("incoherent", 2048)
    corner = o.copy()
    corner[:1024] = cs.box_min[3]
    corner[1024:] = cs.box_max[5]
    for orig in (o, corner):
        for k in (1, twice.n_clusters):
            j, p = _both(twice, orig, d, max_clusters=k)
            _assert_equal(j, p)
    entries = P._packet_entries(torch.from_numpy(corner).view(2, 1024, 3),
                                P.safe_inv_dir(torch.from_numpy(d).view(2, 1024, 3)), P.cluster_arrays(cs, "cpu"))
    assert bool(((entries == 0) & torch.signbit(entries)).any())  # a -0 entry was ordered
    assert (p[1] >= 0).any() and (p[1] < 1000).all()  # equal t: the first copy, the lower cluster index


@pytest.mark.parametrize("group", [1, 4, 16])
def test_group_and_batch_change_no_value(clusters16, group, monkeypatch):
    """`group` sets the padding (and so the overflow) as in JAX, and no t or
    hit; the port's batch of packets, from PLANE_BYTES, changes nothing."""
    o, d = _rays("incoherent", 5 * 1024 + 100)
    j, p = _both(clusters16, o, d, max_clusters=2, group=group)
    _assert_equal(j, p)
    ref = P.traverse_clustered(P.cluster_arrays(clusters16, "cpu"), torch.from_numpy(o), torch.from_numpy(d),
                               max_clusters=2, group=16)
    np.testing.assert_array_equal(p[0], ref[0].numpy())
    np.testing.assert_array_equal(p[1], ref[1].numpy())
    monkeypatch.setattr(P, "PLANE_BYTES", 1)  # one packet a batch
    small = P.traverse_clustered(P.cluster_arrays(clusters16, "cpu"), torch.from_numpy(o), torch.from_numpy(d),
                                 max_clusters=2, group=group, return_overflow=True)
    np.testing.assert_array_equal(small[0].numpy(), p[0])
    np.testing.assert_array_equal(small[1].numpy(), p[1])
    assert int(small[2]) == p[2]


def test_cluster_arrays_match_jax(clusters16):
    ja, pa = J.cluster_arrays(clusters16), P.cluster_arrays(clusters16, device="cpu")
    for name in ja._fields:
        np.testing.assert_array_equal(getattr(pa, name).numpy(), np.asarray(getattr(ja, name)))
    assert pa.n_clusters == clusters16.n_clusters


# ---------------------------------------------------------------- Simulator


def _params(**kw):
    return dict(dict(photon_count=2 * 3000, max_iterations=1, seed=3, traversal="clustered"), **kw)


def _run_both(room, cluster_size=16, max_clusters=None, ray_chunk=1024, **kw):
    """(JAX Simulator, port Simulator) after compute() of the same run;
    every RuntimeWarning either raised is returned with them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        js = JaxSimulator(room, JaxSimParams(**_params(**kw)), route=[JaxLightPos(*w) for w in ROUTE],
                          ray_chunk=ray_chunk, cluster_size=cluster_size, max_clusters=max_clusters)
        js.compute()
        n_jax = len(caught)
        ps = Simulator(room, SimParams(**_params(**kw)), route=[LightPos(*w) for w in ROUTE], ray_chunk=ray_chunk,
                       cluster_size=cluster_size, max_clusters=max_clusters, device="cpu")
        ps.compute()
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    return js, ps, warned[:n_jax], warned[n_jax:]


@pytest.mark.parametrize("case", ["stratified", "native", "reference", "bounces", "budget_4"])
def test_simulator_clustered_matches_jax(room, case):
    """Photon maps bit-equal to JAX's clustered Simulator, with the same
    first budget (the sampler-aware 32 / 512 of uvtrace/sim/simulator.py:
    226-240, capped at the cluster count, or max_clusters) and the same
    escalations."""
    kw = dict(stratified=dict(), native=dict(sampler="native"), reference=dict(sampler="reference"),
              bounces=dict(max_bounces=2, reflectance=0.5), budget_4=dict(sampler="native"))[case]
    js, ps, jw, pw = _run_both(room, max_clusters=4 if case == "budget_4" else None, **kw)
    np.testing.assert_array_equal(ps.photon_map.numpy(), np.asarray(js.photon_map))
    np.testing.assert_array_equal(ps.max_photon_map.numpy(), np.asarray(js.max_photon_map))
    assert ps.backend == js.backend == "clustered" and ps._max_clusters == js._max_clusters
    assert pw == jw and (len(pw) > 0) == (case == "budget_4")
    assert ps.photon_map_size == js.photon_map_size and ps.photon_map.sum() > 0


def test_budget_escalates_to_the_budget_free_counts(room):
    """tests/test_pipeline.py:210-235 mirrored: iid packets through a
    1-cluster budget warn, escalate (x 4) and redo the launch with the same
    photons until nothing is dropped; the counts equal the budget-free "jax"
    traversal's and JAX's escalated run's."""
    params = dict(photon_count=2048, max_iterations=1, sampler="native", traversal="clustered")
    sim = Simulator(room, SimParams(**params), ray_chunk=1024, max_clusters=1, cluster_size=16, device="cpu")
    with pytest.warns(RuntimeWarning, match="budget") as rec:
        sim.run_iteration()
    assert sim._max_clusters > 1 and "retrying with budget 4" in str(rec[0].message)
    free = Simulator(room, SimParams(**dict(params, traversal="jax")), ray_chunk=1024, device="cpu")
    free.run_iteration()
    np.testing.assert_array_equal(sim.photon_map.numpy(), free.photon_map.numpy())
    js = JaxSimulator(room, JaxSimParams(**params), ray_chunk=1024, max_clusters=1, cluster_size=16)
    with pytest.warns(RuntimeWarning, match="budget"):
        js.run_iteration()
    np.testing.assert_array_equal(sim.photon_map.numpy(), np.asarray(js.photon_map))
    assert sim._max_clusters == js._max_clusters
    sim._max_clusters = sim._l_count  # a drop at the full budget cannot happen: it raises
    with pytest.raises(RuntimeError, match="maximum budget"):
        sim._escalate_cluster_budget(1)


def test_probe_audit_matches_jax(room):
    """dose_grid's probe packets are slabs of the room: at a 4-cluster budget
    both packages escalate while tracing the probes and give the same grid,
    equal to the budget-free "jax" traversal's from the same map."""
    js, ps, _, _ = _run_both(room, max_clusters=64)
    js._max_clusters = 4
    js._extend = functools.partial(J.traverse_clustered, max_clusters=4, return_overflow=True)
    ps._set_cluster_budget(4)
    with pytest.warns(RuntimeWarning, match="budget"):
        jg = js.dose_grid(res=16)
    with pytest.warns(RuntimeWarning, match="budget"):
        pg = ps.dose_grid(res=16)
    np.testing.assert_array_equal(pg, jg)
    assert ps._max_clusters == js._max_clusters > 4
    free = Simulator(room, SimParams(**_params(traversal="jax")), route=[LightPos(*w) for w in ROUTE],
                     ray_chunk=1024, device="cpu")
    free.photon_map = ps.photon_map
    free.photon_map_size = ps.photon_map_size
    np.testing.assert_array_equal(free.dose_grid(res=16), pg)
    assert (pg > 0).mean() > 0.5


@pytest.mark.parametrize("sampler", ["stratified", "native"])
def test_clustered_through_the_other_histogram(room, sampler):
    """accumulate_method="onehot" (f32 one-hot sums over 2048-ray tiles)
    gives JAX's maps through the clustered traversal."""
    js, ps, _, _ = _run_both(room, accumulate_method="onehot", sampler=sampler)
    np.testing.assert_array_equal(ps.photon_map.numpy(), np.asarray(js.photon_map))


N_RANKS = 1 << 13  # photons per lamp: 8 chunks of 1024, whole chunks on 2 ranks


def _ranks_params():
    return SimParams(photon_count=N_RANKS * len(ROUTE), max_iterations=1, seed=3, sampler="native",
                     traversal="clustered")


def _escalating_rank(rank, world):
    """One rank of a 2-rank ray mesh: the clustered Simulator at a 1-cluster
    budget (launches and probes escalate together) and the clustered diff
    scene's visibility."""
    from uvtrace_torch import diff as D
    from uvtrace_torch.parallel import make_ray_mesh

    uvtrace_torch.bvh.native.available = lambda: False  # the numpy builder's clusters, as the reference's
    mesh = make_ray_mesh()
    room = make_box_room(subdivisions=4, clutter=3, seed=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = Simulator(room, _ranks_params(), route=[LightPos(*w) for w in ROUTE], ray_chunk=1024,
                        max_clusters=1, cluster_size=16, device_mesh=mesh, device="cpu")
        sim.compute()
        launch_budget = sim._max_clusters
        sim._set_cluster_budget(1)
        grid = sim.dose_grid(res=16)
    scene = D.make_diff_scene(room, backend="clustered", device_mesh=mesh, device="cpu")
    irr = D.irradiance(scene, [0.3, -0.4], room.floor_height + 0.8, 1.0, 450.0, np.array([0, 5], np.uint32),
                       n_samples=3)
    return dict(map=sim.photon_map.numpy(), budget=launch_budget, grid_budget=sim._max_clusters, grid=grid,
                warnings=[str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)],
                irr=irr.numpy())


def test_two_gloo_ranks_escalate_together(room, tmp_path):
    """On 2 gloo ranks the overflow is all_reduced: both ranks warn, escalate
    and redo every launch and probe batch together (a rank alone would hang
    the other in a collective), and end with one device's maps, budget and
    grid; the clustered shadow rays, padded and all_gathered, give one
    device's irradiance."""
    from uvtrace_torch import diff as D

    out = spawn_ranks(_escalating_rank, 2, tmp_path)
    with one_thread(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = Simulator(room, _ranks_params(), route=[LightPos(*w) for w in ROUTE], ray_chunk=1024, max_clusters=1,
                        cluster_size=16, device="cpu")
        one.compute()
        budget = one._max_clusters
        one._set_cluster_budget(1)
        grid = one.dose_grid(res=16)
        irr = D.irradiance(D.make_diff_scene(room, backend="clustered", device="cpu"), [0.3, -0.4],
                           room.floor_height + 0.8, 1.0, 450.0, np.array([0, 5], np.uint32), n_samples=3)
    assert len(caught) > 1
    for rank in out:
        np.testing.assert_array_equal(rank["map"], one.photon_map.numpy())
        np.testing.assert_array_equal(rank["grid"], grid)
        np.testing.assert_array_equal(rank["irr"], irr.numpy())
        assert rank["budget"] == budget > 1 and rank["grid_budget"] == one._max_clusters > 1
        assert len(rank["warnings"]) == len(out[0]["warnings"]) > 1


@pytest.mark.slow  # about 2 min on the CPU: 12 waypoints and 2^16 probes at budgets up to 512
def test_golden_testroom_scene_through_the_clustered_traversal():
    """tests/golden/testroom_dose.npz, made by the JAX package's clustered
    CPU backend (tests/test_golden.py:57-87): the shipped scene and route,
    2^14 stratified photons, seed 1234; the dose, the peak irradiance and
    the 256^2 dose grid, within JAX's own test's rtol 1e-6, atol 1e-8."""
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.io.routexml import load_route_xml

    assets = os.path.join(os.path.dirname(__file__), "..", "assets")
    mesh = load_glb(os.path.join(assets, "testroomopt.glb"))
    r = load_route_xml(os.path.join(assets, "route.xml"))
    params = dataclasses.replace(
        r.apply_to(SimParams(photon_count=1 << 14, max_iterations=2, seed=1234, light_intensity=450.0,
                             sampler="stratified")),
        photon_count=1 << 14, max_iterations=1, seed=1234, traversal="clustered")
    sim = Simulator(mesh, params, route=r.waypoints, device="cpu")
    sim.compute()
    ref = np.load(os.path.join(os.path.dirname(__file__), "golden", "testroom_dose.npz"))
    np.testing.assert_allclose(sim.dosage_map(ViewMode.DOSAGE).numpy(), ref["dose"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sim.dosage_map(ViewMode.MAX_POWER).numpy(), ref["irr"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(sim.dose_grid(res=256), ref["grid"], rtol=1e-6, atol=1e-8)
