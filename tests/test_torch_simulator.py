"""The port's Simulator (on the CPU, through the plain versions of the
kernels) against the JAX Simulator (traversal="mxu-fused" or "mxu",
precision="highest", Pallas interpret mode) on the same scene, route and seed.
The port's traversal="pallas" (the gen-1 DFS) is held to JAX's "mxu" too:
JAX's own "pallas" backend calls its kernel without interpret mode, which
does not run on the CPU, and a closest hit does not depend on the backend.

Both packages draw the same photons (same keys, same generators); each slot
mismatch of the trace (a tie or an edge flip, test_torch_traverse_mxu.py)
moves one count between two triangles, so the maps may differ by at most
2 * duration per flipped ray, and flips are at most 0.1% of the rays. At
bounce depth >= 2 a flipped ray also shifts the coherence sort and re-pairs
later roulette draws, so deeper runs are compared by their totals (as
tests/test_bounce.py does).
"""

import os
import types
import warnings

import jax
import numpy as np
import pytest
import torch

import uvtrace.bvh.native
import uvtrace_torch.bvh.native
from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace.sim import ViewMode as JaxViewMode
from uvtrace_torch.io.routexml import LightPos, load_route_xml
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.sim import SimParams, Simulator, ViewMode
from uvtrace_torch.parallel import sharded_launch_fn
from uvtrace_torch.sim.launch import launch_counts
from uvtrace_torch.sim.simulator import from_jax_state
from uvtrace_torch.utils import timing

ROUTE = [(0.0, 0.0, 1.0), (1.0, -1.5, 2.0), (-1.2, 2.0, 0.5)]
# 7500 photons over 3 lamps: 2500 per lamp, rounded up to 3 chunks of 1024
PARAMS = dict(photon_count=7500, max_iterations=2, seed=3)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


def _jax_sim(room, traversal="mxu-fused", **kw):
    params = JaxSimParams(**{**PARAMS, **kw}, traversal=traversal, precision="highest")
    return JaxSimulator(room, params, route=[JaxLightPos(*w) for w in ROUTE], ray_chunk=1024)


def _port_sim(room, **kw):
    return Simulator(room, SimParams(**{**PARAMS, **kw}), route=[LightPos(*w) for w in ROUTE],
                     ray_chunk=1024, device="cpu")


def _flip_bound(sim):
    return 2 * max(w[2] for w in ROUTE) * 1e-3 * sim.photon_map_size


def _jax_state(js):
    return dict(photon_map=np.asarray(js.photon_map), max_photon_map=np.asarray(js.max_photon_map),
                photon_map_size=js.photon_map_size, _launch_n=js._launch_n,
                curr_iterations=js.curr_iterations,
                key=np.asarray(jax.random.key_data(js.key)).astype(np.uint32), global_seed=int(js.global_seed))


def _assert_sims_agree(js, ps, launch_n=3072):
    """launch_n: photons per lamp launch, 2500 rounded up to whole chunks of
    1024 for the stratified sampler, a masked tail for the iid samplers."""
    assert ps.photon_map_size == js.photon_map_size == 2 * 3 * launch_n
    assert ps._launch_n == js._launch_n == launch_n
    assert ps.curr_iterations == js.curr_iterations and ps.finished == js.finished
    np.testing.assert_array_equal(ps.key, np.asarray(jax.random.key_data(js.key)).astype(np.uint32))
    assert ps.global_seed == int(js.global_seed)
    for jmap, pmap in [(js.photon_map, ps.photon_map), (js.max_photon_map, ps.max_photon_map)]:
        jmap, pmap = np.asarray(jmap), pmap.numpy()
        assert np.abs(pmap - jmap).sum() <= _flip_bound(ps)
    same = np.asarray(js.max_photon_map) == ps.max_photon_map.numpy()
    same &= np.asarray(js.photon_map) == ps.photon_map.numpy()
    assert same.mean() > 0.9
    for jv, pv in [(JaxViewMode.DOSAGE, ViewMode.DOSAGE), (JaxViewMode.MAX_POWER, ViewMode.MAX_POWER)]:
        jd, pd = np.asarray(js.dosage_map(jv)), ps.dosage_map(pv).numpy()
        np.testing.assert_allclose(pd[same], jd[same], rtol=1e-6)
        assert np.isfinite(pd).all()


@pytest.fixture(scope="module")
def jax_run(room):
    js = _jax_sim(room)
    js.compute()
    return js


def test_simulator_matches_jax(room, jax_run):
    ps = _port_sim(room)
    dose = ps.compute()
    _assert_sims_agree(jax_run, ps)
    assert torch.equal(dose, ps.dosage_map(ViewMode.DOSAGE))
    assert ps.photon_map.sum() > 0


def test_from_jax_state_continues_a_jax_run(room, jax_run):
    """The JAX run's state after one iteration, continued by the port for the
    second, lands where the JAX run did."""
    js1 = _jax_sim(room, max_iterations=1)
    js1.compute()
    ps = _port_sim(room)
    from_jax_state(ps, _jax_state(js1))
    assert ps.curr_iterations == 1 and not ps.finished
    ps.compute()
    _assert_sims_agree(jax_run, ps)


def test_resume_equals_one_longer_run(room):
    a = _port_sim(room, max_iterations=1)
    a.compute()
    a.resume(extra_iterations=1)
    b = _port_sim(room)
    b.compute()
    assert a.photon_map_size == b.photon_map_size and a.curr_iterations == 2
    assert torch.equal(a.photon_map, b.photon_map) and torch.equal(a.max_photon_map, b.max_photon_map)
    np.testing.assert_array_equal(a.key, b.key)


def test_route_edit_and_io(room, tmp_path):
    ps = _port_sim(room)
    ps.add_lamp(0.5, 0.5, 3.0)
    ps.move_lamp(0, -0.25, 0.75)
    ps.delete_lamp(1)
    assert [(w.x, w.y, w.duration) for w in ps.route] == [(-0.25, 0.75, 1.0), (-1.2, 2.0, 0.5), (0.5, 0.5, 3.0)]
    assert ps.photons_per_light == JaxSimParams(**PARAMS).photons_per_light(3)
    ps.save_route(tmp_path / "r.xml")
    r = load_route_xml(tmp_path / "r.xml")
    assert r.waypoints == ps.route and r.photon_count == 7500
    other = _port_sim(room)
    other.load_route(tmp_path / "r.xml")
    assert other.route == ps.route and other.params == ps.params


@pytest.mark.parametrize("mode", [dict(texel_density=10.0, texel_max_slots=100)])
def test_unsupported_param_modes_raise(room, mode):
    """A texel budget below the triangle count is refused, as JAX refuses it
    (every triangle needs a texel)."""
    with pytest.raises(ValueError, match="triangle count"):
        JaxSimulator(room, JaxSimParams(**PARAMS, **mode))
    with pytest.raises(ValueError, match="triangle count"):
        _port_sim(room, **mode)


@pytest.mark.parametrize("call", ["bvh", "max_clusters", "device_mesh", "traversal", "jax_traversal", "onehot"])
def test_unported_members_raise(room, call, monkeypatch):
    """Members that once raised naming ROADMAP A4 and A5 now run and give
    JAX's maps bit for bit (both packages on the numpy builders): bvh= (JAX's
    numpy FlatBVH, the "jax" traversal), max_clusters= (the clustered
    traversal's first budget, escalated the same way), traversal="clustered"
    and "jax", and accumulate_method="onehot". device_mesh= is ported
    (tests/test_torch_parallel.py): a mesh whose axes are not ('rays',) or
    ('rays', 'texels') is refused with the axes it needs."""
    if call == "device_mesh":
        with pytest.raises(ValueError, match="'rays', 'texels'"):
            Simulator(room, SimParams(**PARAMS), device="cpu",
                      device_mesh=types.SimpleNamespace(mesh_dim_names=("data",)))
        return
    monkeypatch.setattr(uvtrace.bvh.native, "available", lambda: False)
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)
    from uvtrace.bvh.builder import build_bvh

    fields, kw = {"bvh": ({}, dict(bvh=build_bvh(room.tris, max_leaf_size=8))),
                  "max_clusters": (dict(traversal="clustered", sampler="native"),
                                   dict(max_clusters=2, cluster_size=32)),
                  "traversal": (dict(traversal="clustered"), {}), "jax_traversal": (dict(traversal="jax"), {}),
                  "onehot": (dict(traversal="clustered", accumulate_method="onehot"), {})}[call]
    fields = {**PARAMS, **fields, "max_iterations": 1, "photon_count": 3 * 1024}
    js = JaxSimulator(room, JaxSimParams(**fields), route=[JaxLightPos(*w) for w in ROUTE], ray_chunk=1024, **kw)
    ps = Simulator(room, SimParams(**fields), route=[LightPos(*w) for w in ROUTE], ray_chunk=1024, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # max_clusters=2 escalates in both
        js.compute()
        ps.compute()
    assert ps.backend == js.backend == {"bvh": "jax", "jax_traversal": "jax"}.get(call, "clustered")
    np.testing.assert_array_equal(ps.photon_map.numpy(), np.asarray(js.photon_map))
    if call == "max_clusters":
        assert ps._max_clusters == js._max_clusters > 2
    assert ps.photon_map.sum() > 0


def test_cluster_size_and_max_leaf_size(room):
    """cluster_size reaches the cluster builder (None: 128), B3 takes 128
    only, and max_leaf_size sizes the leaves of the "jax" traversal's fine
    BVH (the kernels' paths take it and build no fine BVH)."""
    assert _port_sim(room).scene.cluster_size == 128
    ps = Simulator(room, SimParams(**PARAMS, traversal="mxu"), cluster_size=64, max_leaf_size=4, device="cpu")
    assert ps.scene.cluster_size == 64
    ps.run_iteration()
    assert ps.photon_map.sum() > 0
    with pytest.raises(ValueError, match="128"):
        Simulator(room, SimParams(**PARAMS, traversal="pallas"), cluster_size=64, device="cpu")
    fine = Simulator(room, SimParams(**PARAMS, traversal="jax"), max_leaf_size=2, device="cpu")
    assert fine.bvh.max_leaf_size <= 2 and not hasattr(ps, "bvh")


@pytest.mark.parametrize("call", ["colors", "export_glb"])
def test_colors_and_export_glb_match_jax(room, jax_run, tmp_path, call):
    """From the JAX run's state: the per-triangle colours of every view (and
    the threshold view) equal JAX's, and the dose-coloured .glb has JAX's
    bytes."""
    ps = from_jax_state(_port_sim(room), _jax_state(jax_run))
    if call == "colors":
        for jv, pv in [(JaxViewMode.DOSAGE, ViewMode.DOSAGE), (JaxViewMode.MAX_POWER, ViewMode.MAX_POWER),
                       (JaxViewMode.TEXTURE, ViewMode.TEXTURE)]:
            for thr in (False, True):
                got = ps.colors(pv, thr)
                assert got.dtype == torch.float32 and got.shape == (room.triangle_count, 3)
                np.testing.assert_allclose(got.numpy(), np.asarray(jax_run.colors(jv, thr)), atol=1e-6, rtol=0)
    else:
        ps.export_glb(tmp_path / "port.glb", ViewMode.DOSAGE, True)
        jax_run.export_glb(tmp_path / "jax.glb", JaxViewMode.DOSAGE, True)
        assert (tmp_path / "port.glb").read_bytes() == (tmp_path / "jax.glb").read_bytes()


def test_default_device_is_cuda_and_raises_without_a_card(room, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(room, SimParams(**PARAMS), route=[LightPos(*w) for w in ROUTE])


def test_launch_counts_unsupported_shapes_raise(room):
    """A multi-device launch must split into whole chunks per device
    (parallel.sharded_launch_fn; launch_counts itself runs one rank's chunks
    from chunk_offset), an atlas needs its triangle geometry; a chunk count that is not whole runs with a masked tail, in
    both hit-id spaces. Without an atlas the texel counts are int32[1]
    zeros, and the overflow is always 0."""
    ps = _port_sim(room)
    kw = dict(t_count=room.triangle_count, chunk=1024, slot_map=ps._slot_map, **ps._trace)
    lamp = (0.0, room.floor_height + 0.8, 0.0)
    ray_mesh = types.SimpleNamespace(mesh_dim_names=("rays",), size=lambda i: 4)
    with pytest.raises(ValueError, match="multiple of n_devices"):
        sharded_launch_fn(ray_mesh, t_count=room.triangle_count, n_total=3 * 1024, chunk=1024, sampler="stratified",
                          **ps._trace)
    with pytest.raises(TypeError, match="device_mesh"):
        launch_counts(ps.scene, rng.PRNGKey(0), lamp, 1.0, n=1024, device_mesh=object(), **kw)
    atlas = _port_sim(room, texel_density=10.0).atlas
    with pytest.raises(ValueError, match="tri_v0"):
        launch_counts(ps.scene, rng.PRNGKey(0), lamp, 1.0, n=1024, atlas=atlas, n_texels=atlas.n_slots, **kw)
    with pytest.raises(ValueError, match="sampler"):
        launch_counts(ps.scene, rng.PRNGKey(0), lamp, 1.0, n=1024, sampler="sobol", **kw)
    for n in (2048, 1536):  # whole chunks (fused kernel), then a masked tail (split path)
        counts, tex, overflow = launch_counts(ps.scene, rng.PRNGKey(0), lamp, 1.0, n=n, **kw)
        assert counts.dtype == torch.int32 and counts.shape == (room.triangle_count,)
        assert int(counts.sum()) == n  # closed room
        assert torch.equal(tex, torch.zeros(1, dtype=torch.int32))
        assert overflow.dtype == torch.int32 and overflow.shape == () and int(overflow) == 0
    pallas = _port_sim(room, traversal="pallas")
    counts = launch_counts(pallas.scene, rng.PRNGKey(0), lamp, 1.0, t_count=room.triangle_count, n=1536,
                           chunk=1024, sampler="native", **pallas._trace)[0]
    assert int(counts.sum()) == 1536


@pytest.fixture(scope="module")
def jax_mxu_runs(room):
    """JAX runs on traversal="mxu" (precision "highest", Pallas interpret
    mode), one per sampler, each made on first use."""
    runs = {}

    def run(sampler):
        if sampler not in runs:
            runs[sampler] = _jax_sim(room, traversal="mxu", sampler=sampler)
            runs[sampler].compute()
        return runs[sampler]

    return run


@pytest.mark.parametrize("sampler,traversal", [("native", "pallas"), ("reference", "pallas"),
                                               ("stratified", "pallas"), ("native", "mxu"),
                                               ("reference", "mxu")])
def test_samplers_match_jax(room, jax_mxu_runs, sampler, traversal):
    """Each sampler through the gen-1 DFS (traversal="pallas", triangle-id
    space) and the iid samplers through the split kernel, against the JAX
    split path on the same photons: the stratified sampler rounds 2500
    photons per lamp up to 3 whole chunks, the iid samplers mask the last
    chunk's tail; the reference sampler advances the global seed after each
    launch and leaves the key alone. The maps agree within the flip bound."""
    js = jax_mxu_runs(sampler)
    ps = _port_sim(room, sampler=sampler, traversal=traversal)
    ps.compute()
    _assert_sims_agree(js, ps, launch_n=3072 if sampler == "stratified" else 2500)
    if sampler == "reference":
        assert ps.global_seed != 0
        np.testing.assert_array_equal(ps.key, rng.PRNGKey(PARAMS["seed"]))



def test_mxu_direct_path_matches_jax(room, jax_mxu_runs):
    """traversal="mxu": generate_stratified + the split kernel in counts mode,
    against the JAX split path."""
    js = jax_mxu_runs("stratified")
    ps = _port_sim(room, traversal="mxu")
    before = timing.counters()["launches.fused_trace_launch"]
    ps.compute()
    _assert_sims_agree(js, ps)
    assert timing.counters()["launches.fused_trace_launch"] == before


@pytest.mark.parametrize("traversal", ["mxu", "auto"])
def test_one_bounce_matches_jax(room, traversal):
    """Depth 1: the same photons, roulette draws and bounce directions (up to
    an ulp), so the maps agree within the flip bound."""
    kw = dict(max_bounces=1, reflectance=0.5, max_iterations=1)
    js = _jax_sim(room, traversal="mxu", **kw)
    js.compute()
    ps = _port_sim(room, traversal=traversal, **kw)
    ps.compute()
    jm, pm = np.asarray(js.photon_map), ps.photon_map.numpy()
    assert np.abs(pm - jm).sum() <= _flip_bound(ps)
    assert pm.sum() > 3 * 3072 * 1.2  # bounces deposited on top of the primaries


def test_four_bounces_total_matches_jax(room):
    kw = dict(max_bounces=4, reflectance=0.5, max_iterations=1)
    js = _jax_sim(room, traversal="mxu", **kw)
    js.compute()
    ps = _port_sim(room, traversal="mxu", **kw)
    ps.compute()
    direct = _port_sim(room, traversal="mxu", max_iterations=1)
    direct.compute()
    total, jax_total = float(ps.photon_map.sum()), float(np.asarray(js.photon_map).sum())
    assert abs(total - jax_total) <= 0.05 * jax_total
    assert total > float(direct.photon_map.sum())
    assert torch.isfinite(ps.dosage_map()).all()


def test_bounce_runs_are_deterministic_and_reflectance_is_settable(room):
    runs = []
    for _ in range(2):
        ps = _port_sim(room, max_bounces=4, reflectance=0.5, max_iterations=1)
        ps.compute()
        runs.append(ps.photon_map)
    assert torch.equal(runs[0], runs[1])
    dark = _port_sim(room, max_bounces=4, reflectance=0.5, max_iterations=1)
    dark.set_reflectance(np.zeros(room.triangle_count, np.float32))  # rho 0: roulette ends every path
    dark.compute()
    direct = _port_sim(room, traversal="mxu", max_iterations=1)  # bounces run the split path's photons
    direct.compute()
    assert torch.equal(dark.photon_map, direct.photon_map)


def _check_golden(name, sampler, traversal):
    """tests/golden/<name> (made by the JAX package's clustered CPU backend,
    an exact traversal, from the same photons) reproduced within the flip
    bound, in photon counts."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", name))
    room = make_box_room(subdivisions=4, clutter=2, seed=77, floor_y=-1.2)
    params = SimParams(photon_count=1 << 14, max_iterations=2, seed=1234, light_intensity=450.0,
                       sampler=sampler, traversal=traversal)
    route = [LightPos(0.3, -0.4, 45.0), LightPos(-0.6, 0.8, 30.0)]
    ps = Simulator(room, params, route=route, device="cpu")
    dose = ps.compute().numpy()
    pm = ps.photon_map.numpy()
    # dose = photon_map * c / area with one c per view: recover the golden's map
    hit = pm > 0
    c = float(np.median(dose[hit] * room.areas[hit] / pm[hit]))
    golden_pm = golden["dose"] * room.areas / c
    assert np.abs(pm - golden_pm).sum() <= 2 * 45.0 * 1e-3 * ps.photon_map_size
    assert np.isclose(dose, golden["dose"], rtol=1e-5).mean() > 0.9
    irr = ps.dosage_map(ViewMode.MAX_POWER).numpy()
    assert np.isclose(irr, golden["irr"], rtol=1e-5).mean() > 0.9
    return ps


def test_golden_stratified_dose_reproduced_by_the_split_path():
    _check_golden("box_room_dose_stratified.npz", "stratified", "mxu")


def test_golden_stratified_dose_reproduced_by_the_clustered_traversal():
    """The traversal that made the golden: every dose and irradiance within
    tests/test_golden.py's rtol 1e-6 (atol 1e-8), besides _check_golden."""
    ps = _check_golden("box_room_dose_stratified.npz", "stratified", "clustered")
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "box_room_dose_stratified.npz"))
    np.testing.assert_allclose(ps.dosage_map().numpy(), golden["dose"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ps.dosage_map(ViewMode.MAX_POWER).numpy(), golden["irr"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("traversal", ["pallas", "mxu", "clustered"])
def test_golden_native_dose_reproduced(traversal):
    """tests/golden/box_room_dose.npz (sampler "native": 8192 iid photons per
    lamp in one chunk) through the gen-1 DFS, the split kernel and the
    clustered traversal."""
    ps = _check_golden("box_room_dose.npz", "native", traversal)
    assert ps.photon_map_size == 2 * 2 * 8192
    if traversal == "clustered":  # the golden's own traversal: within tests/test_golden.py's rtol 1e-6
        golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "box_room_dose.npz"))
        np.testing.assert_allclose(ps.dosage_map().numpy(), golden["dose"], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ps.dosage_map(ViewMode.MAX_POWER).numpy(), golden["irr"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("sampler,traversal", [("stratified", "auto"), ("native", "pallas"),
                                               ("reference", "pallas"), ("native", "clustered")])
def test_calibrate_power_matches_jax(room, sampler, traversal):
    """calibrate_power on the same synthetic square, with the same photons
    (JAX on mxu-fused, which runs the iid samplers through the split path):
    the per-launch mean doses are sums over the same hits, so the wattage is
    expected equal up to f32 rounding; rtol 1e-5. Each launch is 8192 photons
    in 8 chunks of 1024, at most 4 launches. The calibration's own Simulator
    keeps the session's traversal (the clustered one too)."""
    kw = dict(photon_count=1 << 13, max_iterations=4, seed=7, sampler=sampler)
    js = JaxSimulator(room, JaxSimParams(**kw, traversal="mxu-fused", precision="highest"), ray_chunk=1024)
    want = js.calibrate_power(2909.0, 0.8, 0.5)
    ps = Simulator(room, SimParams(**kw, traversal=traversal), ray_chunk=1024, device="cpu")
    got = ps.calibrate_power(2909.0, 0.8, 0.5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ps.params.light_intensity == got and np.isfinite(got) and got > 0
    assert ps._make_calibration_sim(0.8, 0.5, 1024).backend == ps.backend


@pytest.mark.parametrize("skip_ceiling", [True, False])
def test_dose_grid_matches_jax(room, skip_ceiling, monkeypatch):
    """dose_grid(res=32) from the same dose map (from_jax_state): equal but on
    probes whose first hit is a t-tie between clusters (the JAX kernel keeps
    the first visited cluster, the port the lowest slot). Both Simulators
    are held to the numpy cluster builder, so that both index the same slots
    (the JAX native builder's cluster order changes from build to build)."""
    monkeypatch.setattr(uvtrace.bvh.native, "available", lambda: False)
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)
    js = _jax_sim(room, traversal="mxu", max_iterations=1)
    js.compute()
    ps = from_jax_state(_port_sim(room, max_iterations=1), _jax_state(js))
    np.testing.assert_array_equal(np.asarray(js.scene.tri_idx_flat), ps.scene.tri_idx_flat.numpy())
    jg = js.dose_grid(res=32, skip_ceiling=skip_ceiling)
    ties = []

    def record_ties(o, d):  # which probes have t-ties across clusters
        t, slot, t_cl = tm.closest_hits(ps.scene, tm.ray_features(o, d), per_cluster=True)
        ties.append(((t_cl == t[:, None]) & (t[:, None] < tm.BIG)).sum(1) > 1)
        return t, slot

    from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays

    verts = room.tris.reshape(-1, 3)
    o, d = probe_rays(verts.min(0), verts.max(0), 32)
    first_hits_skip_ceiling(record_ties, o, d, float(verts.min(0)[1]), float(verts.max(0)[1]),
                            skip_ceiling=skip_ceiling)
    tie = torch.stack(ties).any(0).numpy().reshape(32, 32)
    pg = ps.dose_grid(res=32, skip_ceiling=skip_ceiling)
    assert pg.shape == (32, 32) and pg.dtype == np.float32 and np.isfinite(pg).all()
    assert ((pg != jg) <= tie).all() and tie.mean() < 0.05
    assert (pg > 0).mean() > 0.5
    with pytest.raises(ValueError, match="texel_density"):  # texels=True without an atlas, as in JAX
        ps.dose_grid(res=8, texels=True)
