"""The port's Simulator (on the CPU, through the plain version of the fused
kernel) against the JAX Simulator (traversal="mxu-fused", precision="highest",
Pallas interpret mode) on the same scene, route and seed.

Both packages draw the same photons (same keys, same generator); each slot
mismatch of the trace (a tie or an edge flip, test_torch_traverse_mxu.py)
moves one count between two triangles, so the maps may differ by at most
2 * duration per flipped ray, and flips are at most 0.1% of the rays.
"""

import jax
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace.sim import ViewMode as JaxViewMode
from uvtrace_torch.io.routexml import LightPos, load_route_xml
from uvtrace_torch.ops import rng
from uvtrace_torch.sim import SimParams, Simulator, ViewMode
from uvtrace_torch.sim.launch import launch_counts
from uvtrace_torch.sim.simulator import from_jax_state

ROUTE = [(0.0, 0.0, 1.0), (1.0, -1.5, 2.0), (-1.2, 2.0, 0.5)]
# 7500 photons over 3 lamps: 2500 per lamp, rounded up to 3 chunks of 1024
PARAMS = dict(photon_count=7500, max_iterations=2, seed=3)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


def _jax_sim(room, **kw):
    params = JaxSimParams(**{**PARAMS, **kw}, traversal="mxu-fused", precision="highest")
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
                key=np.asarray(jax.random.key_data(js.key)).astype(np.uint32))


def _assert_sims_agree(js, ps):
    assert ps.photon_map_size == js.photon_map_size == 2 * 3 * 3072
    assert ps._launch_n == js._launch_n == 3072
    assert ps.curr_iterations == js.curr_iterations and ps.finished == js.finished
    np.testing.assert_array_equal(ps.key, np.asarray(jax.random.key_data(js.key)).astype(np.uint32))
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


@pytest.mark.parametrize("mode", [
    dict(sampler="native"), dict(sampler="reference"), dict(max_bounces=1, reflectance=0.5),
    dict(texel_density=10.0),
])
def test_unsupported_param_modes_raise(room, mode):
    ps = _port_sim(room, **mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ps.run_iteration()


@pytest.mark.parametrize("call", ["dose_grid", "calibrate_power", "colors", "export_glb", "traversal"])
def test_unported_members_raise(room, call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "traversal":
            _port_sim(room, traversal="clustered")
        else:
            getattr(_port_sim(room), call)()


def test_default_device_is_cuda_and_raises_without_a_card(room, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(room, SimParams(**PARAMS), route=[LightPos(*w) for w in ROUTE])


def test_launch_counts_unsupported_shapes_raise(room):
    ps = _port_sim(room)
    kw = dict(t_count=room.triangle_count, chunk=1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_counts(ps.scene, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, n=1536, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_counts(ps.scene, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, n=1024, device_mesh=object(), **kw)
    counts = launch_counts(ps.scene, rng.PRNGKey(0), (0.0, room.floor_height + 0.8, 0.0), 1.0,
                           n=2048, **kw)
    assert counts.dtype == torch.int32 and counts.shape == (room.triangle_count,)
    assert int(counts.sum()) == 2048  # closed room

