"""The plain references against the port's plain CPU path at a tiny size,
and the work counts of the rooflines."""

import numpy as np
import pytest
import torch

from benchmarks.harness import scene as scene_io
from benchmarks.reference import dose as ref_dose
from benchmarks.reference import threefry, tracer
from benchmarks.rooflines.clusters import build_clusters


@pytest.fixture(scope="module")
def room():
    from uvtrace_torch.geometry.procedural import make_box_room

    return make_box_room(subdivisions=4, clutter=6)


def test_threefry_matches_the_port(room):
    from uvtrace_torch.ops import rng

    k = threefry.key(2 ** 31 + 99)
    assert (threefry.split(k, 3) == rng.split(rng.PRNGKey(2 ** 31 + 99), 3)).all()
    assert (threefry.fold_in(k, 7) == rng.fold_in(k, 7)).all()
    assert torch.equal(threefry.uniform(k, (4, 5), "cpu", -1.0, 1.0), rng.uniform_reference(k, (4, 5), "cpu", -1.0, 1.0))


def test_readers_match_the_port(tmp_path, room):
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.io.gltf_export import export_glb
    from uvtrace_torch.io.routexml import load_route_xml

    path = tmp_path / "room.glb"
    export_glb(str(path), room.tris)
    tris = scene_io.load_triangles(path)
    assert np.array_equal(tris, load_glb(path).tris)
    assert scene_io.floor_height(tris) == load_glb(path).floor_height
    for name in ("route.xml", "lange_route.xml"):
        mine = scene_io.load_route(scene_io.Path(__file__).parent.parent / "data" / name)
        port = load_route_xml(scene_io.Path(__file__).parent.parent / "data" / name)
        assert mine["waypoints"] == [(w.x, w.y, w.duration) for w in port.waypoints]
        assert mine["light_height"] == port.light_height and mine["photon_count"] == port.photon_count


def test_closest_hits_match_brute_force(room):
    """The clustered search equals Möller–Trumbore over every triangle."""
    from uvtrace_torch.ops.intersect import brute_force_closest_hit

    g = torch.Generator().manual_seed(3)
    orig = (torch.rand(3000, 3, generator=g) - 0.5) * 2.0
    dirs = torch.nn.functional.normalize(torch.randn(3000, 3, generator=g), dim=1)
    scene = tracer.scene_of(room.tris, "cpu")
    t, tri = tracer.trace(scene, orig, dirs)
    t_bf, tri_bf = brute_force_closest_hit(orig, dirs, torch.from_numpy(room.tris))
    hit = tri_bf >= 0
    assert torch.equal(tri >= 0, hit)
    assert torch.allclose(t[hit], t_bf[hit], rtol=1e-6)
    assert (tri[hit] == tri_bf[hit].long()).float().mean() > 0.999
    limit = torch.where(hit, t_bf * 0.5, 1.0)
    t_l, tri_l = tracer.trace(scene, orig, dirs, limit=limit)
    assert bool((t_l[tri_l >= 0] < limit[tri_l >= 0]).all())
    assert bool((tri_l[hit] == -1).all())


def test_dose_iteration_equals_the_port_on_the_cpu(room):
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.sim import SimParams, Simulator

    route = [(0.3, -0.2, 60.0), (-0.5, 0.4, 30.0)]
    p = SimParams(photon_count=1 << 14, seed=2 ** 31 + 5)
    sim = Simulator(room, p, route=[LightPos(*w) for w in route], device="cpu")
    sim.run_iteration()
    before = sim.photon_map.clone()
    sim.run_iteration()
    scene = tracer.scene_of(room.tris, "cpu")
    hits, photons, _ = ref_dose.iteration_hits(scene, room.triangle_count, route, room.floor_height, p.light_height,
                                               p.light_length, p.photon_count, p.seed, 1, "cpu")
    assert photons == sim.photon_map_size // 2
    assert torch.equal((sim.photon_map - before).double(), hits)


def test_route_steps_equal_the_port_on_the_cpu(small_run):
    """The harness's comparison of the first steps reads the port's CPU
    path within float rounding."""
    from benchmarks.harness import core

    for cell in ("routeopt.direct", "routeopt.bounce2"):
        out = core.execute(small_run(cell))
        assert out["correct"]
        assert all(c["value"] < 1e-5 for c in out["checks"].values()), out["checks"]


def test_work_counts_on_a_small_room(room):
    """A ray's work is the real triangles of the clusters its segment enters
    before its closest hit, each cluster's box tested by hand."""
    g = torch.Generator().manual_seed(5)
    orig = (torch.rand(500, 3, generator=g) - 0.5)
    dirs = torch.nn.functional.normalize(torch.randn(500, 3, generator=g), dim=1)
    scene = tracer.scene_of(room.tris, "cpu")
    t, _, work = tracer.trace(scene, orig, dirs, work=True)
    cl = build_clusters(room.tris)
    o, d = orig.double().numpy(), dirs.double().numpy()
    box = scene.box.double().numpy()
    for i in range(0, 500, 37):
        inv = 1.0 / np.where(d[i] == 0, 1e-30, d[i])
        lo, hi = (box[:, :3] - o[i]) * inv, (box[:, 3:] - o[i]) * inv
        t_in, t_out = np.minimum(lo, hi).max(1), np.maximum(lo, hi).min(1)
        enters = (t_in <= t_out) & (t_out >= 0) & (np.maximum(t_in, 0) < float(t[i]))
        assert abs(float(work[i]) - float(cl.real[enters].sum())) <= cl.real.max(), i
    assert float(work.sum()) > 0


def test_bounce_work_counts_every_live_segment(room):
    """With bounces the work is that of every segment: the same primaries
    with a reflectance of 0 (every lane dead after them) count the
    primaries' work and segments alone, and with 0.5 the live bounce
    segments add theirs."""
    n = np.cross(room.tris[:, 1] - room.tris[:, 0], room.tris[:, 2] - room.tris[:, 0])
    normals = torch.from_numpy((n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32))
    scene = tracer.scene_of(room.tris, "cpu")

    def sampled(reflectance, every):
        return ref_dose.iteration_hits(scene, room.triangle_count, [(0.1, 0.2, 1.0)], room.floor_height, 0.4,
                                       1.0, 1 << 12, 2 ** 31 + 3, 0, "cpu", sample_every=every, bounces=2,
                                       reflectance=reflectance, normals=normals)[1:]

    photons, (segments, tests) = sampled(0.0, 1)
    (_, (primary, _)) = sampled(0.0, 4)
    _, (segments_b, tests_b) = sampled(0.5, 1)
    _, (_, tests_4) = sampled(0.5, 4)
    assert segments == primary == photons
    assert photons < segments_b < 3 * photons and tests_b > tests > 0
    assert abs(tests_4 - tests_b) < 0.1 * tests_b  # the sample, scaled, stands for every ray


def test_route_work_counts_the_constant_rays_once(small_run):
    """The route planner's rays that do not depend on the lamp (the sources'
    matrix, their receivers) fall in the route's count, traced once; an
    evaluation of the objective counts its own rays."""
    from benchmarks.reference.routeopt import RouteProblem

    run = small_run("routeopt.bounce2")
    tris = scene_io.load_triangles(run.data(run.config["scene"]))
    route = scene_io.load_route(run.data(run.config["route"]))
    problem = RouteProblem(tracer.scene_of(tris, "cpu"), tris, scene_io.floor_height(tris), route, run.config,
                           run.traffic, run.seed, "cpu", work_every=4)
    problem.follow(2)
    n_way, t, s, m = len(route["waypoints"]), tris.shape[0], int(run.config["n_samples"]), int(run.traffic["n_sources"])
    assert problem.work["route"][0] == n_way * (m * s * t + m * m)
    assert problem.work["forward"][0] == n_way * (s * t + max(4, s) * m)
    assert problem.work["route"][1] > 0 and problem.work["forward"][1] > 0
