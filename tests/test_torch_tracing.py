"""The port's spans and counters (uvtrace_torch/utils/timing.py) on the CPU:
off by default and then recording nothing while the counters count; the
span trees of a dose iteration and of an optimizer route; the same spans as
torch.profiler ranges; a texel run's atlas, maps and probe grid; set-up
spans recorded with tracing off; parents across threads; the bound on the
buffer; the split kernel's tests counted on the device under tracing alone.
The kernels' spans and their device
intervals on the card are tests/test_torch_cuda.py's.
"""

import ctypes
import threading

import numpy as np
import pytest
import torch

from uvtrace_torch import _build
from uvtrace_torch import diff as D
from uvtrace_torch.bvh import native
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.sim import SimParams, Simulator
from uvtrace_torch.utils import timing


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


@pytest.fixture
def recorder():
    """The process's recorder, emptied before and after the test."""
    timing.reset()
    yield timing.RECORDER
    timing.reset()


def _bounce_sim(room):
    """A Simulator with one bounce through the split kernel's plain version;
    its set-up spans are forgotten."""
    params = SimParams(photon_count=2048, max_iterations=4, max_bounces=1, reflectance=0.5, traversal="mxu")
    sim = Simulator(room, params, route=[LightPos(0.3, -0.2, 1.0)], ray_chunk=1024, device="cpu")
    timing.reset()
    return sim


def _paths(spans):
    """Each span's chain of names from its root, as 'a > b > c'."""
    by_id = {s.id: s for s in spans}

    def path(s):
        return s.name if s.parent is None else f"{path(by_id[s.parent])} > {s.name}"

    return [path(s) for s in spans]


def test_off_records_no_span_and_counters_count(room, recorder, monkeypatch):
    sim = _bounce_sim(room)
    assert not recorder.enabled()
    sim.run_iteration()
    sim.dosage_map()
    with timing.span("test.outer", unit=True, x=1) as s:
        s.set(y=2)
    assert timing.spans() == []
    timing.count("test.count")
    timing.count("test.count", 4)
    assert timing.counters()["test.count"] == 5 and timing.counters()["test.never"] == 0
    # a launch on the card counts its launch with tracing off, and opens no span
    monkeypatch.setattr(_build, "call", lambda name, device, *args: 0)
    _build.launch("traverse_mxu_launch", torch.device("cuda"), 1, 2, rays=4096)
    assert timing.counters()["launches.traverse_mxu_launch"] == 1
    assert timing.spans() == []


def test_a_kernel_launch_is_a_span_with_its_rays(recorder, monkeypatch):
    monkeypatch.setattr(_build, "call", lambda name, device, *args: 700 if args[0] == "refused" else 0)
    with timing.tracing():
        # a kernel span takes no CUDA event (none can be made without a card)
        _build.launch("traverse_mxu_launch", torch.device("cuda"), "ok", rays=1 << 20)
        _build.launch("pack_sorted_launch", torch.device("cpu"), "ok")
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            _build.launch("pack_sorted_launch", torch.device("cpu"), "refused")
    spans = timing.spans()
    assert [(s.name, s.attrs["rays"]) for s in spans] == [("kernel.traverse_mxu_launch", 1 << 20),
                                                          ("kernel.pack_sorted_launch", None),
                                                          ("kernel.pack_sorted_launch", None)]
    assert all(s.device_ms is None for s in spans)  # the profiler times kernels: no device interval
    assert timing.counters()["launches.pack_sorted_launch"] == 1  # the refused launch is not counted


def test_a_dose_iteration_is_a_tree_of_spans(room, recorder):
    sim = _bounce_sim(room)
    with timing.tracing():
        sim.run_iteration()
        sim.dosage_map()
    spans = timing.spans()
    paths = _paths(spans)
    assert "sim.iteration > sim.lamp > launch.chunk > launch.bounce > launch.sort" in paths
    assert paths.count("sim.iteration > sim.lamp > launch.chunk") == 2  # 2048 photons, chunks of 1024
    assert paths.count("sim.iteration > sim.lamp > launch.chunk > launch.bounce") == 2
    assert "sim.iteration > sim.lamp > launch.remap" in paths and "shade.dose_map" in paths
    iteration = spans[0]
    assert iteration.name == "sim.iteration" and iteration.attrs == {"iteration": 0}
    inside = [s for s in spans if s.name != "shade.dose_map"]
    assert {s.unit for s in inside} == {iteration.unit}
    lamp = spans[1]
    assert lamp.attrs == {"lamp": (0.3, -0.2), "photons": 2048}
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    with timing.tracing():
        sim.run_iteration()
    second = [s for s in timing.spans() if s.name == "sim.iteration"]
    assert [s.attrs["iteration"] for s in second] == [0, 1] and second[0].unit != second[1].unit


def _texel_sim(room, density: float):
    """A direct-lighting Simulator through the split kernel's plain version,
    with an atlas at `density` texels a metre (0: none)."""
    params = SimParams(photon_count=2048, max_iterations=2, traversal="mxu", texel_density=density)
    return Simulator(room, params, route=[LightPos(0.3, -0.2, 1.0)], ray_chunk=1024, device="cpu")


def test_a_texel_run_traces_its_atlas_maps_and_grid(room, recorder):
    from uvtrace_torch.sim import ViewMode

    sim = _texel_sim(room, 8.0)
    [atlas] = [s for s in timing.spans() if s.name == "setup.atlas"]  # recorded with tracing off
    assert atlas.attrs == {"density": 8.0, "slots": sim.atlas.n_slots} and atlas.end_ns > atlas.start_ns
    timing.reset()
    with timing.tracing():
        sim.run_iteration()
        sim.dosage_map_texels(ViewMode.DOSAGE)
        sim.dosage_map_texels(ViewMode.MAX_POWER)
        sim.dose_grid(res=16)
    spans = timing.spans()
    paths = _paths(spans)
    maps = [s for s in spans if s.name == "shade.texel_map"]
    assert [s.attrs["view"] for s in maps] == ["dosage", "maxpower", "dosage"]  # the grid shades its own
    assert all(s.device_ms is None for s in maps)  # CUDA events on a card only
    assert "sim.dose_grid > grid.lookup > shade.texel_map" in paths
    [grid] = [s for s in spans if s.name == "sim.dose_grid"]
    assert grid.attrs == {"res": 16, "texels": True} and grid.unit is None
    children = [s for s in spans if s.parent == grid.id]
    assert [s.name for s in children] == ["grid.probes", "grid.lookup"]
    assert all(grid.start_ns <= c.start_ns and c.end_ns <= grid.end_ns for c in children)
    assert timing.counters()["texel.maps"] == 3
    assert timing.counters()["grid.probes"] == 1024  # 16^2 probes padded to a 1024-ray packet


def test_no_texel_span_or_counter_without_an_atlas(room, recorder):
    sim = _texel_sim(room, 0.0)
    with timing.tracing():
        sim.run_iteration()
        sim.dosage_map()
    names = {s.name for s in timing.spans()}
    assert not names & {"setup.atlas", "shade.texel_map", "sim.dose_grid", "grid.probes", "grid.lookup"}
    assert timing.counters()["texel.maps"] == timing.counters()["grid.probes"] == 0
    with timing.tracing():
        sim.dose_grid(res=16)  # by triangle: the grid's spans, no texel map
    spans = timing.spans()
    assert [s.attrs for s in spans if s.name == "sim.dose_grid"] == [{"res": 16, "texels": False}]
    assert "shade.texel_map" not in {s.name for s in spans} and timing.counters()["texel.maps"] == 0


def test_an_optimizer_route_is_a_tree_of_spans(room, recorder):
    scene = D.make_diff_scene(room, device="cpu")
    timing.reset()
    wp = np.array([[0.5, 0.5], [-0.5, -0.3]], np.float32)
    with timing.tracing():
        D.optimize_route(scene, wp, np.array([30.0, 30.0], np.float32), room.floor_height + 0.8, 1.0, 450.0,
                         steps=2, n_samples=2)
    spans = timing.spans()
    by_id = {s.id: s for s in spans}
    route = [s for s in spans if s.parent is None]
    assert [s.name for s in route] == ["opt.route"]
    children = [s for s in spans if s.parent == route[0].id]
    assert [s.name for s in children] == ["opt.step", "opt.step", "opt.final"]
    for i, step in enumerate(children[:2]):
        assert step.attrs == {"step": i}
        parts = [s for s in spans if s.parent == step.id]
        assert [s.name for s in parts] == ["diff.forward", "diff.backward", "opt.adam", "opt.loss_read"]
        waypoints = [s for s in spans if s.parent == parts[0].id]
        assert [(s.name, s.attrs) for s in waypoints] == [("diff.waypoint", {"w": 0}), ("diff.waypoint", {"w": 1})]
        assert all(s.name == "diff.sort" for s in spans if s.parent in {w.id for w in waypoints})
        # every span under the step shares its unit
        under = [s for s in spans if s.id > step.id and s.end_ns <= step.end_ns and s.start_ns >= step.start_ns]
        assert under and {s.unit for s in under} == {step.unit}
    assert children[0].unit != children[1].unit and route[0].unit is None
    assert all(by_id[s.parent].name == "diff.waypoint" for s in spans if s.name == "diff.sort")


@pytest.mark.parametrize("objective", ["bounce2", "direct"])
def test_a_reflectance_route_traces_its_transfer_plan_once(room, recorder, objective):
    """A 2-bounce optimize_route opens one `opt.transfer` span in
    `opt.route`, before its first `opt.step`, and counts one plan built and
    one plan served a waypoint and evaluation; the direct objective records
    neither the span nor the counters."""
    scene = D.make_diff_scene(room, device="cpu")
    timing.reset()
    wp = np.array([[0.5, 0.5], [-0.5, -0.3]], np.float32)
    kw = dict(reflectance=0.3, areas=room.areas, n_sources=6, n_bounces=2) if objective == "bounce2" else {}
    with timing.tracing():
        D.optimize_route(scene, wp, np.array([30.0, 30.0], np.float32), room.floor_height + 0.8, 1.0, 450.0,
                         steps=2, n_samples=2, **kw)
    spans = timing.spans()
    route = [s for s in spans if s.name == "opt.route"]
    children = [s.name for s in spans if s.parent == route[0].id]
    counters = timing.counters()
    if objective == "direct":
        assert children == ["opt.step", "opt.step", "opt.final"]
        assert counters["diff.transfer.built"] == counters["diff.transfer.served"] == 0
        return
    assert children == ["opt.transfer", "opt.step", "opt.step", "opt.final"]
    [plan] = [s for s in spans if s.name == "opt.transfer"]
    first = next(s for s in spans if s.name == "opt.step")
    assert plan.end_ns <= first.start_ns and plan.unit is None
    assert counters["diff.transfer.built"] == 1 and counters["diff.transfer.served"] == 2 * (2 + 1)
    # the plan traces a waypoint's matrix and its one chunk of 6 sources; a step, a waypoint's direct rays
    # and its sources' direct rays
    under = [s for s in spans if s.name == "diff.sort" and plan.start_ns <= s.start_ns <= plan.end_ns]
    assert len(under) == 2 * 2
    for step in [s for s in spans if s.name == "opt.step"]:
        sorts = [s for s in spans if s.name == "diff.sort" and s.unit == step.unit]
        assert len(sorts) == 2 * 2


def test_spans_are_profiler_ranges_of_the_same_names_and_nesting(room, recorder):
    from torch.profiler import ProfilerActivity, profile

    sim = _bounce_sim(room)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert recorder.enabled()
        sim.run_iteration()
    assert not recorder.enabled()
    spans = timing.spans()
    ours = {s.name for s in spans}
    events = [e for e in prof.events() if e.name in ours]
    assert sorted(e.name for e in events) == sorted(s.name for s in spans)
    # each range lies inside a range of its span's parent
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    for s in spans:
        if s.parent is None:
            continue
        parent = spans[s.parent].name
        for e in by_name[s.name]:
            assert any(p.time_range.start <= e.time_range.start and e.time_range.end <= p.time_range.end
                       for p in by_name[parent]), (s.name, parent)


def test_set_up_spans_record_with_tracing_off(recorder):
    native._load.cache_clear()
    before = timing.counters()["builds.native_library"]
    ok = native.available()
    assert not recorder.enabled()
    [s] = [s for s in timing.spans() if s.name == "setup.native_library"]
    assert s.end_ns > s.start_ns and isinstance(s.attrs["built"], bool)
    assert timing.counters()["builds.native_library"] - before == (1 if ok and s.attrs["built"] else 0)
    room = make_box_room(subdivisions=2, clutter=0, seed=1)
    D.make_diff_scene(room, device="cpu")
    names = [s.name for s in timing.spans()]
    assert names[-2:] == ["setup.clusters", "setup.scene_tables"]


def test_a_span_opened_on_another_thread_takes_the_open_span_as_parent(recorder):
    """The autograd engine runs a CUDA backward on a thread of its own while
    the caller waits: its spans nest under the caller's open span."""
    def worker():
        with timing.span("test.worker"):
            pass

    with timing.tracing():
        with timing.span("test.caller", unit=True) as caller:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    spans = timing.spans()
    [w], [c] = ([s for s in spans if s.name == name] for name in ("test.worker", "test.caller"))
    assert w.parent == c.id == caller.id and w.unit == c.unit is not None


def test_the_buffer_bound_counts_dropped_spans():
    rec = timing.Recorder()
    rec.max_spans = 3
    with rec.tracing():
        for i in range(5):
            with rec.span("test.span", i=i):
                pass
    assert [s.attrs["i"] for s in rec.spans()] == [0, 1, 2]
    assert rec.counters()["spans.dropped"] == 2
    rec.reset()
    assert rec.spans() == [] and rec.counters()["spans.dropped"] == 0


class _Ptr(ctypes.c_void_p):
    """A device address that remembers its tensor (the emulator reads it)."""


def test_split_kernel_counts_its_tests_only_under_tracing(room, recorder, monkeypatch):
    """The split kernel's (ray, leaf) and (ray, triangle) tests reach the
    counters b2.leaf_tests and b2.tri_tests through the one int64[2]
    accumulator that its wrapper passes inside `tracing()` alone, read when
    `counters()` is: they equal the plain replay's sums, and a launch
    outside tracing gets no accumulator and counts nothing. The C entry
    point runs on an emulator: the plain version on the tensors its
    pointers name, adding the packets' sums as each warp of the kernel
    does."""
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    g = np.random.default_rng(8)
    verts = room.tris.reshape(-1, 3)
    lo, hi = verts.min(0), verts.max(0)
    o = torch.from_numpy((lo + (hi - lo) * g.uniform(0.05, 0.95, (2048, 3))).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(g.normal(size=(2048, 3)).astype(np.float32)), dim=1)
    plain = tm.traverse_mxu_padded_reference(scene, o, d, packet=512, with_visits=True)
    passed = []

    def ptr(x):
        p = _Ptr(0 if x is None else x.data_ptr())
        p.tensor = x
        return p

    def emulate(name, device, *args):
        assert name == "traverse_mxu_launch" and len(args) == len(_build.SIGNATURES[name][0]) - 1
        orig, dirs, _, packet, *_, t, slot, counts, tests, tri_tests, totals = (
            getattr(a, "tensor", a) for a in args)
        res = tm.traverse_mxu_padded_reference(scene, orig, dirs, packet=packet, with_visits=True)
        for dest, value in zip((t, slot, tests, tri_tests), res):
            dest.copy_(value)
        passed.append(totals is not None)
        if totals is not None:
            totals += torch.stack([res[2].sum(), res[3].sum()])
        return 0

    monkeypatch.setattr(_build, "ptr", ptr)
    monkeypatch.setattr(_build, "call", emulate)

    def launch():
        return tm._traverse_mxu_kernel(scene, o, d, 512, 4, False, True)

    out = launch()
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert timing.counters()["b2.leaf_tests"] == timing.counters()["b2.tri_tests"] == 0
    with timing.tracing():
        launch()
        launch()
    launch()
    c = timing.counters()
    assert (c["b2.leaf_tests"], c["b2.tri_tests"]) == (2 * int(plain[2].sum()), 2 * int(plain[3].sum()))
    assert 0 < c["b2.leaf_tests"] < c["b2.tri_tests"] and passed == [False, True, True, False]
    assert timing.counters()["b2.leaf_tests"] == c["b2.leaf_tests"]  # read once, then zeroed on the device
    timing.reset()
    assert timing.counters()["b2.tri_tests"] == 0
