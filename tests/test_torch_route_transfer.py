"""A route's transfer plan (uvtrace_torch/diff/transfer.py) on the CPU: the
interreflection term's sources, source-to-source matrix and receivers'
visibility traced once a route and read by every evaluation.

On a box room (202 triangles, B2's plain version) the planned route dose
equals the unplanned one bit for bit, value and gradients, while it traces
only the rays that see the lamp; `optimize_route` with reflectance builds
one plan a call, serves every evaluation from it and takes the unplanned
run's steps bit for bit; a plan built from other inputs is refused; the
direct objective builds none. The kernels' kept-visibility mode on the card
is tests/test_torch_cuda.py's.
"""

import gc
import sys
import weakref

import numpy as np
import pytest
import torch

from uvtrace_torch import diff as P
from uvtrace_torch.diff import optimize
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.ops import rng
from uvtrace_torch.utils import timing

KEY = rng.fold_in(rng.PRNGKey(5), 3)
WAYPOINTS = np.array([[0.3, -0.4], [-0.5, 0.2], [0.1, 0.6]], np.float32)
DURATIONS = np.array([40.0, 25.0, 30.0], np.float32)
SIZES = dict(n_samples=2, n_sources=20, n_bounces=2)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)


@pytest.fixture(scope="module")
def scene(room):
    return P.make_diff_scene(room, device="cpu")


def _counting(scene):
    """The scene with its shadow-ray trace counted: (scene, calls)."""
    calls = []

    def trace(*args, **kwargs):
        calls.append(args[2].shape[0])
        return scene.trace_fn(*args, **kwargs)

    return scene._replace(trace_fn=trace), calls


def _route(scene, room, transfer=None, **sizes):
    wp = torch.tensor(WAYPOINTS, requires_grad=True)
    durs = torch.tensor(DURATIONS, requires_grad=True)
    rho = torch.full((room.triangle_count,), 0.4, requires_grad=True)
    dose = P.route_dose(scene, wp, durs, room.floor_height + 0.8, 1.0, 450.0, KEY, reflectance=rho, areas=room.areas,
                        transfer=transfer, **sizes)
    weights = torch.linspace(-1.0, 1.0, dose.numel())
    return (dose.detach(), *torch.autograd.grad((dose * weights).sum(), (wp, durs, rho)))


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_the_planned_route_dose_is_the_unplanned_bit_for_bit(room, scene, n_bounces):
    """route_dose with a plan: the dose and its gradients with respect to
    the waypoints, the durations and the reflectance equal the unplanned
    route's bit for bit; a planned evaluation traces the direct rays and
    the sources' direct rays of each waypoint and nothing else (20 sources
    in chunks of 16: the last chunk padded)."""
    sizes = dict(SIZES, n_bounces=n_bounces)
    counted, calls = _counting(scene)
    want = _route(counted, room, **sizes)
    unplanned = len(calls)
    assert unplanned == 3 * (2 + (n_bounces > 1) + 2)
    before = timing.counters()
    plan = P.plan_route_transfer(counted, KEY, 3, room.areas, **sizes)
    assert len(calls) == unplanned + 3 * ((n_bounces > 1) + 2)
    assert timing.counters()["diff.transfer.built"] == before["diff.transfer.built"] + 1
    assert [len(w.vis) for w in plan.waypoints] == [2] * 3
    assert all((w.f_ss is None) == (n_bounces == 1) for w in plan.waypoints)
    del calls[:]
    got = _route(counted, room, plan, **sizes)
    assert len(calls) == 3 * 2
    assert timing.counters()["diff.transfer.served"] == before["diff.transfer.served"] + 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[1] != 0).any()) and bool((got[3] != 0).any())


@pytest.mark.parametrize("other", ["seed", "n_samples", "waypoints", "n_sources", "n_bounces", "areas", "scene",
                                   "no_reflectance"])
def test_a_plan_built_from_other_inputs_is_refused(room, scene, other):
    """A plan serves only the inputs it was built from: another key, sample
    count, waypoint count, source count, bounce count, areas or scene
    raises ValueError before any work, and so does a plan without the
    interreflection term."""
    plan = P.plan_route_transfer(scene, KEY, 3, room.areas, **SIZES)
    wp, durs, key, areas, target = WAYPOINTS, DURATIONS, KEY, room.areas, scene
    kw = dict(SIZES, reflectance=0.4)
    if other == "seed":
        key = rng.fold_in(rng.PRNGKey(6), 3)
    elif other == "waypoints":
        wp, durs = WAYPOINTS[:2], DURATIONS[:2]
    elif other == "areas":
        areas = room.areas * np.float32(2.0)
    elif other == "scene":
        target = P.make_diff_scene(room, device="cpu")
    elif other == "no_reflectance":
        kw["reflectance"] = None
    else:
        kw[other] += 1
    traced = _counting(target)
    with pytest.raises(ValueError, match="transfer"):
        P.route_dose(traced[0] if other != "scene" else target, wp, durs, room.floor_height + 0.8, 1.0, 450.0, key,
                     areas=areas, transfer=plan, **kw)
    assert traced[1] == []


@pytest.mark.parametrize("other", ["chunk_count", "chunk_bytes"])
def test_kept_bytes_of_another_chunking_are_refused(room, scene, other):
    """Bytes kept in chunks other than the route's (16 sources) are refused
    where they are read: a chunk too few by `receiver_transfer`, a chunk of
    8 sources' bytes by K13's kept-visibility mode."""
    plan = P.plan_route_transfer(scene, KEY, 3, room.areas, **SIZES)
    if other == "chunk_count":
        vis, match = lambda v: v[:1], "chunks of kept visibility"
    else:
        vis, match = lambda v: tuple(x[:x.numel() // 2] for x in v), "kept visibility is u8"
    plan = plan._replace(waypoints=tuple(w._replace(vis=vis(w.vis)) for w in plan.waypoints))
    with pytest.raises(ValueError, match=match):
        P.route_dose(scene, WAYPOINTS, DURATIONS, room.floor_height + 0.8, 1.0, 450.0, KEY, areas=room.areas,
                     reflectance=torch.full((room.triangle_count,), 0.4), transfer=plan, **SIZES)


BUILD = optimize.plan_route_transfer


def _watch(monkeypatch, forced_off: bool):
    """optimize_route's plans (None where the unplanned path is forced),
    and each step's loss, gradients, parameters and Adam state, read from
    its frame in the progress callback."""
    plans, steps = [], []

    def planned(*args, **kwargs):
        if forced_off:
            return None
        plan = BUILD(*args, **kwargs)
        plans.append(weakref.ref(plan.waypoints[0].vis[0]))
        return plan

    monkeypatch.setattr(optimize, "plan_route_transfer", planned)

    def progress(i, loss):
        f = sys._getframe(1).f_locals
        steps.append([torch.tensor(loss), *(x.detach().clone() for x in f["grads"]),
                      *(x.detach().clone() for x in f["params"]),
                      *(x.clone() for pair in f["opt_state"] for x in pair)])

    return plans, steps, progress


def test_optimize_route_plans_once_a_call_and_matches_the_unplanned_run(room, scene, monkeypatch):
    """optimize_route with reflectance, 3 steps: the planned run's losses,
    gradients, parameters, Adam state, final waypoints, durations and dose
    equal a run forced down the unplanned path bit for bit. Each call
    builds its own plan, which no one holds once the call returns."""
    runs = {}
    for forced_off in (True, False):
        plans, steps, progress = _watch(monkeypatch, forced_off)
        before = timing.counters()
        res = P.optimize_route(scene, WAYPOINTS, DURATIONS, room.floor_height + 0.8, 1.0, 450.0, steps=3, seed=4,
                               reflectance=0.3, areas=room.areas, progress=progress, **SIZES)
        served = timing.counters()["diff.transfer.served"] - before["diff.transfer.served"]
        assert timing.counters()["diff.transfer.built"] - before["diff.transfer.built"] == (not forced_off)
        assert served == (0 if forced_off else 3 * 4)
        runs[forced_off] = (res, steps)
        gc.collect()
        assert len(plans) == (not forced_off) and all(ref() is None for ref in plans)
    (planned, p_steps), (unplanned, u_steps) = runs[False], runs[True]
    assert planned.history == unplanned.history and len(p_steps) == 3
    for a, b in zip(p_steps, u_steps):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for name in ("waypoints_xz", "durations", "final_dose_masked"):
        np.testing.assert_array_equal(getattr(planned, name), getattr(unplanned, name))
    # the scene keeps the areas' cumulative sums alone, as before the plan
    assert all(len(v) == 2 and v[0].shape == (room.triangle_count,) for v in scene.source_cdfs.values())
