"""The differentiable route planner, driven as its command line drives it:
`optimize_route` on the configuration's route, whole routes of `steps`
steps back to back (each with its own set-up and final evaluation), one
client, a closed loop. The window stops at its end inside a route, through
the progress callback, which stamps each step once its loss has reached the
host. The record keeps each whole route's end: the window's reading counts
whole routes only (harness/readers.step_ms), so every reading holds the
same share of the routes' set-up, transfer plan and final evaluation; the
steps of the route the window stops in are run and not counted.

Correct: the first `follow` steps of the window's first route are followed
by the plain reference (reference/routeopt.py) from the same start and seed.
Compared: each step's loss; the norm of each parameter leaf's first
gradient, as Adam's first moment holds it after one step; the norm of each
leaf's change after `follow` steps. A leaf's gap is the gap between the two
norms over the larger of the reference's norm of that leaf and of the
median leaf. An element whose reference gradient is under a thousandth of
the median leaf's norm is left out of the change, on both sides: Adam's
first step moves every element by the learning rate whatever its size, so
such an element moves by the sign of its round-off. The program's
optimizer state is read from the frame of `optimize_route` in the
callback.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmarks.harness import scene as scene_io
from benchmarks.reference.routeopt import B1, RouteProblem
from benchmarks.reference.tracer import scene_of


class _Stop(Exception):
    """Raised in the progress callback to end a route at the window's end."""


def _inputs(run):
    tris = scene_io.load_triangles(run.data(run.config["scene"]))
    return tris, scene_io.floor_height(tris), scene_io.load_route(run.data(run.config["route"]))


def setup(run):
    from uvtrace_torch.diff import make_diff_scene
    from uvtrace_torch.geometry.mesh import TriangleMesh

    c, t = run.config, run.traffic
    tris, floor, route = _inputs(run)
    mesh = TriangleMesh(tris=tris, floor_height=floor, name="scene")
    t0 = time.perf_counter()
    scene = make_diff_scene(mesh, device=run.device)
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.scene_build_s = time.perf_counter() - t0
    wp = np.array([[x, z] for x, z, _ in route["waypoints"]], np.float32)
    durs = np.array([s for _, _, s in route["waypoints"]], np.float32)
    lo, hi = mesh.aabb
    m = float(c["bounds_margin"])
    bounds = ((float(lo[0]) + m, float(lo[2]) + m), (float(hi[0]) - m, float(hi[2]) - m))
    wp = np.clip(wp, np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
    kw = dict(learning_rate=float(c["learning_rate"]), temperature=float(c["temperature"]),
              n_samples=int(c["n_samples"]), optimize_durations=bool(c["optimize_durations"]), bounds=bounds,
              seed=run.seed)
    if float(t.get("reflectance", 0.0)) > 0:
        kw.update(reflectance=float(t["reflectance"]), areas=np.asarray(mesh.areas),
                  n_bounces=int(t["n_bounces"]), n_sources=int(t["n_sources"]))
    args = (scene, wp, durs, floor + route["light_height"], route["light_length"], route["light_intensity"])
    from uvtrace_torch.diff import optimize_route

    optimize_route(*args, steps=int(run.cell["warmup_steps"]), **kw)  # builds and loads every kernel
    if run.device == "cuda":
        torch.cuda.synchronize()
    return {"optimize": lambda **more: optimize_route(*args, steps=int(c["steps"]), **kw, **more)}


def _routes(run, state, stop):
    """Whole routes back to back until stop(steps done, now) at a step;
    records every step and, from the first route, the program's state."""
    follow = int(run.cell["follow"])
    items, seen = [], {"losses": []}
    ends = []  # (end, steps done by then) of each whole route
    clock = [time.perf_counter()]

    def progress(i, loss):
        now = time.perf_counter()
        items.append((clock[0], now, 1))
        clock[0] = now
        if not ends and i < follow:
            frame = sys._getframe(1)  # optimize_route's: its parameters and Adam's moments after step i + 1
            params, opt_state = frame.f_locals["params"], frame.f_locals["opt_state"]
            seen["losses"].append(float(loss))
            if i == 0:
                seen["first_grads"] = [(mu / (1 - B1)).detach().float().cpu() for mu, _ in opt_state]
            if i == follow - 1:
                seen["params"] = [p.detach().float().cpu().clone() for p in params]
        if len(seen["losses"]) >= follow and stop(len(items), now):
            raise _Stop

    start = clock[0]
    while True:
        try:
            state["optimize"](progress=progress)
        except _Stop:
            break
        clock[0] = time.perf_counter()
        ends.append((clock[0], len(items)))
    return {"unit": "steps", "start": start, "end": items[-1][1], "items": items, "attempted": len(items),
            "route_ends": ends, "program": seen, "forwards": len(items) + len(ends)}


def window(run, state):
    deadline = time.perf_counter() + run.seconds
    return _routes(run, state, lambda steps, now: now >= deadline)


def traced(run, state):
    units = int(run.cell["trace_units"])
    return _routes(run, state, lambda steps, now: steps >= units)


def release(run, state):
    state.clear()


def _leaf_gaps(prog, ref, scale_ref):
    """Per leaf: |norm(prog) - norm(ref)| / max(norm(scale_ref leaf),
    median leaf norm of scale_ref)."""
    norms = [float(torch.linalg.vector_norm(r)) for r in scale_ref]
    med = float(np.median(norms))
    return [abs(float(torch.linalg.vector_norm(p)) - float(torch.linalg.vector_norm(r))) / max(n, med, 1e-30)
            for p, r, n in zip(prog, ref, norms)]


def check(run, record):
    tris, floor, route = _inputs(run)
    follow = int(run.cell["follow"])
    every = int(run.cell["work_sample_every"]) if run.trace else 0
    problem = RouteProblem(scene_of(tris, run.device), tris, floor, route, run.config, run.traffic, run.seed,
                           run.device, work_every=every)
    losses, first, params = problem.follow(follow)
    if every:  # what a route needs once, for each route begun, and each evaluation's own
        (route_rays, route_tests), (rays, tests) = problem.work["route"], problem.work["forward"]
        routes, forwards = len(record["route_ends"]) + 1, record["forwards"]
        run.work = {"segments": route_rays * routes + rays * forwards,
                    "tests": route_tests * routes + tests * forwards, "scene_bytes": tris.nbytes}
    return readings(run, record["program"], losses, first, params, problem)


def readings(run, prog, losses, first, params, problem):
    """[(name, value, limit)] of the program's first steps (`prog`: losses,
    first_grads, params) against the reference's."""
    start = [problem.raw0.float().cpu(), problem.logits0.float().cpu()]
    first = [g.cpu() for g in first]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], losses))
    grad_gap = max(_leaf_gaps(prog["first_grads"], first, first))
    med = float(np.median([float(torch.linalg.vector_norm(g)) for g in first]))
    moved = [g.abs() >= 1e-3 * med for g in first]
    change_prog = [(p - s) * m for p, s, m in zip(prog["params"], start, moved)]
    change_ref = [(p.cpu() - s) * m for p, s, m in zip(params, start, moved)]
    change_gap = max(_leaf_gaps(change_prog, change_ref, change_ref))
    limits = run.cell["limits"]
    return [("loss_gap", loss_gap, limits["loss_gap"]), ("grad_gap", grad_gap, limits["grad_gap"]),
            ("change_gap", change_gap, limits["change_gap"])]
