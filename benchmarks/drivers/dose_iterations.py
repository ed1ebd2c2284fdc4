"""The forward dose simulator, driven as the interactive application drives
it: `Simulator.run_iteration()` back to back, each iteration ending with its
dose map (`dosage_map()`) ready on the device. One client, a closed loop.

The cell's traffic file gives the lamps (a route XML, or a list of (x, z,
seconds)), the photons an iteration and the bounces; the configuration the
scene and the simulator's settings.

Correct: an iteration drawn from the seed among the window's first
`sample_first` is traced again by the plain reference from the seed
(reference/dose.py), and its dose, shaded into mJ/cm^2, compared with the
program's: the difference of the program's dose maps after and before it,
each times the photons a lamp so far, against the reference's hits times
power / area. Also every iteration's photon count, and the hits of the
whole session against the reference iteration's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.harness import scene as scene_io
from benchmarks.reference import dose as ref_dose
from benchmarks.reference.tracer import scene_of


def _lamps(run):
    t = run.traffic
    if "route" in t:
        route = scene_io.load_route(run.data(t["route"]))
        return route["waypoints"], route
    return [tuple(w) for w in t["lamps"]], {}


def setup(run):
    from uvtrace_torch.geometry.mesh import TriangleMesh
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.sim import SimParams, Simulator

    tris = scene_io.load_triangles(run.data(run.config["scene"]))
    floor = scene_io.floor_height(tris)
    lamps, route = _lamps(run)
    c, t = run.config, run.traffic
    params = SimParams(
        photon_count=int(t["photon_count"]), max_iterations=1 << 30, seed=run.seed,
        light_intensity=float(route.get("light_intensity", c["light_intensity"])),
        light_length=float(route.get("light_length", c["light_length"])),
        light_height=float(route.get("light_height", c["light_height"])),
        max_bounces=int(t.get("max_bounces", 0)), reflectance=float(t.get("reflectance", 0.0)),
        traversal=c["traversal"], sampler=c["sampler"])
    mesh = TriangleMesh(tris=tris, floor_height=floor, name="scene")
    t0 = time.perf_counter()
    sim = Simulator(mesh, params, route=[LightPos(x, z, s) for x, z, s in lamps], device=run.device)
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.scene_build_s = time.perf_counter() - t0
    dose = None
    for _ in range(int(run.cell["warmup"])):  # builds and loads the kernels; every shape of the window
        sim.run_iteration()
        dose = sim.dosage_map()
    _sync(run)
    return {"sim": sim, "tris": tris, "floor": floor, "lamps": lamps, "params": params,
            "base": int(run.cell["warmup"]), "last": (dose, sim.photon_map_size)}


def _sync(run):
    if run.device == "cuda":
        torch.cuda.synchronize()


def _iterate(run, state, sample: int, stop):
    """Iterations until stop(i, t_end) after the sampled one; returns the
    record of the window or slice."""
    sim = state["sim"]
    lamps = len(state["lamps"])
    items, maps = [], {-1: state["last"]}
    start = time.perf_counter()
    i = 0
    while True:
        before = sim.photon_map_size
        t0 = time.perf_counter()
        sim.run_iteration()
        dose = sim.dosage_map()
        _sync(run)
        t1 = time.perf_counter()
        items.append((t0, t1, sim.photon_map_size - before))
        if i in (sample - 1, sample):
            maps[i] = (dose, sim.photon_map_size)
        last = (dose, sim.photon_map_size)
        i += 1
        if i > sample and stop(i, t1):
            break
    grab = lambda m: (m[0].double().cpu().numpy(), m[1] // lamps)  # noqa: E731
    return {"unit": "photons", "start": start, "end": items[-1][1], "items": items, "attempted": len(items),
            "sample": sample, "before": grab(maps[sample - 1]), "after": grab(maps[sample]), "final": grab(last),
            "iterations_before": state["base"], "lamps": lamps}


def window(run, state):
    sample = int(np.random.default_rng(run.seed).integers(run.cell["sample_first"]))
    deadline = time.perf_counter() + run.seconds
    return _iterate(run, state, sample, lambda i, t_end: t_end >= deadline)


def traced(run, state):
    units = int(run.cell["trace_units"])
    sample = int(np.random.default_rng(run.seed).integers(units))
    return _iterate(run, state, sample, lambda i, t_end: i >= units)


def release(run, state):
    state.clear()


def bounce_args(run, tris) -> dict:
    """The reference's bounce arguments of the traffic: bounces,
    reflectance and the unit normals (v1 - v0) x (v2 - v0)."""
    bounces = int(run.traffic.get("max_bounces", 0))
    if not bounces:
        return {}
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)).astype(np.float32)
    return dict(bounces=bounces, reflectance=float(run.traffic["reflectance"]),
                normals=torch.from_numpy(n).to(run.device))


def check(run, record):
    """[(name, value, limit)] of the comparison with the reference."""
    c, t = run.config, run.traffic
    tris = scene_io.load_triangles(run.data(c["scene"]))
    floor = scene_io.floor_height(tris)
    lamps, route = _lamps(run)
    get = lambda k: float(route.get(k, c[k]))  # noqa: E731
    scene = scene_of(tris, run.device)
    per_lamp, _ = ref_dose.launch_size(int(t["photon_count"]), len(lamps))
    expected = per_lamp * len(lamps)
    every = int(run.cell["work_sample_every"]) if run.trace else 0
    hits, photons, sampled = ref_dose.iteration_hits(
        scene, tris.shape[0], lamps, floor, get("light_height"), get("light_length"), int(t["photon_count"]),
        run.seed, record["iterations_before"] + record["sample"], run.device, sample_every=every,
        **bounce_args(run, tris))
    if every:  # the reference iteration's work, times the iterations the slice traced
        scale = sum(n for _, _, n in record["items"]) / photons
        run.work = {"segments": sampled[0] * scale, "tests": sampled[1] * scale,
                    "scene_bytes": tris.nbytes}
    area = scene_io.areas(tris).astype(np.float64)
    ok = area > 0
    scale = get("light_intensity") * 0.1
    ref = hits.cpu().numpy()[ok] * scale / area[ok]
    (d0, n0), (d1, n1) = record["before"], record["after"]
    prog = d1[ok] * n1 - d0[ok] * n0
    dose_gap = float(np.abs(prog - ref).sum() / max(np.abs(ref).sum(), 1e-30))
    got = sum(n for _, _, n in record["items"])
    photons_gap = abs(got - expected * record["attempted"]) / (expected * record["attempted"])
    d_end, n_end = record["final"]
    session_hits = float(np.nansum(d_end[ok] * n_end * area[ok]) / scale)
    iterations = record["iterations_before"] + record["attempted"]
    session_gap = abs(session_hits / iterations - float(hits.sum())) / max(float(hits.sum()), 1e-30)
    limits = run.cell["limits"]
    return [("dose_gap", dose_gap, limits["dose_gap"]),
            ("session_hits_gap", session_gap, limits["session_hits_gap"]),
            ("photons_gap", float(photons_gap), limits["photons_gap"])]
