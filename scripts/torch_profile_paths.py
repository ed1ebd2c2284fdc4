"""Where the device time of the port's dose paths goes, on an NVIDIA GPU.

    python3 scripts/torch_profile_paths.py                  # every path
    python3 scripts/torch_profile_paths.py --path pallas    # one of them
    python3 scripts/torch_profile_paths.py --path config4 --repeat 30 \
        --root build/parent --root . --root . --root build/parent   # two checkouts, in turns

Paths, each on testroomopt.glb after one warm-up run of the same work:
  - direct: the fused kernel B1, assets/route.xml, 2^25 photons, 1 iteration;
  - pallas: traversal="pallas", sampler="native" (the gen-1 DFS B3), the same
    route and photons, 1 iteration;
  - config2: one lamp at (0, 0), 4 bounces, rho 0.25, one launch of 2^22
    photons (4 chunks of 2^20: B2 in counts mode, then 4 bounce segments);
  - config5: one lamp at (0, 0), 2^25 photons, texel density 2048 capped at
    2^25 slots, 1 iteration (32 B2 counts-mode launches and the texel
    binning of every chunk);
  - config4: one step of the route optimizer's objective and its gradient
    (CONFIGS.md section 4: assets/lange_route.xml, 12 waypoints, n_samples
    4, the CLI's bounds; 12 B2 launches of shadow rays);
  - config4b2: the same with the 2-bounce term (rho 0.25, 64 sources: 84
    B2 launches).
Each run is timed unprofiled (--repeat times: the median, and every run's
time) and traced once with torch.profiler; the script prints one JSON line
per path with both wall times (host clock around a synchronize), the device
time of the kernels grouped by name (the 8 largest, the rest summed), the
idle share 1 - device time / wall time against each wall time, the host's
time in the traced ops (self time, in total and the 10 largest; the
tracing inflates it), the device launches (every kernel and memset event
the trace recorded), and the card's name and power limit. The config-4
paths also time the estimator's `coherence_sort` on the first shadow-ray
batch the step sorts, where the tree has one: device ms a call (CUDA events
over 50 calls) and ms a call on the host's clock (50 calls between
synchronizes).

A root is a directory that holds a `uvtrace_torch/` package (this checkout,
or a `git archive` of another commit unpacked under a git-ignored
directory); each root runs in its own process, in the order given, and
builds its own kernels. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PATHS = ("direct", "pallas", "config2", "config5", "config4", "config4b2")


def _simulator(path: str, mesh, route):
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.sim import SimParams, Simulator

    if path == "config2":
        params = dataclasses.replace(SimParams(), photon_count=1 << 22, max_iterations=1, max_bounces=4,
                                     reflectance=0.25)
        return Simulator(mesh, params, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    if path == "config5":
        params = dataclasses.replace(SimParams(), photon_count=1 << 25, max_iterations=1, texel_density=2048.0,
                                     texel_max_slots=1 << 25)
        return Simulator(mesh, params, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    params = dataclasses.replace(route.apply_to(SimParams()), photon_count=1 << 25, max_iterations=1)
    if path == "pallas":
        params = dataclasses.replace(params, traversal="pallas", sampler="native")
    return Simulator(mesh, params, route=route.waypoints, device="cuda")


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(event, name, None)
        if v:
            return float(v)
    return 0.0


def _objective_step(path: str, mesh):
    """One evaluation of optimize_route's objective and its gradient, as
    uvtrace_torch/diff/optimize.py runs it (raw waypoints through the
    CLI's bounds, durations through a softmax)."""
    from uvtrace_torch import diff as D
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.sim import SimParams

    r = load_route_xml(os.path.join(ROOT, "assets", "lange_route.xml"))
    p = r.apply_to(SimParams())
    scene = D.make_diff_scene(mesh, device="cuda")
    lo, hi = mesh.aabb
    lo_t = torch.tensor([lo[0] + 0.1, lo[2] + 0.1], device="cuda")
    hi_t = torch.tensor([hi[0] - 0.1, hi[2] - 0.1], device="cuda")
    wp = torch.tensor([[w.x, w.y] for w in r.waypoints], device="cuda")
    raw = torch.logit(torch.clamp((wp - lo_t) / (hi_t - lo_t), 1e-4, 1 - 1e-4)).requires_grad_(True)
    durs = torch.tensor([w.duration for w in r.waypoints], device="cuda")
    logits = torch.log(durs / durs.sum()).requires_grad_(True)
    bounce = {}
    if path == "config4b2":
        bounce = dict(reflectance=torch.full((mesh.triangle_count,), 0.25, device="cuda"), areas=mesh.areas,
                      n_sources=64, n_bounces=2)
    mask = torch.from_numpy(mesh.areas > 0).cuda()

    def step():
        dose = D.route_dose(scene, lo_t + (hi_t - lo_t) * torch.sigmoid(raw), durs.sum() * torch.softmax(logits, 0),
                            mesh.floor_height + p.light_height, p.light_length, p.light_intensity, rng.PRNGKey(0),
                            n_samples=4, **bounce)
        torch.autograd.grad(-softmin(dose[mask], 5.0), (raw, logits))

    return step, {"waypoints": len(r.waypoints)}


def _coherence_sort_ms(run) -> dict:
    """ms a call of the estimator's coherence_sort on the first batch that
    one run of the step sorts: on the device (CUDA events) and on the host's
    clock (between synchronizes), 50 calls each. A tree whose estimator
    computes the sort key in its kernel K8 (diff/direct.py) has no such
    call: nothing is timed."""
    from uvtrace_torch.diff import estimator

    if not hasattr(estimator, "coherence_sort"):
        return {}
    seen, sort = [], estimator.coherence_sort

    def first(*args, **kwargs):
        if not seen:
            seen.append((args, kwargs))
        return sort(*args, **kwargs)

    estimator.coherence_sort = first
    try:
        run()
    finally:
        estimator.coherence_sort = sort
    args, kwargs = seen[0]
    sort(*args, **kwargs)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        sort(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        sort(*args, **kwargs)
    torch.cuda.synchronize()
    return {"coherence_sort_rays": args[0].shape[0], "coherence_sort_device_ms": start.elapsed_time(end) / 50,
            "coherence_sort_call_ms": (time.perf_counter() - t0) * 1e3 / 50}


def profile_path(path: str, mesh, route, card: str, repeat: int = 1) -> dict:
    if path.startswith("config4"):
        run, info = _objective_step(path, mesh)
    else:
        sim = _simulator(path, mesh, route)

        def run():
            sim.reset()
            sim.compute()

        info = {"photons": None}
    run()  # warm-up: the kernels' build and load, allocator growth
    torch.cuda.synchronize()
    runs_ms = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        runs_ms.append((time.perf_counter() - t0) * 1e3)
    unprofiled_ms = statistics.median(runs_ms)
    if path.startswith("config4"):
        info.update(_coherence_sort_ms(run))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if "photons" in info:
        info["photons"] = sim.photon_map_size
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        us = _device_us(e)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.key[:90]][0] += us / 1e3
            by_name[e.key[:90]][1] += e.count
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(v[0] for _, v in ranked)
    top = [{"kernel": k, "calls": c, "device_ms": ms} for k, (ms, c) in ranked[:8]]
    rest = ranked[8:]
    if rest:
        top.append({"kernel": "other", "calls": sum(c for _, (_, c) in rest),
                    "device_ms": sum(ms for _, (ms, _) in rest)})
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    info["host_ms"] = sum(e.self_cpu_time_total for e in host) / 1e3
    info["host_ops"] = [{"op": e.key[:60], "calls": e.count, "self_host_ms": e.self_cpu_time_total / 1e3}
                        for e in host[:10]]
    return {"path": path, **info, "wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms,
            "unprofiled_ms_runs": runs_ms, "device_ms": device_ms,
            "device_launches": sum(c for _, (_, c) in ranked),
            "idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
            "idle_share_unprofiled": 1.0 - device_ms / unprofiled_ms if device_ms else None,
            "kernels": top, "card": card}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", choices=PATHS, action="append")
    p.add_argument("--repeat", type=int, default=1, help="unprofiled runs a path (their median is reported)")
    p.add_argument("--root", action="append", help="a directory holding uvtrace_torch/ (default: this checkout)")
    p.add_argument("--one", help=argparse.SUPPRESS)  # measure this root in this process
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    paths = args.path or list(PATHS)
    if args.root and not args.one:
        for root in args.root:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root),
                   "--repeat", str(args.repeat)]
            rc = subprocess.run(cmd + [a for path in paths for a in ("--path", path)]).returncode
            if rc:
                return rc
        return 0
    pkg_root = args.one or ROOT
    sys.path.insert(0, pkg_root)
    import uvtrace_torch
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.io.routexml import load_route_xml

    if not os.path.samefile(os.path.dirname(uvtrace_torch.__file__), os.path.join(pkg_root, "uvtrace_torch")):
        raise SystemExit(f"imported {uvtrace_torch.__file__}, not the package under {pkg_root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    mesh = load_glb(os.path.join(ROOT, "assets", "testroomopt.glb"))
    route = load_route_xml(os.path.join(ROOT, "assets", "route.xml"))
    for path in paths:
        out = profile_path(path, mesh, route, card, args.repeat)
        print(json.dumps({"root": os.path.abspath(pkg_root), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
