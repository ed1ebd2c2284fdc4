"""Where the device time of the port's dose paths goes, on an NVIDIA GPU.

    python3 scripts/torch_profile_paths.py                  # all four paths
    python3 scripts/torch_profile_paths.py --path pallas    # one of them

Paths, each on testroomopt.glb after one warm-up run of the same work:
  - direct: the fused kernel B1, assets/route.xml, 2^25 photons, 1 iteration;
  - pallas: traversal="pallas", sampler="native" (the gen-1 DFS B3), the same
    route and photons, 1 iteration;
  - config2: one lamp at (0, 0), 4 bounces, rho 0.25, one launch of 2^22
    photons (4 chunks of 2^20: B2 in counts mode, then 4 bounce segments);
  - config5: one lamp at (0, 0), 2^25 photons, texel density 2048 capped at
    2^25 slots, 1 iteration (32 B2 counts-mode launches and the texel
    binning of every chunk).
Each run is traced with torch.profiler; the script prints one JSON line per
path with the wall time (host clock around a synchronize), the device time of
the kernels grouped by name (the 8 largest, the rest summed), the idle share
1 - device time / wall time, and the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from uvtrace_torch.geometry.gltf import load_glb  # noqa: E402
from uvtrace_torch.io.routexml import LightPos, load_route_xml  # noqa: E402
from uvtrace_torch.sim import SimParams, Simulator  # noqa: E402

PATHS = ("direct", "pallas", "config2", "config5")


def _simulator(path: str, mesh, route):
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


def profile_path(path: str, mesh, route, card: str) -> dict:
    sim = _simulator(path, mesh, route)
    sim.compute()  # warm-up: the kernels' build and load, allocator growth
    sim.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.compute()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    return {"path": path, "photons": sim.photon_map_size, "wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms if device_ms else None, "kernels": top, "card": card}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--path", choices=PATHS, action="append")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    mesh = load_glb(os.path.join(ROOT, "assets", "testroomopt.glb"))
    route = load_route_xml(os.path.join(ROOT, "assets", "route.xml"))
    for path in args.path or PATHS:
        print(json.dumps(profile_path(path, mesh, route, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
