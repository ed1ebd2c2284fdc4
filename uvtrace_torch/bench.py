"""Throughput benchmark of the port: the counterpart of the repo root's
bench.py, which imports jax.

    python -m uvtrace_torch.bench [--bounce | --scaling] [--platform cpu]
    python -m uvtrace_torch bench ...          # the same, through the CLI

Default mode prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}
(bench.py's keys and metric string) with the port's extra fields `device`,
`backend` and `hit_total` (`overflow` for the clustered backend): rays/s of
generate + extend + accumulate + shade on testroomopt.glb (44,866
triangles, clusters of 128 from the numpy builder, as bench.py clusters),
2^20 stratified rays an iteration, 20 iterations, the best of 3 runs with
`torch.cuda.synchronize()` before and after each. The environment chooses
what bench.py's does:
  UVTRACE_BENCH_BACKEND   mxu-fused (default; the fused kernel B1), mxu
                          (generate_stratified + the split kernel B2),
                          pallas (generate_stratified + the gen-1 DFS B3),
                          clustered (the budgeted clustered traversal at
                          budget 48, plain torch; its overflow is printed,
                          not audited, as bench.py does not audit it);
  UVTRACE_BENCH_RAYS      rays an iteration (default 2^20);
  UVTRACE_BENCH_ITERS     iterations a run (default 20);
  UVTRACE_BENCH_PRECISION accepted, computes f32 (the TPU's precision tiers
                          are not ported); set, it turns the pin gate off.
The fixed-seed hit total is a gate: on testroomopt at 2^20 rays and 5 or 20
iterations it must equal the JAX package's pin within 64 per 5 iterations
(`check_pinned_total`), else the run raises. The backend runs on the device
it is given: on the CPU the kernels' plain versions run, never a swap to
another backend.

`--bounce` prints the config-2 row (4 bounces, rho 0.5) through the
Simulator; `--scaling` one weak-scaling row per device count through the
sharded Simulator on spawned ranks (NCCL, one card a rank; gloo ranks on the
CPU with --platform cpu). NCCL refuses two ranks on one card, so a one-card
machine measures d = 1 only.

Baseline: the reference publishes no throughput; its one quantified
requirement is 335M photons in 5 minutes (Report §1.2), 1.118 Mrays/s, and
`vs_baseline` is measured against that floor.
"""

from __future__ import annotations

import argparse
import json
import os
import time

REQUIREMENT_RAYS_PER_SEC = 335_544_320 / 300.0  # Report §1.2 floor

# the JAX package's fixed-seed hit totals on testroomopt after 5 and 20
# launches of 2^20 stratified rays (keys fold_in(PRNGKey(0), i), lamp at
# (0, floor + 0.8, 0), 1 m rod; bench.py:146-164): the fused kernel draws its
# own photons, the split backends share generate_stratified's
PINNED_TOTALS = {
    (True, 5): 4_624_690,
    (True, 20): 18_499_935,
    (False, 5): 4_624_808,
    (False, 20): 18_500_845,
}
PIN_TOLERANCE = 64  # per 5 iterations: float-marginal hit/miss flips between backends
PIN_TRIANGLES, PIN_RAYS = 44866, 1 << 20
BACKENDS = ("mxu-fused", "mxu", "pallas", "clustered")
CLUSTERED_BUDGET = 48  # bench.py:100-103
SCALING_TIMEOUT = 1800.0  # seconds for one device count's ranks, start-up included


def check_pinned_total(total: int, fused: bool, iters: int) -> tuple[int, int]:
    """(pin, tolerance) after checking a summed hit total against the pin of
    `iters` (5 or 20) launches; raises RuntimeError (not assert: it survives
    python -O) when the total is outside the tolerance."""
    expected = PINNED_TOTALS[(fused, iters)]
    tol = PIN_TOLERANCE * (iters // 5)
    if abs(total - expected) > tol:
        raise RuntimeError(f"bench hit-count invariant violated: {total} vs {expected} "
                           f"(diff {total - expected}) — kernel correctness regression")
    return expected, tol


def _load_scene_mesh():
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.geometry.procedural import make_box_room

    scene_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                              "testroomopt.glb")
    if os.path.exists(scene_path):
        return load_glb(scene_path)
    return make_box_room(subdivisions=60, clutter=40)  # ~44k-tri stand-in


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _fence(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def headline_pipeline(mesh, backend: str, n: int, device="cuda"):
    """bench.py's per-iteration pipeline for `backend` on `device`: returns
    run(iters) -> (counts i32[T] summed over iterations 0 .. iters - 1, dose
    f32[T], overflow), iteration i drawing from fold_in(PRNGKey(0), i). The
    overflow is the clusters the clustered backend's budget dropped (a
    0-d device tensor), None for the kernels."""
    import numpy as np
    import torch

    from uvtrace_torch.device import resolve
    from uvtrace_torch.ops import accumulate as acc_ops
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import shade as shade_ops
    from uvtrace_torch.ops.cluster import build_clusters
    from uvtrace_torch.ops.generate import generate_stratified

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = resolve(device)
    t_count = mesh.triangle_count
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    areas = torch.from_numpy(np.asarray(mesh.areas, np.float32)).to(dev)
    cs = build_clusters(mesh.tris, cluster_size=128)  # the numpy builder, as bench.py
    slot_map = None
    if backend in ("mxu", "mxu-fused"):
        from uvtrace_torch.ops import traverse_mxu as tm

        scene = tm.build_mxu_scene(cs, device=dev)
        slot_map = scene.tri_idx_flat
        n_bins = int(slot_map.shape[0])
    elif backend == "pallas":
        from uvtrace_torch.ops import traverse_pallas as tp

        scene = tp.build_pallas_scene(cs, device=dev)
        n_bins = t_count
    else:
        from uvtrace_torch.ops import traverse_clustered as tc

        scene = tc.cluster_arrays(cs, device=dev)
        n_bins = t_count

    def one_iter(key):
        """(counts i32[n_bins], overflow or None) of one launch."""
        if backend == "mxu-fused":
            # generate + trace + histogram in ONE kernel; rays never touch memory
            return tm.fused_trace_counts(scene, key, lamp, 1.0, n)[2], None
        rays = generate_stratified(key, n, lamp, 1.0, packet=1024, device=dev)
        if backend == "mxu":
            return tm.traverse_mxu_counts(scene, rays.orig, rays.dir)[2], None  # histogrammed in the kernel
        if backend == "pallas":
            hit = tp.traverse_pallas(scene, rays.orig, rays.dir)[1]
            return acc_ops.hit_counts(hit, n_bins, "segment"), None
        _, hit, overflow = tc.traverse_clustered(scene, rays.orig, rays.dir, max_clusters=CLUSTERED_BUDGET,
                                                 return_overflow=True)
        return acc_ops.hit_counts(hit, n_bins, "segment"), overflow

    def run(iters: int):
        counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
        overflow = None
        for i in range(iters):
            c, ov = one_iter(rng.fold_in(rng.PRNGKey(0), i))
            counts += c
            if ov is not None:
                overflow = ov if overflow is None else overflow + ov
        if slot_map is not None:
            counts = acc_ops.slots_to_tri(counts, slot_map, t_count)
        dose = shade_ops.compute_dosage(counts, areas, n * iters, 45.0)
        return counts, dose, overflow

    return run


def main(device="cuda", scene_mesh=None) -> dict:
    """The headline: prints one JSON line and returns it as a dict. Reads
    UVTRACE_BENCH_BACKEND, _RAYS, _ITERS and _PRECISION as bench.py does;
    raises RuntimeError when the hit total misses its pin."""
    from uvtrace_torch.device import resolve

    dev = resolve(device)
    mesh = scene_mesh if scene_mesh is not None else _load_scene_mesh()
    backend = os.environ.get("UVTRACE_BENCH_BACKEND", "mxu-fused")
    n = int(os.environ.get("UVTRACE_BENCH_RAYS", 1 << 20))
    iters = int(os.environ.get("UVTRACE_BENCH_ITERS", 20))
    run = headline_pipeline(mesh, backend, n, dev)

    # one untimed run: it builds the kernels, and its counts feed the gate
    counts, _, overflow = run(iters)
    _fence(dev)
    total = int(counts.sum())
    if (mesh.triangle_count == PIN_TRIANGLES and n == PIN_RAYS and iters in (5, 20)
            and "UVTRACE_BENCH_PRECISION" not in os.environ):
        check_pinned_total(total, backend == "mxu-fused", iters)

    best = float("inf")
    for _ in range(3):
        _fence(dev)
        t0 = time.perf_counter()
        run(iters)
        _fence(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    rays_per_sec = n / best
    row = {
        "metric": "rays/sec/chip (generate+extend+accumulate+shade, testroom 45k tris)",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / REQUIREMENT_RAYS_PER_SEC, 3),
        "device": _device_name(dev),
        "backend": backend,
        "hit_total": total,
    }
    if overflow is not None:
        row["overflow"] = int(overflow)
    print(json.dumps(row), flush=True)
    return row


def bounce_row(n=None, bounces=4, reflectance=0.5, iters=3, scene_mesh=None, device="cuda") -> dict:
    """4-bounce diffuse + Russian-roulette throughput through the Simulator
    (BASELINE config 2): all-segment rays/s, the best of `iters` iterations
    after one warm-up. n defaults to 2^20 photons on a card, 2^13 on the CPU."""
    from uvtrace_torch.device import resolve
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.sim import SimParams, Simulator

    dev = resolve(device)
    if n is None:
        n = (1 << 20) if dev.type == "cuda" else (1 << 13)
    mesh = scene_mesh if scene_mesh is not None else _load_scene_mesh()
    sim = Simulator(
        mesh,
        SimParams(photon_count=n, max_iterations=iters + 1, max_bounces=bounces, reflectance=reflectance,
                  seed=0),
        route=[LightPos(0.0, 0.0, 1.0)],
        ray_chunk=min(n, 1 << 20),
        device=dev,
    )
    sim.run_iteration()  # warm-up: builds the kernels
    _fence(dev)
    best = float("inf")
    for _ in range(iters):
        _fence(dev)
        t0 = time.perf_counter()
        sim.run_iteration()
        _fence(dev)
        best = min(best, time.perf_counter() - t0)
    segs = sim._launch_n * (1 + bounces)
    return {
        "metric": f"all-segment rays/sec/chip ({bounces}-bounce diffuse+RR)",
        "value": round(segs / best, 1),
        "unit": "rays/s",
        "vs_baseline": round(sim._launch_n / best / REQUIREMENT_RAYS_PER_SEC, 3),
        "segments_per_photon": 1 + bounces,
        "device": _device_name(dev),
    }


def _scaling_rank(rank: int, world: int, platform: str, mesh, rays: int, iters: int):
    """One rank of a scaling row: the sharded Simulator on world x rays
    stratified photons. Returns (photons traced per iteration, seconds per
    iteration, backend)."""
    import torch
    import torch.distributed as dist

    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.parallel import make_ray_mesh
    from uvtrace_torch.sim import SimParams, Simulator

    dev = torch.device("cuda", rank) if platform == "cuda" else torch.device("cpu")
    sim = Simulator(
        mesh,
        SimParams(photon_count=world * rays, max_iterations=iters + 1, sampler="stratified"),
        route=[LightPos(0.0, 0.0, 1.0)],
        ray_chunk=min(rays, 1 << 20),
        device_mesh=make_ray_mesh(world),
        device=dev,
    )
    sim.run_iteration()  # warm-up: builds the kernels
    _fence(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        sim.run_iteration()
    _fence(dev)
    dist.barrier()
    return sim._launch_n, (time.perf_counter() - t0) / iters, sim.backend


def scaling_rows(device_counts=None, rays_per_device=None, iters=3, scene_mesh=None, device="cuda") -> list[dict]:
    """Weak scaling of the sharded Simulator (Simulator(device_mesh=
    make_ray_mesh(d)) -> sharded_launch_fn -> launch_counts) at each device
    count d: d spawned ranks, NCCL with one card a rank on "cuda", gloo on
    the CPU, each tracing rays_per_device photons an iteration. Rank 0's
    seconds per iteration, between a synchronize and a barrier, give the
    row; efficiency is against the first row. Returns the rows."""
    import torch

    from uvtrace_torch.device import resolve
    from uvtrace_torch.parallel import spawn

    dev = resolve(device)
    platform = dev.type
    avail = torch.cuda.device_count() if platform == "cuda" else 8
    if not device_counts:  # None or an empty --devices list
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    if max(device_counts) > avail:
        raise SystemExit(
            f"bench --scaling: {max(device_counts)} devices requested, {avail} visible "
            f"(platform {platform}); NCCL takes one card a rank: use --platform cpu for gloo ranks on the CPU")
    if rays_per_device is None:
        rays_per_device = (1 << 20) if platform == "cuda" else (1 << 13)
    if scene_mesh is not None:
        mesh = scene_mesh
    elif platform == "cpu":
        # smoke lane: gloo ranks validate the sharded path, not throughput;
        # a small procedural room keeps it fast
        from uvtrace_torch.geometry.procedural import make_box_room

        mesh = make_box_room(subdivisions=8, clutter=4, seed=0)
    else:
        mesh = _load_scene_mesh()

    rows = []
    base_per_dev = None
    for d in device_counts:
        launch_n, dt, backend = spawn(_scaling_rank, d, "nccl" if platform == "cuda" else "gloo",
                                      (platform, mesh, rays_per_device, iters), SCALING_TIMEOUT)[0]
        rate = launch_n / dt  # photons actually traced per iteration
        per_dev = rate / d
        if base_per_dev is None:
            base_per_dev = per_dev
        rows.append({
            "devices": d,
            "rays_per_sec": round(rate, 1),
            "rays_per_sec_per_device": round(per_dev, 1),
            "efficiency": round(per_dev / base_per_dev, 4),
            "backend": backend,
            "platform": platform,
            "device": _device_name(torch.device(platform, 0) if platform == "cuda" else dev),
        })
    return rows


def scaling_main(args):
    for row in scaling_rows(device_counts=args.devices, rays_per_device=args.rays, iters=args.iters,
                            device=args.platform):
        print(json.dumps(row), flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="uvtrace_torch throughput benchmark")
    p.add_argument("--scaling", action="store_true",
                   help="multi-device weak-scaling rows via the sharded Simulator "
                        "(one JSON row per device count, one spawned rank per device)")
    p.add_argument("--bounce", action="store_true",
                   help="4-bounce diffuse+RR all-segment throughput "
                        "(BASELINE config 2) instead of the direct pipeline")
    p.add_argument("--devices", type=int, nargs="*", default=None,
                   metavar="N", help="device counts to measure (default: "
                   "powers of two up to the visible cards, or 8 gloo ranks on the CPU)")
    p.add_argument("--rays", type=int, default=None,
                   help="photons per device per iteration")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--platform", choices=["cpu", "cuda"], default="cuda",
                   help="cuda (default) runs the kernels on the card; cpu runs their plain "
                        "versions, and --scaling on gloo ranks")
    return p.parse_args(argv)


def run_cli(argv=None):
    args = parse_args(argv)
    if args.scaling:
        scaling_main(args)
    elif args.bounce:
        print(json.dumps(bounce_row(n=args.rays, iters=args.iters, device=args.platform)), flush=True)
    else:
        main(device=args.platform)


if __name__ == "__main__":
    run_cli()
