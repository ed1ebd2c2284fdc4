"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line each; any failure exits
non-zero and prints no result:
  1. device: the card's name and power limit (nvidia-smi); no CUDA is an error;
  2. build: compile the kernels from uvtrace_torch/csrc;
  3. kernel vs plain: fused_trace_counts against its plain PyTorch version on
     the 45k-triangle test room (525 clusters of 128), at 2^16 rays and at the
     main path's chunk of 2^20 rays: equal rays, slots and t (rtol 1e-5) equal
     but for ties, edge flips and grazing rays (<= 0.1% of rays), every t
     within rtol 1e-3, counts and cluster visits equal within those (see
     kernel_vs_plain); both versions timed at 2^20 rays (the plain version
     on the very run whose outputs are checked);
  4. pinned total: 5 launches of 2^20 rays with keys fold_in(PRNGKey(0), i),
     lamp (0, floor + 0.8, 0), rod 1 m; the summed hits must equal the JAX
     kernel's pinned 4,624,690 (bench.py:146-164) within 64;
  5. main path: the port's Simulator on the test room with assets/route.xml
     (12 waypoints), 2^25 photons per iteration, 2 iterations, through the
     kernel (its launch counter must equal the launches the path makes), then
     the dose checks and Mrays/s over 4 more iterations;
  6. the kernels' JSON line, then {"ok": true, "device": {...}} last.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTROOM = os.path.join(ROOT, "assets", "testroomopt.glb")
ROUTE = os.path.join(ROOT, "assets", "route.xml")
PINNED_TOTAL, PINNED_TOL = 4_624_690, 64


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(scene, key, lamp, n: int):
    """fused_trace_counts against its plain version at n rays, on the card.

    The rays must be equal (both generate in f32 on the card). The kernel
    sums its f32 dot products in the order of the plain version's matmul, so
    t and slots agree but for ties, edge flips and grazing rays (t = t_num /
    t_den with t_den cancelling): at most 0.1% of rays may differ in slot or
    have t off by more than rtol 1e-5, a ray whose slot differs must still
    have t within rtol 1e-5, and every ray's t is within rtol 1e-3. Counts
    move by at most one per slot mismatch, cluster visits by at most one per
    disagreeing ray. Returns (stats, the kernel's visits per packet, the
    plain version's ms for this call, timed with CUDA events)."""
    import torch

    from uvtrace_torch.ops import traverse_mxu as tm

    kt, ks, kc, ko, kd, kv = tm.fused_trace_counts(scene, key, lamp, 1.0, n, with_rays=True,
                                                   with_visits=True)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(tm.fused_trace_counts_reference(
        scene, key, lamp, 1.0, n, with_rays=True, with_visits=True)), 1, warmup=False)
    pt, ps, pc, po, pd, pv = plain[0]
    if not (torch.equal(ko, po) and torch.equal(kd, pd)):
        fail(f"{n} rays: kernel rays differ from the plain version's "
             f"(max {(kd - pd).abs().max().item():.3g})")
    same = ks == ps
    mism = int((~same).sum())
    both = (ks >= 0) & (ps >= 0)  # a hit/miss flip counts as a slot mismatch
    t_rel = torch.where(both, (kt - pt).abs() / pt.abs(), 0.0)
    disagree = int((~same | (t_rel > 1e-5)).sum())
    t_rel_max = t_rel.max().item()
    if disagree > n // 1000 or (t_rel[~same] > 1e-5).any() or t_rel_max > 1e-3:
        fail(f"{n} rays: {mism} slot mismatches and {disagree} disagreeing rays, "
             f"t rel err {t_rel_max:.3g}")
    hits_k, hits_p = int(kc.sum()), int(pc.sum())
    count_diff = int((kc - pc).abs().sum())
    if (abs(hits_k - hits_p) > mism or count_diff > 2 * mism or int((ks >= 0).sum()) != hits_k
            or int((ps >= 0).sum()) != hits_p):
        fail(f"{n} rays: hits {hits_k} vs {hits_p}, per-slot count |diff| {count_diff}, "
             f"with {mism} slot mismatches")
    visits_k, visits_p = int(kv.sum()), int(pv.sum())
    if abs(visits_k - visits_p) > disagree:  # a shifted t can shift the packet bound
        fail(f"{n} rays: cluster visits {visits_k} vs {visits_p}")
    max_dt = (kt[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    return dict(slot_mismatches=mism, disagreeing=disagree, t_rel_max=f"{t_rel_max:.3g}",
                hits=f"{hits_k} vs {hits_p}", count_diff=count_diff,
                visits=f"{visits_k} vs {visits_p}", max_dt=max_dt), kv, plain_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        import uvtrace_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of a checkout: {e}")
    from uvtrace_torch import _build
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops.cluster import build_clusters
    from uvtrace_torch.sim import SimParams, Simulator, ViewMode

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    say(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} x{torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    ptxas = [ln.split(":", 1)[1].strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln]
    say(f"build: {time.perf_counter() - t0:.1f} s ({lib.name}; ptxas: {'; '.join(ptxas)})")

    # ---- 3. kernel vs plain on the card --------------------------------------
    mesh = load_glb(TESTROOM)
    scene = tm.build_mxu_scene(build_clusters(mesh.tris, cluster_size=128), device="cuda")
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    chunk = 1 << 20  # the main path's chunk: 1024 packets, stratum grid (4, 16, 16)
    t_err, checks = 0.0, []
    for n in (1 << 16, chunk):  # the 2^16 run warms the plain version before it is timed at 2^20
        stats, kv, plain_ms = kernel_vs_plain(scene, key, lamp, n)
        t_err = max(t_err, stats.pop("max_dt"))
        checks.append(f"2^{n.bit_length() - 1} rays: " + ", ".join(f"{k} {v}" for k, v in stats.items()))
    ms = cuda_ms(lambda: tm.fused_trace_counts(scene, key, lamp, 1.0, chunk), 20)
    say(f"kernel vs plain: rays equal; {'; '.join(checks)}; max |dt| on equal slots {t_err:.3g} | "
        f"2^20 rays: kernel {ms:.3f} ms ({chunk / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.1f} ms, "
        f"clusters visited per packet {kv.float().mean().item():.2f} "
        f"(max {int(kv.max())} of {scene.n_clusters}) [{card}]")

    # ---- 4. pinned total -----------------------------------------------------
    total = 0
    for i in range(5):
        total += int(tm.fused_trace_counts(scene, rng.fold_in(rng.PRNGKey(0), i), lamp, 1.0, chunk)[2].sum())
    diff = total - PINNED_TOTAL
    if abs(diff) > PINNED_TOL:
        fail(f"pinned total {total} vs {PINNED_TOTAL} (diff {diff})")
    say(f"pinned total: {total} vs {PINNED_TOTAL}, diff {diff} (tolerance {PINNED_TOL})")

    # ---- 5. main path --------------------------------------------------------
    route = load_route_xml(ROUTE)
    params = route.apply_to(SimParams())
    params = dataclasses.replace(params, photon_count=1 << 25, max_iterations=2)
    sim = Simulator(mesh, params, route=route.waypoints, device="cuda")
    ppl = sim.photons_per_light
    chunk_main = min(sim.ray_chunk, 1 << (ppl - 1).bit_length())
    expected = params.max_iterations * len(sim.route) * -(-ppl // chunk_main)
    tm.fused_trace_counts.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose = sim.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tm.fused_trace_counts.launches
    if launches != expected or launches == 0:
        fail(f"main path launched the kernel {launches} times, expected {expected}")
    dose_np = dose.cpu().numpy()
    irr = sim.dosage_map(ViewMode.MAX_POWER).cpu().numpy()
    hit_share = float((sim.photon_map > 0).float().mean())
    if dose_np.shape != (mesh.triangle_count,) or not (np.isfinite(dose_np).all() and np.isfinite(irr).all()):
        fail("dose map has the wrong shape or non-finite values")
    if dose_np.max() <= 0 or hit_share <= 0.8:
        fail(f"dose max {dose_np.max()}, triangles hit {hit_share:.3f} (need > 0.8)")
    t0 = time.perf_counter()
    sim.resume(extra_iterations=4)
    torch.cuda.synchronize()
    rate = 4 * len(sim.route) * sim._launch_n / (time.perf_counter() - t0)
    say(f"main path: {len(sim.route)} waypoints x 2 iterations, {sim._launch_n} rays per waypoint, "
        f"{launches} kernel launches (expected {expected}), {seconds:.2f} s, "
        f"{2 * len(sim.route) * sim._launch_n / seconds / 1e6:.1f} Mrays/s; dose max {dose_np.max():.4g} "
        f"mJ/cm^2, {hit_share:.3f} of triangles hit; 4 more iterations {rate / 1e6:.1f} Mrays/s "
        f"[{card}]")

    # ---- 6. result -------------------------------------------------------------
    say(json.dumps({"kernels": [{
        "name": "fused_trace_counts", "route": "cuda", "source": "uvtrace_torch/csrc/fused_trace.cu",
        "replaces": "uvtrace/ops/traverse_mxu.py:807", "launches": launches,
        "max_abs_err": t_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
