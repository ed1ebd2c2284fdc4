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
     the dose checks and Mrays/s over 4 more iterations; then one 2^20-ray
     launch per waypoint, timed, with its cluster visits per packet (mean,
     90th percentile, max);
  6. split kernel vs plain: traverse_mxu_padded (B2, a per-ray walk over the
     clusters' top tree) against its plain version on the test room, in
     counts mode at 1024-ray packets on the 2^20 stratified rays of
     generate_stratified, and in slots mode at 4096-ray packets on the first
     2^18 rays of a 2^20-ray first bounce segment (rho 0.25,
     coherence-sorted, parked dead lanes); phase 3's rules, the (ray, leaf)
     tests equal within L per disagreeing ray, bit equality reported; both
     versions timed, the kernel on the whole segment too, with its (ray,
     leaf) tests and the clusters each live ray needs (the plain version's t
     under the kernel's visit rule, `clusters_within`);
  7. split pinned total: phase 4's keys and lamp through generate_stratified
     + traverse_mxu_counts must give the JAX split path's pinned 4,624,808
     (bench.py:146-164) within 64;
  8. config 2 (BASELINE, CONFIGS.md section 2): the test room, one lamp at
     (0, 0), 2^25 photons, 4 diffuse bounces with Russian roulette, rho 0.25:
     one iteration, then one timed repeat from reset. B2 launches must equal
     chunks x (1 + 4) and B1's none, the dose must be finite, deposits over
     primary hits (the same photons without bounces) must lie in
     (1, (1 - 0.25^5) / (1 - 0.25)], and the repeat must give the same map;
     one 2^18-photon launch through the kernels and through their plain
     versions must give per-triangle counts whose |diff| sums to at most
     2 x (2^18 / 1000) for each of the 5 segments (phase 3's flip rule);
  9. probe grid: Simulator.dose_grid(256) on phase 5's Simulator, through B2
     (two launches: probes and the ceiling re-cast); its first hits equal the
     plain version's on the same probes but for ties (t within rtol 1e-5);
     one probe launch timed;
  10. gen-1 DFS vs plain: traverse_pallas (B3) against its plain version on
     the test room, at 2^16 stratified rays and 2^16 and 2^20 native iid
     rays: t, triangle ids and leaf statistics, phase 3's agreement rule
     (bit-equal expected); then 66 mixed packets, which must be bit-equal (t,
     ids, leaves, active columns): 64 stratified packets with every eighth
     column replaced by native iid rays (leaves with 1-3 active columns among
     full ones), a packet of parked dead lanes and a packet with a NaN ray;
     the kernel timed at 2^20 rays of each kind, the plain version on the
     checked 2^20 run;
  11. gen-1 pinned total: phase 4's keys and lamp through generate_stratified
     + traverse_pallas + hit_counts must give 4,624,808 within 64 (the same
     rays' closest hits as the split path's pin, bench.py:146-164);
  12. pallas main path: Simulator(traversal="pallas", sampler="native") on
     the test room with assets/route.xml, 2^25 photons per iteration
     (2,796,202 per waypoint: 3 chunks of 2^20, the last one masked): one
     iteration, then a timed repeat from reset that must give the same map.
     B3 launches must be 12 x 3 and B1's and B2's none; the dose finite,
     > 80% of triangles hit. Then one waypoint's launch (same key, same
     photons) through B2 (traversal "mxu"): per-triangle |diff| at most
     2 x n/1000;
  13. reference sampler: one iteration of phase 12's route through B3 with
     the reference's xorshift32 streams; the global seed after it must equal
     a host replay of advance_global_seed over the 12 waypoints, the mean
     dose within 1% of phase 12's;
  14. pallas bounces: one 2^18-photon native launch with 4 bounces (rho
     0.25) through B3 and through its plain version: per-triangle |diff|
     at most 5 x 2 x (2^18 / 1000), as phase 8;
  15. pallas probe grid: dose_grid(256) on phase 12's Simulator through B3
     (two launches); first hits equal the plain version's (ties within
     rtol 1e-5 allowed);
  16. calibration: calibrate_power(2909, 0.8, 1.0) on phase 12's Simulator
     must give a finite wattage of a few hundred W;
  17. config 5 (CONFIGS.md section 5 without shards): the test room, one lamp
     at (0, 0), 2^25 photons, texel density 2048 capped at 2^25 slots: one
     iteration, then a timed repeat from reset that must give the same
     triangle and texel maps. B2 launches must equal the 32 chunks (counts
     mode: an atlas turns the fused mode off), B1's and B3's none; each
     triangle's texels must sum exactly to its count in one chunk's
     launch_counts output; texel doses finite; peak device memory printed.
     Then dose_grid(4096) in the texel view: two B2 launches, timed, the
     share of cells with dose; its first hits equal the plain version's on
     2^16 of the probes but for ties (phase 9's rule). Then the host steps
     at this size, each timed: the atlas bake, its PNG, the texel .glb, the
     checkpoint, the 960x720 texel render and the per-triangle render;
  18. texel launches, kernels vs plain versions: one 2^18-photon launch with
     config 5's atlas through B2 and through its plain version, and through
     B3 (traversal "pallas", triangle space) and its plain version: each
     triangle's texels sum exactly to its count, triangle counts within
     2 x n/1000, texel counts within 0.2% of the hits (the CPU tests' rule);
  19. the CLI on the card: `compute` of config 5 with --no-render and
     --dose-grid 4096 (dose_texels.npy, irradiance_texels.npy,
     texel_atlas.npz, dose_grid.npy/png and the JSON line's tex_* fields
     checked); `compute` of the test room with assets/route.xml, 2^22
     photons, texel density 256, --export-glb --checkpoint (every PNG decoded
     and its size checked, both .glb files loaded back); `render` of its
     checkpoint; `compute --resume` extending it by one iteration. Files go
     to build/chip_smoke/ and are removed after the phase;
  21. the differentiable layer's shadow rays, B2 vs plain: one waypoint of
     assets/lange_route.xml on the test room, the rays of each kind as
     `_visibility` receives them (rod to triangle samples, 4 x 44,866; the
     64 x 64 source-to-source rays; one receiver chunk of 16 x 179,464 rays
     that start on surfaces), sorted and padded as B2 gets them: t and
     slots by phase 3's rule, visibility bits equal but on at most 0.1% of
     rays, and no ray that the plain version finds occluded visible to the
     kernel; B2 timed per 2^20 rays of each kind, with its bound;
  22. config 4 (CONFIGS.md section 4), the direct objective at full width:
     optimize_route on the test room with lange_route.xml (12 waypoints),
     n_samples 4, lr 0.05, the CLI's bounds, 1 warm-up and 5 timed steps
     between synchronize fences (s/step); B2 launches must equal 12 per step
     and the final dose, B1's and B3's none; loss, waypoints and gradients
     finite and not zero; the device time of one step (profiler) and the
     idle share of the unprofiled step; autograd of mean(irradiance) against
     central FD in lamp x and z (eps 1e-3, rtol 0.08, atol 1e-5);
  23. config 4 with interreflection (rho 0.25, 64 sources): 2 bounces, 1
     warm-up and 2 timed steps; 4 bounces, 1 timed step; s/step, B2
     launches (7 a waypoint), peak device memory, finite results;
  24. the dose image: plan_dose_image(128) and dose_image over the 12
     waypoints (n_samples 8) with the gradient of the worst lit pixel,
     timed; 14 B2 launches; the plan's first hits equal the plain version's
     but for ties, and every pixel that waypoint 0's rod sees (the plain
     version's visibility) has dose;
  25. optimize-route (--steps 3) and dose-image (--res 128) through the CLI:
     the route XML loads back with 12 waypoints and the total duration
     within 1e-4, dose_image.npy 128 x 128 and finite, the PNG decodes,
     gradients.npz holds (12, 2) and (12,); files under build/chip_smoke/,
     removed after;
  26. the native cluster builder (built at phase 2, where g++ must be
     there: the Simulator and phases 3-25 cluster with it): the test room's
     clusters twice (equal) and the 443,328-triangle box room's, with the
     numpy builder's beside them, build seconds; B1, B2 and B3 at 2^20 rays
     on the box room's clusters of both builders in turns, hit totals within
     0.1%;
  27. one NCCL rank: initialize() with a world of 1 on cuda:0, config 5's
     Simulator (phase 17) on a 1 x 1 rays x texels mesh: phase 17's triangle
     and texel maps bit for bit, its seconds per iteration beside phase
     17's, nothing staged through the host;
  28. the CLI under `python -m torch.distributed.run --nproc-per-node 1`:
     config 5's command line at 2^22 photons and texel density 256 with
     --shards -1: the five maps of the unsharded CLI bit for bit, one JSON
     line;
  29. two ranks that share cuda:0 over gloo (NCCL refuses two ranks on one
     card; the collectives stage through the host, bytes and seconds
     counted), spawned: config 5 at full width on a 1 x 2 mesh (16 B2
     launches a rank, half the slots each, peak device memory per rank),
     its dose_grid(4096), the test room's route (2^22 photons, chunks of
     2^18) on a 2 x 1 mesh through B1, B3 and B2 with 2 bounces, and config
     4's direct step with the shadow rays on both ranks: each bit-equal to
     one rank (phases 17 and 22, and one-rank runs of the route). Two ranks
     on one card measure correctness and memory, not scaling;
  30. the clustered traversal's pinned totals (plain torch, no kernel; the
     B1/B2/B3 counters must stay 0): phase 4's keys and lamp, 20 launches of
     2^20 stratified rays at budget 48 (bench.py:100-103): 4,624,808 within
     64 after 5 and 18,500,845 within 256 after 20, the overflow and the
     seconds printed;
  31. the clustered traversal against B3 on the same rays: 2^20 stratified
     rays from budget 32 and 2^18 native iid rays from budget 512, each
     escalated x 4 while it drops clusters (every step's overflow and time
     printed), closest hits by phase 3's rule; then
     Simulator(max_clusters=1) on those iid rays (2^18 photons, one lamp):
     the RuntimeWarnings caught and shown, and the counts after the
     escalations equal to the budget-free counts;
  32. the fine-BVH walk (traversal "jax", build_bvh_native with leaves of at
     most 8) on 2^20 stratified and 2^20 native rays against B3, timed, its
     lockstep steps printed;
  33. Simulator(traversal="clustered") at full width: route.xml's first
     waypoint at 2^25 photons and the whole route at 2^22, each against
     traversal "pallas" from the same photons (per-triangle |diff| at most
     2 x n/1000), s per iteration with the escalations; the 256^2 probe grid
     through the audited clustered probes, first hits against B3's but for
     ties;
  34. make_diff_scene(backend="clustered") (budget-free): config 4's direct
     objective at lange_route.xml's first waypoint, loss and waypoint
     gradient equal to backend "auto"'s (B2) within rtol 2e-3, timed;
  35. `compute --traversal clustered` and `--traversal jax` through the CLI
     at 2^20 photons;
  36. the kernels' JSON line (times, plain times and bounds of all three
     kernels; B2's bounce segment, config 5's and config 4's launches and
     its shadow rays under keys of their own, the launches per rank of the
     sharded phases, the 443k times on native and numpy clusters), then
     {"ok": true, "device": {...}} last.
The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its f32 operations over 67
TFLOP/s, the H100's published peaks at 700 W. The operations are counted
from this run's data, on real triangles (a cluster's slots in use, not its
padding): B1's from the clusters its packets visit (the plain version's
frustum order, the kernel's visit counts) x 1024 rays x 80 flops, B3's from
its active columns x 8 rays x the cluster's triangles x 46 flops (the plain
version's walk, weighted), B2's from the work its inputs need whatever walks
them, the triangles of the clusters each ray needs x 80 flops. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTROOM = os.path.join(ROOT, "assets", "testroomopt.glb")
ROUTE = os.path.join(ROOT, "assets", "route.xml")
LANGE_ROUTE = os.path.join(ROOT, "assets", "lange_route.xml")
PINNED_TOTAL, PINNED_TOL = 4_624_690, 64
PINNED_SPLIT_TOTAL = 4_624_808
# the split path's pins at 5 and 20 x 2^20 rays, which the JAX package's
# budgeted clustered backend made (bench.py:146-164)
PINNED_CLUSTERED = {5: PINNED_SPLIT_TOTAL, 20: 18_500_845}
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12  # H100 SXM at 700 W: HBM3 bytes/s, dense f32 FLOP/s
# f32 operations per ray-triangle test of the Plücker kernels (4 dot products
# of 10 multiply-adds) and of Möller-Trumbore in B3 (2 flops per cross
# product term, 5 per dot product, 1 division, 3 subtractions, the u + v sum)
FLOPS_PLUCKER, FLOPS_MT = 80, 46


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


def agree(label: str, k, p, n: int, with_visits: bool = True, visits_per_ray: int = 1):
    """A kernel's (t, slot, counts, visits) against its plain version's on
    the same rays. The kernel sums its f32 dot products in the order of the
    plain version's matmul, so t and slots agree but for ties, edge flips
    and grazing rays (t = t_num / t_den with t_den cancelling): at most 0.1%
    of rays may differ in slot or have t off by more than rtol 1e-5, a ray
    whose slot differs must still have t within rtol 1e-5, and every ray's t
    is within rtol 1e-3. Counts move by at most one per slot mismatch,
    visits by at most visits_per_ray per disagreeing ray (one packet visit
    for B1, whose packet bound a shifted t can shift; up to every cluster
    for B2's per-ray walk). Returns the stats and the max |dt| on equal
    slots."""
    import torch

    (kt, ks, kc), (pt, ps, pc) = k[:3], p[:3]
    same = ks == ps
    mism = int((~same).sum())
    both = (ks >= 0) & (ps >= 0)  # a hit/miss flip counts as a slot mismatch
    t_rel = torch.where(both, (kt - pt).abs() / pt.abs(), 0.0)
    disagree = int((~same | (t_rel > 1e-5)).sum())
    t_rel_max = t_rel.max().item()
    if disagree > n // 1000 or (t_rel[~same] > 1e-5).any() or t_rel_max > 1e-3:
        fail(f"{label}: {mism} slot mismatches and {disagree} disagreeing rays, t rel err {t_rel_max:.3g}")
    hits_k, hits_p = int(kc.sum()), int(pc.sum())
    count_diff = int((kc - pc).abs().sum())
    if (abs(hits_k - hits_p) > mism or count_diff > 2 * mism or int((ks >= 0).sum()) != hits_k
            or int((ps >= 0).sum()) != hits_p):
        fail(f"{label}: hits {hits_k} vs {hits_p}, per-slot count |diff| {count_diff}, "
             f"with {mism} slot mismatches")
    stats = dict(slot_mismatches=mism, disagreeing=disagree, t_rel_max=f"{t_rel_max:.3g}",
                 hits=f"{hits_k} vs {hits_p}", count_diff=count_diff)
    if with_visits:
        visits_k, visits_p = int(k[3].sum()), int(p[3].sum())
        if abs(visits_k - visits_p) > visits_per_ray * disagree:
            fail(f"{label}: cluster visits {visits_k} vs {visits_p}")
        stats["visits"] = f"{visits_k} vs {visits_p}"
    max_dt = (kt[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    return stats, max_dt


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes: float, flops: float):
    """(bound ms, what bounds it): the least time the card could take."""
    b_ms, f_ms = n_bytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def kernel_vs_plain(scene, key, lamp, n: int):
    """fused_trace_counts against its plain version at n rays, on the card:
    the rays must be equal (both generate in f32 on the card), the rest
    agrees as `agree` says. Returns (stats, the kernel's visits per packet,
    the plain version's ms for this call, timed with CUDA events)."""
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
    stats, max_dt = agree(f"{n} rays", (kt, ks, kc, kv), (pt, ps, pc, pv), n)
    return dict(stats, max_dt=max_dt), kv, plain_ms


def first_hits_vs_plain(scene, po, pd, lo_y: float, hi_y: float):
    """The ceiling-skipping first hits of probes through B2 and through its
    plain version: (probes whose hits differ, whether each is a t tie).
    Fails past phase 9's rule (at most one probe in 1000, ties only)."""
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops.probes import first_hits_skip_ceiling

    hits = {}
    for name, fn in (("kernel", tm.traverse_mxu_slots), ("plain", tm.traverse_mxu_padded_reference)):
        hits[name] = first_hits_skip_ceiling(lambda o, d: fn(scene, o, d)[:2], po, pd, lo_y, hi_y)
    (kt, ks), (pt, ps) = hits["kernel"], hits["plain"]
    differ = ks != ps
    both = (ks >= 0) & (ps >= 0)
    tie_ok = bool((both[differ] & ((kt - pt).abs() <= 1e-5 * pt.abs())[differ]).all())
    if int(differ.sum()) > po.shape[0] // 1000 or not tie_ok:
        fail(f"probe first hits: {int(differ.sum())} differ from the plain version's (ties only: {tie_ok})")
    return int(differ.sum())


def per_triangle(atlas, tex_counts, t_count: int):
    """i64[T] the texel counts summed over each triangle's slots."""
    import torch

    from uvtrace_torch.ops.texel import slot_triangles

    out = torch.zeros(t_count, dtype=torch.int64, device=tex_counts.device)
    return out.index_add_(0, slot_triangles(atlas).long(), tex_counts.long())


def texel_launch(sim, trace: dict, key, lamp, n: int):
    """One launch of n photons in one chunk with sim's atlas, through the
    trace functions `trace`: (counts, texel counts)."""
    from uvtrace_torch.sim.launch import launch_counts

    return launch_counts(sim.scene, key, lamp, 1.0, t_count=sim.triangle_count, n=n, chunk=n,
                         atlas=sim._atlas_launch, n_texels=sim._n_texels, tri_v0=sim._tri_v0,
                         tri_e1=sim._tri_e1, tri_e2=sim._tri_e2, slot_map=sim._slot_map, **trace)[:2]


def run_cli(argv) -> dict:
    """`python -m uvtrace_torch` in this process; the JSON line it prints."""
    from uvtrace_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"uvtrace_torch {' '.join(argv[:2])} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_group(cmd, timeout: float):
    """(returncode, stdout, stderr) of a command run from the checkout's root
    in a session of its own, which is killed whole if it outlives timeout."""
    import signal

    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env={**os.environ, "PYTHONPATH": ROOT})
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(cmd[:6])} did not finish within {timeout} s")
    return proc.returncode, out, err


def device_ms_of(fn) -> float:
    """Device time (ms) of the kernels that one call of fn runs, from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3


def shadow_vs_plain(label: str, trav, rod, qs, reps: int):
    """One batch of the estimator's shadow rays (from points rod to surface
    points qs, as `_visibility` makes them, sorted and padded as B2 gets
    them) through B2 and through its plain version: t and slots equal but
    for ties (phase 3's rule), visibility bits equal but on at most 0.1% of
    rays, and no ray that the plain version finds occluded (t < dist (1 -
    eps) - eps) visible to the kernel: that would be a lost occluder.
    Returns (stats, kernel ms per 2^20 rays, plain ms per 2^20 rays, bound
    ms per 2^20 rays, bound_by, max |dt| on equal slots)."""
    import torch

    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch.ops import traverse_mxu as tm

    orig, dirs, dist = est.shadow_rays(rod, qs)
    o, d, idx = est.pack_shadow_rays(orig, dirs)
    r, n = orig.shape[0], o.shape[0]
    kt, ks = tm.traverse_mxu_slots(trav, o, d, packet=est.SHADOW_PACKET)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(tm.traverse_mxu_padded_reference(trav, o, d, packet=est.SHADOW_PACKET)),
                       1, warmup=False)
    pt, ps = plain[0]
    same = ks == ps
    both = (ks >= 0) & (ps >= 0)
    t_rel = torch.where(both, (kt - pt).abs() / pt.abs(), 0.0)
    disagree = int((~same | (t_rel > 1e-5)).sum())
    thr = (dist.reshape(-1) * (1.0 - 1e-3) - 1e-3)[idx]
    vis_k, vis_p = kt[:r] >= thr, pt[:r] >= thr
    vis_differ = int((vis_k != vis_p).sum())
    lost = int((vis_k & ~vis_p).sum())
    t_rel_max = t_rel.max().item()
    if (disagree > n // 1000 or (t_rel[~same] > 1e-5).any() or t_rel_max > 1e-3 or vis_differ > n // 1000
            or lost):
        fail(f"{label} shadow rays, B2 vs plain: {int((~same).sum())} slot mismatches, {disagree} disagreeing rays, "
             f"t rel err {t_rel_max:.3g}, {vis_differ} visibility bits differ, {lost} occluders lost")
    ms = cuda_ms(lambda: tm.traverse_mxu_slots(trav, o, d, packet=est.SHADOW_PACKET), reps)
    needed_tris = tm.clusters_within(trav, o, d, pt, triangles=True)
    bound = roofline(nbytes(o, d, trav.node_box, trav.node_meta, trav.tri_feat) + 8 * n,
                     float(needed_tris.sum()) * FLOPS_PLUCKER)
    per = (1 << 20) / n
    stats = dict(rays=f"{r} ({n} padded)", slot_mismatches=int((~same).sum()), disagreeing=disagree,
                 t_rel_max=f"{t_rel_max:.3g}", visibility_differs=vis_differ, occluded=int((~vis_p).sum()),
                 lost_occluders=lost, triangles_needed_per_ray=f"{needed_tris.sum().item() / r:.1f}")
    max_dt = (kt[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    return stats, ms * per, plain_ms * per, bound[0] * per, bound[1], max_dt


def config4_step(mesh, dscene, device):
    """One step of config 4's direct objective by hand (assets/
    lange_route.xml, the CLI's bounds and clipped start, key PRNGKey(0)):
    step(**route_dose kwargs) -> (loss, (d loss / d raw waypoints, d loss /
    d duration logits))."""
    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.sim import SimParams

    route4 = load_route_xml(LANGE_ROUTE)
    p4 = route4.apply_to(SimParams())
    base_y, rod_len, power = mesh.floor_height + p4.light_height, p4.light_length, p4.light_intensity
    lo, hi = mesh.aabb
    bounds = ((float(lo[0]) + 0.1, float(lo[2]) + 0.1), (float(hi[0]) - 0.1, float(hi[2]) - 0.1))
    wp0 = np.clip(np.array([[w.x, w.y] for w in route4.waypoints], np.float32),
                  np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
    durs0 = np.array([w.duration for w in route4.waypoints], np.float32)
    lo_t, hi_t = torch.tensor(bounds[0], device=device), torch.tensor(bounds[1], device=device)
    raw = torch.logit(torch.clamp((torch.tensor(wp0, device=device) - lo_t) / (hi_t - lo_t), 1e-4, 1 - 1e-4))
    raw.requires_grad_(True)
    total_time = float(durs0.sum())
    logits = torch.log(torch.tensor(durs0, device=device) / total_time).requires_grad_(True)
    mask = torch.linalg.norm(torch.cross(dscene.e1, dscene.e2, dim=-1), dim=-1) > 0

    def step(**kw):
        dose = D.route_dose(dscene, lo_t + (hi_t - lo_t) * torch.sigmoid(raw), total_time * torch.softmax(logits, 0),
                            base_y, rod_len, power, rng.PRNGKey(0), **kw)
        loss = -softmin(dose[mask], 5.0)
        return loss, torch.autograd.grad(loss, (raw, logits))

    return step


def diff_phases(mesh, card: str, out_dir: str) -> dict:
    """Phases 21-25: the differentiable layer (config 4) on the card.
    Returns the numbers of B2's shadow rays for the kernels' line."""
    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.png import read_png
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays
    from uvtrace_torch.sim import SimParams

    def zero_counters():
        torch.cuda.synchronize()
        tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0

    def counters():
        return tm.traverse_mxu_padded.launches, tm.fused_trace_counts.launches, tp.traverse_pallas.launches

    route4 = load_route_xml(LANGE_ROUTE)
    p4 = route4.apply_to(SimParams())
    n_wp = len(route4.waypoints)
    base_y, rod_len, power = mesh.floor_height + p4.light_height, p4.light_length, p4.light_intensity
    t0 = time.perf_counter()
    dscene = D.make_diff_scene(mesh, device="cuda")
    setup_s = time.perf_counter() - t0
    trav = dscene.trav_scene
    t_count = mesh.triangle_count
    # the CLI's bounds and clipped start (uvtrace/cli.py:382-401)
    lo, hi = mesh.aabb
    bounds = ((float(lo[0]) + 0.1, float(lo[2]) + 0.1), (float(hi[0]) - 0.1, float(hi[2]) - 0.1))
    wp0 = np.clip(np.array([[w.x, w.y] for w in route4.waypoints], np.float32),
                  np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
    durs0 = np.array([w.duration for w in route4.waypoints], np.float32)
    rho4 = torch.full((t_count,), 0.25, device="cuda")
    out = {}

    # ---- 21. the diff layer's shadow rays, B2 vs plain ----------------------------------------
    recorded = []
    visibility = est._visibility

    def record(scene_, rod, qs, eps=1e-3):
        recorded.append((rod.detach(), qs.detach()))
        return visibility(scene_, rod, qs, eps)

    key0 = rng.fold_in(rng.PRNGKey(0), 0)
    xz0 = torch.tensor(wp0[0], device="cuda")
    est._visibility = record
    try:
        with torch.no_grad():
            D.irradiance(dscene, xz0, base_y, rod_len, power, key0, n_samples=4)
            D.bounce_irradiance(dscene, xz0, base_y, rod_len, power, rho4, mesh.areas, rng.fold_in(key0, 1),
                                n_samples=4, n_sources=64, n_bounces=2)
    finally:
        est._visibility = visibility
    if len(recorded) != 1 + 2 + 4:
        fail(f"one waypoint's objective with 2 bounces made {len(recorded)} shadow-ray batches, expected 7")
    lines21, t_err = [], 0.0
    for label, (rod, qs), reps in (("direct", recorded[0], 5), ("source-to-source", recorded[2], 20),
                                   ("receiver chunk", recorded[3], 3)):
        stats, ms, plain_ms, bound_ms, bound_by, max_dt = shadow_vs_plain(label, trav, rod, qs, reps)
        t_err = max(t_err, max_dt)
        out[label] = (ms, plain_ms, bound_ms, bound_by)
        lines21.append(f"{label}: " + ", ".join(f"{k} {v}" for k, v in stats.items())
                       + f"; per 2^20 rays kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})")
    out["max_dt"] = t_err
    say(f"diff shadow rays, B2 vs plain (testroomopt, lange_route waypoint 0, rho 0.25): {' | '.join(lines21)}; "
        f"max |dt| on equal slots {t_err:.3g} [{card}]")
    del recorded

    # ---- 22. config 4, direct objective at full width --------------------------------------------
    stamps = []

    def tick(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    zero_counters()
    res = D.optimize_route(dscene, wp0, durs0, base_y, rod_len, power, steps=6, learning_rate=0.05, n_samples=4,
                           bounds=bounds, progress=tick)
    launches22 = counters()
    step_s = (stamps[-1] - stamps[0]) / 5
    if launches22 != (n_wp * 7, 0, 0):
        fail(f"config 4 direct: B2, B1, B3 launched {launches22} times, expected ({n_wp * 7}, 0, 0)")
    if not (np.isfinite(res.history).all() and np.isfinite(res.waypoints_xz).all()
            and np.isfinite(res.final_dose_masked).all()):
        fail(f"config 4 direct: loss {res.history}, waypoints finite {np.isfinite(res.waypoints_xz).all()}")
    # one step of the objective by hand: its gradients, and its device time under the profiler
    step = config4_step(mesh, dscene, "cuda")
    loss, (g_raw, g_lg) = step(n_samples=4)
    if not (torch.isfinite(g_raw).all() and torch.isfinite(g_lg).all() and g_raw.abs().max() > 0
            and g_lg.abs().max() > 0):
        fail(f"config 4 direct: gradients not finite or zero ({g_raw.abs().max().item()}, {g_lg.abs().max().item()})")
    out["step"] = dict(loss=loss.item(), g_raw=g_raw.cpu().numpy(), g_lg=g_lg.cpu().numpy())
    dev_ms = device_ms_of(lambda: step(n_samples=4))
    idle = 1.0 - dev_ms / (step_s * 1e3)

    def mean_irr(xz):
        return D.irradiance(dscene, xz, base_y, rod_len, power, key0, n_samples=4).mean()

    xz = xz0.clone().requires_grad_(True)
    g = torch.autograd.grad(mean_irr(xz), xz)[0]
    fd_lines = []
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, device="cuda")
            e[i] = 1e-3
            fd = (mean_irr(xz0 + e) - mean_irr(xz0 - e)).item() / 2e-3
            if abs(g[i].item() - fd) > 1e-5 + 0.08 * abs(fd):
                fail(f"config 4: d mean(irradiance) / d lamp {'xz'[i]}: autograd {g[i].item():.6g}, central FD "
                     f"{fd:.6g} (rtol 0.08, atol 1e-5)")
            fd_lines.append(f"{'xz'[i]} {g[i].item():.5g} vs FD {fd:.5g}")
    out["direct_step_s"] = step_s
    say(f"config 4, direct objective: testroomopt, assets/lange_route.xml ({n_wp} waypoints), n_samples 4, lr 0.05, "
        f"CLI bounds: scene set-up {setup_s:.2f} s; 1 warm-up + 5 timed steps {step_s:.4f} s/step; B2 launches "
        f"{launches22[0]} (6 steps + the final dose, {n_wp} each), no B1/B3; device time of one step "
        f"{dev_ms:.2f} ms (profiler), idle share {idle:.3f} of the unprofiled step; loss {res.history[0]:.5g} -> "
        f"{res.history[-1]:.5g}; |grad| waypoints {g_raw.norm().item():.4g}, durations {g_lg.norm().item():.4g}; "
        f"autograd vs central FD of mean(irradiance) at waypoint 0: {', '.join(fd_lines)} [{card}]")

    # ---- 23. config 4 with interreflection -----------------------------------------------------
    lines23 = []
    for n_bounces, steps in ((2, 3), (4, 1)):
        stamps.clear()
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = D.optimize_route(dscene, wp0, durs0, base_y, rod_len, power, steps=steps, learning_rate=0.05,
                               n_samples=4, bounds=bounds, progress=tick, reflectance=0.25, areas=mesh.areas,
                               n_sources=64, n_bounces=n_bounces)
        peak = torch.cuda.max_memory_allocated()
        launches23 = counters()
        s_step = (stamps[-1] - stamps[0]) / (steps - 1) if steps > 1 else stamps[0] - t0
        expected = n_wp * 7 * (steps + 1)  # direct, source direct, source-to-source, 4 receiver chunks
        if launches23 != (expected, 0, 0):
            fail(f"config 4, {n_bounces} bounces: B2, B1, B3 launched {launches23} times, expected ({expected}, 0, 0)")
        if not (np.isfinite(res.history).all() and np.isfinite(res.waypoints_xz).all()
                and np.isfinite(res.durations).all()):
            fail(f"config 4, {n_bounces} bounces: loss {res.history}, waypoints or durations not finite")
        out[f"bounce{n_bounces}_step_s"] = s_step
        lines23.append(f"{n_bounces} bounces: {'1 warm-up + 2 timed steps' if steps > 1 else '1 timed step'} "
                       f"{s_step:.3f} s/step, {launches23[0]} B2 launches, peak device memory {peak / 2**30:.2f} GiB, "
                       f"loss {res.history[0]:.5g}")
    say(f"config 4 with interreflection (rho 0.25, 64 sources): {' | '.join(lines23)} [{card}]")

    # ---- 24. dose image ----------------------------------------------------------------------
    wp_t = torch.tensor(wp0, device="cuda", requires_grad=True)
    durs_t = torch.tensor(durs0, device="cuda", requires_grad=True)
    zero_counters()
    t0 = time.perf_counter()
    plan = D.plan_dose_image(dscene, res=128)
    img = D.dose_image(dscene, plan, wp_t, durs_t, base_y, rod_len, power, rng.PRNGKey(0), n_samples=8)
    flat = img.reshape(-1)
    lit = plan.mask & (flat > 0)
    g_wp, g_durs = torch.autograd.grad(softmin(torch.where(lit, flat, 1e9), 5.0), (wp_t, durs_t))
    img_np = img.detach().cpu().numpy()
    image_s = time.perf_counter() - t0
    launches24 = counters()
    if launches24 != (2 + n_wp, 0, 0):
        fail(f"dose image: B2, B1, B3 launched {launches24} times, expected ({2 + n_wp}, 0, 0)")
    if not (img_np.shape == (128, 128) and np.isfinite(img_np).all() and torch.isfinite(g_wp).all()
            and torch.isfinite(g_durs).all() and g_wp.abs().max() > 0):
        fail(f"dose image: shape {img_np.shape}, finite {np.isfinite(img_np).all()}, gradients finite "
             f"{bool(torch.isfinite(g_wp).all())}")
    # the plan's first hits against the plain version's on the same probes (phase 9's rule)
    verts = mesh.tris.reshape(-1, 3)
    po, pd = probe_rays(verts.min(0), verts.max(0), 128, device="cuda")
    hits = {}
    for name, fn in (("kernel", lambda o, d: est.extend_shadow_rays(trav, o, d)),
                     ("plain", lambda o, d: tm.traverse_mxu_padded_reference(trav, o, d))):
        hits[name] = first_hits_skip_ceiling(fn, po, pd, float(verts.min(0)[1]), float(verts.max(0)[1]))
    (kt, ks), (pt, ps) = hits["kernel"], hits["plain"]
    differ = ks != ps
    both = (ks >= 0) & (ps >= 0)
    tie_ok = bool((both[differ] & ((kt - pt).abs() <= 1e-5 * pt.abs())[differ]).all())
    plan_tri = torch.where(ks >= 0, trav.tri_idx_flat[ks.clamp_min(0).long()], -1)
    if int(differ.sum()) > po.shape[0] // 1000 or not tie_ok or not torch.equal(plan_tri, plan.tri.long()):
        fail(f"dose image plan: {int(differ.sum())} first hits differ from the plain version's (ties only: "
             f"{tie_ok}), plan equals the kernel's hits: {torch.equal(plan_tri, plan.tri.long())}")
    # pixels that waypoint 0's rod sees (the plain version's visibility) must have dose
    u_rod = rng.uniform(rng.fold_in(rng.PRNGKey(0), 0), (8, 1), "cuda")
    rod = est._rod_points(torch.tensor(wp0[0], device="cuda"), base_y, rod_len, u_rod)
    orig, dirs, dist = est.shadow_rays(rod, plan.points[None].expand(8, -1, 3))
    seen = est.visible(tm.traverse_mxu_padded_reference(trav, orig, dirs)[0], dist).amax(0).bool() & plan.mask
    dark_seen = int((seen & (flat.detach() <= 0)).sum())
    if dark_seen or int(seen.sum()) == 0:
        fail(f"dose image: {dark_seen} of the {int(seen.sum())} pixels that waypoint 0 sees have no dose")
    out["image_s"] = image_s
    say(f"dose image: plan_dose_image(128) + dose_image over {n_wp} waypoints (n_samples 8) + the gradient of the "
        f"worst lit pixel: {image_s:.3f} s, {launches24[0]} B2 launches; {float(plan.mask.float().mean()):.4f} of "
        f"probes land, {int(lit.sum())} lit pixels, dose max {img_np.max():.4g} mJ/cm^2; first hits vs plain: "
        f"{int(differ.sum())} differ, all ties; {int(seen.sum())} pixels seen from waypoint 0 all have dose; "
        f"|d worst / d waypoints| {g_wp.norm().item():.4g} [{card}]")

    # ---- 25. optimize-route and dose-image through the CLI --------------------------------------
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    opt_xml = os.path.join(out_dir, "route_optimized.xml")
    t0 = time.perf_counter()
    j_opt = run_cli(["optimize-route", TESTROOM, "--route", LANGE_ROUTE, "--steps", "3", "--output", opt_xml])
    opt_s = time.perf_counter() - t0
    back = load_route_xml(opt_xml)
    total_back, total_time = sum(w.duration for w in back.waypoints), float(durs0.sum())
    if (len(back.waypoints) != n_wp or abs(total_back - total_time) > 1e-4 * total_time
            or not np.isfinite(j_opt["final_min_dose"]) or j_opt["device"] != "cuda:0"):
        fail(f"optimize-route: {len(back.waypoints)} waypoints back, total duration {total_back} vs {total_time}, "
             f"JSON {j_opt}")
    img_dir = os.path.join(out_dir, "image")
    t0 = time.perf_counter()
    j_img = run_cli(["dose-image", TESTROOM, "--route", LANGE_ROUTE, "--res", "128", "--output", img_dir])
    img_s = time.perf_counter() - t0
    arr = np.load(os.path.join(img_dir, "dose_image.npy"))
    grads = np.load(os.path.join(img_dir, "gradients.npz"))
    if (arr.shape != (128, 128) or not np.isfinite(arr).all() or read_png(os.path.join(img_dir, "dose_image.png")).shape
            != (128, 128, 3) or grads["d_worstdose_d_waypoints"].shape != (n_wp, 2)
            or grads["d_worstdose_d_durations"].shape != (n_wp,)):
        fail(f"dose-image: image {arr.shape}, gradients {[grads[k].shape for k in grads.files]}")
    shutil.rmtree(out_dir, ignore_errors=True)
    say(f"CLI on the card: optimize-route --steps 3 {opt_s:.2f} s ({j_opt['seconds']:.3f} s optimizing; final min "
        f"dose {j_opt['final_min_dose']:.4g}, p05 {j_opt['final_p05_dose']:.4g} mJ/cm^2, total duration kept to "
        f"{abs(total_back - total_time) / total_time:.2e}) | dose-image --res 128 {img_s:.2f} s "
        f"({j_img['seconds']:.3f} s computing; worst lit pixel {j_img['worst_lit_pixel']:.4g} mJ/cm^2) [{card}]")
    out["b2_launches"] = launches22[0]
    return out



def plain_traversal_phases(mesh, card: str, out_dir: str) -> dict:
    """Phases 30-35: the clustered traversal and the fine-BVH walk, plain
    torch on the card, held to B3, to the pinned totals and to the other
    paths. Returns their times for PERF.md's record (printed, not in the
    kernels' line: neither is a kernel)."""
    import warnings

    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.bvh import native
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.routexml import LightPos, load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse as tr
    from uvtrace_torch.ops import traverse_clustered as tc
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.accumulate import hit_counts
    from uvtrace_torch.ops.generate import generate_native, generate_stratified
    from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays
    from uvtrace_torch.sim import SimParams, Simulator

    def zero_counters():
        torch.cuda.synchronize()
        tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0

    def counters():
        return tm.traverse_mxu_padded.launches, tm.fused_trace_counts.launches, tp.traverse_pallas.launches

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    t_start = time.perf_counter()
    t_count = mesh.triangle_count
    clusters = native.build_clusters_native(mesh.tris)
    ca = tc.cluster_arrays(clusters, device="cuda")
    pscene = tp.build_pallas_scene(clusters, device="cuda")
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    chunk = 1 << 20
    out = {}

    def vs_b3(label, t, hit, o, d, n):
        """The same rays' closest hits through B3: phase 10's agreement rule
        (at most 0.1% of rays differ, every differing id a t-tie)."""
        bt, bh = tp.traverse_pallas(pscene, o, d)
        stats, _ = agree(label, (t, hit, hit_counts(hit, t_count)), (bt, bh, hit_counts(bh, t_count)), n,
                         with_visits=False)
        return stats

    def audited(o, d, budget):
        """traverse_clustered escalated x 4 while the budget drops clusters,
        as the Simulator does: ((t, hit), [(budget, overflow, s), ...])."""
        steps = []
        while True:
            (t, hit, ov), s_ = timed(lambda: tc.traverse_clustered(ca, o, d, max_clusters=budget,
                                                                   return_overflow=True))
            steps.append((budget, int(ov), s_))
            if int(ov) == 0 or budget >= clusters.n_clusters:
                return (t, hit), steps
            budget = min(clusters.n_clusters, 4 * budget)

    # ---- 30. the pinned totals through the clustered traversal --------------------------------
    lines = []
    total, overflow = 0, 0
    zero_counters()
    t0 = time.perf_counter()
    for i in range(20):
        r = generate_stratified(rng.fold_in(rng.PRNGKey(0), i), chunk, lamp, 1.0, device="cuda")
        t, hit, ov = tc.traverse_clustered(ca, r.orig, r.dir, max_clusters=48, return_overflow=True)
        total += int(hit_counts(hit, t_count).sum())
        overflow += int(ov)
        if i + 1 in (5, 20):
            pinned, tol = PINNED_CLUSTERED[i + 1], PINNED_TOL * (i + 1) // 5
            if abs(total - pinned) > tol:
                fail(f"clustered pinned total at {i + 1} x 2^20 rays: {total} vs {pinned} (diff {total - pinned}, "
                     f"tolerance {tol})")
            lines.append(f"{i + 1} x 2^20: {total} vs {pinned}, diff {total - pinned} (tolerance {tol}), overflow "
                         f"{overflow}, {time.perf_counter() - t0:.2f} s")
    if counters() != (0, 0, 0):
        fail(f"the clustered traversal launched B2, B1, B3 {counters()} times")
    say(f"clustered pinned totals (budget 48, bench.py's keys and lamp, plain torch, no kernel): {'; '.join(lines)} "
        f"[{card}]")

    # ---- 31. clustered vs B3, and the Simulator's audit ----------------------------------------
    key = rng.fold_in(rng.PRNGKey(0), 0)
    strat = generate_stratified(key, chunk, lamp, 1.0, device="cuda")
    (t, hit), steps_s = audited(strat.orig, strat.dir, 32)
    st_s = vs_b3("clustered vs B3, 2^20 stratified rays", t, hit, strat.orig, strat.dir, chunk)
    # iid rays as the audited Simulator below draws them: its key, lamp and rod
    n_iid = 1 << 18
    pa = SimParams(photon_count=n_iid, max_iterations=1, sampler="native", traversal="clustered")
    lamp_sim = np.array([0.0, mesh.floor_height + pa.light_height, 0.0], np.float32).tolist()
    iid = generate_native(rng.fold_in(rng.split(rng.PRNGKey(pa.seed))[1], 0), n_iid, lamp_sim, pa.light_length,
                          device="cuda")
    (t, hit), steps_n = audited(iid.orig, iid.dir, 512)
    st_n = vs_b3("clustered vs B3, 2^18 native rays", t, hit, iid.orig, iid.dir, n_iid)
    free = hit_counts(hit, t_count).float()
    zero_counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sa = Simulator(mesh, pa, route=[LightPos(0.0, 0.0, 1.0)], max_clusters=1, device="cuda")
        _, audit_s = timed(sa.compute)
    warned = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    if not warned or sa._max_clusters <= 1 or not torch.equal(sa.photon_map, free) or counters() != (0, 0, 0):
        fail(f"the Simulator's budget audit: {len(warned)} warnings, budget {sa._max_clusters}, counts equal to the "
             f"budget-free ones {torch.equal(sa.photon_map, free)}, kernel launches {counters()}")
    show = lambda steps: ", ".join(f"budget {b}: overflow {o}, {s_ * 1e3:.1f} ms" for b, o, s_ in steps)  # noqa: E731
    out["clustered_stratified_ms"] = steps_s[-1][2] * 1e3
    out["clustered_native_ms_per_2_20"] = steps_n[-1][2] * 1e3 * chunk / n_iid
    say(f"clustered vs B3: 2^20 stratified rays: {show(steps_s)}; " + ", ".join(f"{k} {v}" for k, v in st_s.items())
        + f" | 2^18 native iid rays: {show(steps_n)}; " + ", ".join(f"{k} {v}" for k, v in st_n.items())
        + f" | the same iid rays through Simulator(max_clusters=1): {len(warned)} warnings, the first "
        f"\"{warned[0]}\", the last \"{warned[-1]}\"; budget {sa._max_clusters}, counts equal to the budget-free "
        f"counts, {audit_s:.2f} s with the escalations [{card}]")

    # ---- 32. the fine-BVH walk ("jax" traversal) --------------------------------------------------
    (bvh, build_s) = timed(lambda: native.build_bvh_native(mesh.tris, max_leaf_size=8))
    sa_ = tr.scene_arrays(bvh, device="cuda")
    lines = []
    for label, r in (("2^20 stratified", strat), ("2^20 native", generate_native(key, chunk, lamp, 1.0,
                                                                                   device="cuda"))):
        zero_counters()
        tr.traverse(sa_, r.orig, r.dir, max_leaf=bvh.max_leaf_size)
        ((t, hit, n_steps), walk_s) = timed(lambda: tr.traverse(sa_, r.orig, r.dir, max_leaf=bvh.max_leaf_size,
                                                                with_steps=True))
        if counters() != (0, 0, 0):
            fail(f"the fine-BVH walk launched B2, B1, B3 {counters()} times")
        st = vs_b3(f"fine-BVH walk vs B3, {label} rays", t, hit, r.orig, r.dir, chunk)
        out[f"jax_{label.split()[1]}_ms"] = walk_s * 1e3
        lines.append(f"{label} rays: {walk_s * 1e3:.1f} ms, {n_steps} steps; " + ", ".join(f"{k} {v}"
                                                                                          for k, v in st.items()))
    say(f"fine-BVH walk (traversal \"jax\", plain torch): build_bvh_native {build_s:.2f} s, {bvh.n_nodes} nodes, "
        f"leaves of at most {bvh.max_leaf_size}; {' | '.join(lines)} [{card}]")

    # ---- 33. Simulator(traversal="clustered") at full width ------------------------------------------
    route = load_route_xml(ROUTE)
    lines = []
    for label, fields, wps in (("waypoint 0 of route.xml, 2^25 photons", dict(photon_count=1 << 25),
                                route.waypoints[:1]),
                               ("route.xml, 12 waypoints, 2^22 photons", dict(photon_count=1 << 22),
                                route.waypoints)):
        pc = dataclasses.replace(route.apply_to(SimParams()), max_iterations=1, traversal="clustered", **fields)
        sc = Simulator(mesh, pc, route=wps, device="cuda")
        zero_counters()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            _, sim_s = timed(sc.compute)
        if counters() != (0, 0, 0):
            fail(f"Simulator(traversal='clustered') launched B2, B1, B3 {counters()} times")
        sp = Simulator(mesh, dataclasses.replace(pc, traversal="pallas"), route=wps, device="cuda")
        sp.compute()
        diff = int((sc.photon_map - sp.photon_map).abs().sum())
        bound = 2 * (sc.photon_map_size // 1000)
        dose = sc.dosage_map().cpu().numpy()
        if diff > bound or not np.isfinite(dose).all() or dose.max() <= 0:
            fail(f"Simulator(traversal='clustered'), {label}: per-triangle |diff| {diff} against traversal='pallas' "
                 f"from the same photons (bound {bound}), dose finite {np.isfinite(dose).all()}")
        lines.append(f"{label}: {sim_s:.2f} s per iteration with {len(caught)} escalations (budget 32 -> "
                     f"{sc._max_clusters}), {sc.photon_map_size / sim_s / 1e6:.2f} Mrays/s, per-triangle |diff| "
                     f"{diff} against pallas (bound {bound})")
        out[f"clustered_sim_{fields['photon_count'].bit_length() - 1}_s"] = sim_s
    # the 256^2 probe grid through the clustered probes (audited) on the route's map
    sc._set_cluster_budget(32)
    verts = mesh.tris.reshape(-1, 3)
    po, pd = probe_rays(verts.min(0), verts.max(0), 256, device="cuda")
    lo_y, hi_y = float(verts.min(0)[1]), float(verts.max(0)[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        (ct, ch), probe_s = timed(lambda: first_hits_skip_ceiling(sc._extend_probes, po, pd, lo_y, hi_y))
        grid, grid_s = timed(lambda: sc.dose_grid(256))
    bt, bh = first_hits_skip_ceiling(lambda o, d: tp.traverse_pallas(pscene, o, d)[:2], po, pd, lo_y, hi_y)
    differ = ch != bh
    tie_ok = bool((((ct - bt).abs() <= 1e-5 * bt.abs()) & (ch >= 0) & (bh >= 0))[differ].all())
    if int(differ.sum()) > po.shape[0] // 1000 or not tie_ok or grid.shape != (256, 256) \
            or not np.isfinite(grid).all() or (grid > 0).mean() < 0.5:
        fail(f"clustered probe grid: {int(differ.sum())} first hits differ from B3's (ties only: {tie_ok}), "
             f"grid {grid.shape}, {(grid > 0).mean():.3f} of cells with dose")
    say(f"Simulator(traversal=\"clustered\"), testroomopt: {' | '.join(lines)} | 256^2 probe grid through the "
        f"audited clustered probes: {len(caught)} escalations (to budget {sc._max_clusters}), first hits vs B3 "
        f"{int(differ.sum())} differ, all ties; probes {probe_s:.2f} s, dose_grid(256) {grid_s:.2f} s, "
        f"{(grid > 0).mean():.3f} of cells with dose [{card}]")

    # ---- 34. make_diff_scene(backend="clustered"): config 4's direct objective at one waypoint --------
    route4 = load_route_xml(LANGE_ROUTE)
    p4 = route4.apply_to(SimParams())
    base_y, rod_len, power = mesh.floor_height + p4.light_height, p4.light_length, p4.light_intensity
    wp = torch.tensor([[route4.waypoints[0].x, route4.waypoints[0].y]], device="cuda")
    dur = torch.tensor([route4.waypoints[0].duration], device="cuda")
    res4 = {}
    for backend in ("auto", "clustered"):
        dscene = D.make_diff_scene(mesh, backend=backend, device="cuda")
        mask = torch.linalg.norm(torch.cross(dscene.e1, dscene.e2, dim=-1), dim=-1) > 0
        xz = wp.clone().requires_grad_(True)
        zero_counters()

        def objective():
            dose = D.route_dose(dscene, xz, dur, base_y, rod_len, power, rng.PRNGKey(0), n_samples=4)
            loss = -softmin(dose[mask], 5.0)
            return loss, torch.autograd.grad(loss, xz)[0]

        (loss, g), obj_s = timed(objective)
        res4[backend] = (loss.item(), g, obj_s, counters())
    (la, ga, sa_s, ca_), (lc, gc, sc_s, cc_) = res4["auto"], res4["clustered"]
    if (abs(lc - la) > 2e-3 * abs(la) or not torch.allclose(gc, ga, rtol=2e-3, atol=1e-6) or cc_ != (0, 0, 0)
            or ca_[0] != 1):
        fail(f"config 4 direct objective at one waypoint: clustered loss {lc} vs auto {la}, gradients {gc.tolist()} "
             f"vs {ga.tolist()} (rtol 2e-3), launches B2, B1, B3 {cc_} clustered and {ca_} auto")
    out["diff_clustered_s"] = sc_s
    say(f"make_diff_scene(backend=\"clustered\"), config 4's direct objective at lange_route waypoint 0 (n_samples "
        f"4, {4 * t_count} shadow rays, budget-free: {clusters.n_clusters} clusters): loss {lc:.6g} vs auto (B2) "
        f"{la:.6g}, d loss / d waypoint {[round(v, 6) for v in gc.flatten().tolist()]} vs "
        f"{[round(v, 6) for v in ga.flatten().tolist()]}; {sc_s:.2f} s vs {sa_s:.3f} s with B2 [{card}]")

    # ---- 35. compute --traversal clustered | jax through the CLI ---------------------------------------
    shutil.rmtree(out_dir, ignore_errors=True)
    lines = []
    for traversal in ("clustered", "jax"):
        d_ = os.path.join(out_dir, traversal)
        j, cli_s = timed(lambda: run_cli(["compute", TESTROOM, "--photon-count", str(1 << 20), "--iterations", "1",
                                          "--traversal", traversal, "--no-render", "--output", d_]))
        dose = np.load(os.path.join(d_, "dose_mJ_cm2.npy"))
        if j["traversal"] != traversal or dose.shape != (t_count,) or not np.isfinite(dose).all() or dose.max() <= 0:
            fail(f"compute --traversal {traversal}: JSON {j}, dose {dose.shape} finite {np.isfinite(dose).all()}")
        lines.append(f"--traversal {traversal} {cli_s:.2f} s ({j['seconds']:.3f} s computing, dose max "
                     f"{dose.max():.4g} mJ/cm^2)")
    shutil.rmtree(out_dir, ignore_errors=True)
    say(f"CLI on the card: compute, 2^20 photons: {' | '.join(lines)} | phases 30-35 took "
        f"{time.perf_counter() - t_start:.1f} s [{card}]")
    return out


def native_phase(card: str, mesh) -> dict:
    """Phase 26: the native cluster builder on the test room and the
    443,328-triangle box room (scripts/torch_kernel_scale.py's box192), with
    the numpy builder beside it; B1, B2 and B3 timed at 443k on the clusters
    of both builders in turns (CUDA events, 5 launches after a warm-up), and
    their hit totals, which the clustering must not change beyond ties."""
    import torch

    from uvtrace_torch.bvh import native
    from uvtrace_torch.geometry.procedural import make_box_room
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.cluster import build_clusters
    from uvtrace_torch.ops.generate import generate_native, generate_stratified

    out = {}
    t0 = time.perf_counter()
    room_cs = native.build_clusters_native(mesh.tris)
    room_s = time.perf_counter() - t0
    again = native.build_clusters_native(mesh.tris)
    if not np.array_equal(room_cs.tri_idx, again.tri_idx):
        fail("native builder: two builds of the test room's clusters differ")
    big = make_box_room(subdivisions=192, clutter=96)
    built = {}
    for label, build in (("native", native.build_clusters_native),
                         ("numpy", lambda tris: build_clusters(tris, cluster_size=128))):
        t0 = time.perf_counter()
        built[label] = (build(big.tris), time.perf_counter() - t0)
    n = 1 << 20
    lamp = (0.0, big.floor_height + 0.8, 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    strat = generate_stratified(key, n, lamp, 1.0, device="cuda")
    iid = generate_native(key, n, lamp, 1.0, device="cuda")
    scenes = {label: (tm.build_mxu_scene(cs, device="cuda"), tp.build_pallas_scene(cs, device="cuda"))
              for label, (cs, _) in built.items()}
    times = {label: {} for label in scenes}
    hits = {}
    for label in ("native", "numpy", "numpy", "native"):  # in turns
        ms, ps = scenes[label]
        t = times[label]
        for name, fn in (("b1", lambda: tm.fused_trace_counts(ms, key, lamp, 1.0, n)),
                         ("b2", lambda: tm.traverse_mxu_counts(ms, strat.orig, strat.dir)),
                         ("b3", lambda: tp.traverse_pallas(ps, strat.orig, strat.dir)),
                         ("b3_native_rays", lambda: tp.traverse_pallas(ps, iid.orig, iid.dir))):
            t.setdefault(name, []).append(cuda_ms(fn, 5))
        hits[label] = (int(tm.fused_trace_counts(ms, key, lamp, 1.0, n)[2].sum()),
                       int((tp.traverse_pallas(ps, strat.orig, strat.dir)[1] >= 0).sum()))
    if any(abs(a - b) > n // 1000 for a, b in zip(hits["native"], hits["numpy"])):
        fail(f"443k box room: B1 and B3 hit totals on native vs numpy clusters {hits}")
    for label in times:
        out[label] = {k: float(np.mean(v)) for k, v in times[label].items()}
        out[label].update(clusters=built[label][0].n_clusters, build_s=built[label][1])
    say(f"native builder: testroomopt {room_cs.n_clusters} clusters in {room_s:.3f} s, the same in a second build | "
        f"443k box room ({big.triangle_count} triangles): native {out['native']['clusters']} clusters in "
        f"{out['native']['build_s']:.2f} s, numpy {out['numpy']['clusters']} in {out['numpy']['build_s']:.2f} s; "
        "ms per 2^20 rays (native / numpy clusters, in turns): "
        + ", ".join(f"{k} {out['native'][k]:.3f} / {out['numpy'][k]:.3f}"
                    for k in ("b1", "b2", "b3", "b3_native_rays"))
        + f"; hit totals B1, B3 {hits['native']} vs {hits['numpy']} [{card}]")
    return out


def two_rank_worker(rank: int, world: int, init: str, ref_dir: str, cfg: dict, results):
    """One of two ranks that share cfg["device"] over gloo (NCCL refuses two
    ranks on one card): config 5 on a 1x2 mesh, its sharded dose grid, the
    test room's route on a 2x1 mesh through B1, B3 and B2 (2 bounces), and
    config 4's direct step with the shadow rays sharded, each against the
    one-rank results in ref_dir. cfg: the scene, the sizes and the device
    (TWO_RANKS below). Puts (rank, report or traceback) on `results`."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, ROOT)
        from uvtrace_torch import diff as D
        from uvtrace_torch.geometry.gltf import load_glb
        from uvtrace_torch.io.routexml import LightPos, load_route_xml
        from uvtrace_torch.ops import traverse_mxu as tm
        from uvtrace_torch.ops import traverse_pallas as tp
        from uvtrace_torch.parallel import initialize, make_2d_mesh, make_ray_mesh
        from uvtrace_torch.sim import SimParams, Simulator

        def counters():
            if torch.device(cfg["device"]).type == "cuda":
                torch.cuda.synchronize()
            return tm.traverse_mxu_padded.launches, tm.fused_trace_counts.launches, tp.traverse_pallas.launches

        def zero():
            tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0

        initialize("gloo", init, world, rank)
        mesh = load_glb(cfg["scene"])
        dev = cfg["device"]
        ref = np.load(os.path.join(ref_dir, "ref.npz"))
        rep = {}
        # config 5 on 1 x 2: each rank keeps half of the slots
        p5 = dataclasses.replace(SimParams(), photon_count=cfg["photons5"], max_iterations=1,
                                 texel_density=cfg["density5"], texel_max_slots=cfg["slots5"])
        m12 = make_2d_mesh(1, 2)
        sim = Simulator(mesh, p5, route=[LightPos(0.0, 0.0, 1.0)], device_mesh=m12, device=dev)
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        sim.compute()
        rep["c5_launches"] = counters()
        rep["c5_s"] = time.perf_counter() - t0
        rep["c5_staged_bytes"], rep["c5_staged_s"] = sim.collectives.staged_bytes, sim.collectives.staged_seconds
        rep["c5_peak"] = torch.cuda.max_memory_allocated() if on_card else 0
        rep["c5_own_slots"] = sim.photon_map_tex.shape[0]
        tex = sim.full_texel_map(sim.photon_map_tex).cpu().numpy()
        rep["c5_equal"] = (np.array_equal(sim.photon_map.cpu().numpy(), ref["map5"])
                           and np.array_equal(tex, np.load(os.path.join(ref_dir, "tex5.npy"))))
        del tex
        zero()
        t0 = time.perf_counter()
        grid = sim.dose_grid(cfg["grid"])
        rep["grid_s"] = time.perf_counter() - t0
        rep["grid_launches"] = counters()
        rep["grid_equal"] = np.array_equal(grid, np.load(os.path.join(ref_dir, "grid5.npy")))
        rep["staged_bytes"], rep["staged_s"] = sim.collectives.staged_bytes, sim.collectives.staged_seconds
        rep["peak"] = torch.cuda.max_memory_allocated() if on_card else 0
        del sim, grid
        # the test room's route on 2 x 1 through B1, B3 and B2 with 2 bounces
        route = load_route_xml(ROUTE)
        m21 = make_2d_mesh(2, 1)
        for name, fields in ROUTE_RUNS.items():
            s = Simulator(mesh, route_params(route, cfg, fields), route=route.waypoints,
                          ray_chunk=cfg["route_chunk"], device_mesh=m21, device=dev)
            zero()
            t0 = time.perf_counter()
            s.compute()
            rep[f"{name}_launches"] = counters()
            rep[f"{name}_s"] = time.perf_counter() - t0
            rep[f"{name}_equal"] = np.array_equal(s.photon_map.cpu().numpy(), ref[f"route_{name}"])
        # config 4's direct step, the shadow rays sharded over a 2-rank ray mesh
        dscene = D.make_diff_scene(mesh, device_mesh=make_ray_mesh(), device=dev)
        zero()
        loss, (g_raw, g_lg) = config4_step(mesh, dscene, dev)(n_samples=4)
        rep["step_launches"] = counters()
        rep["step_equal"] = (loss.item() == float(ref["step_loss"])
                             and np.array_equal(g_raw.cpu().numpy(), ref["step_g_raw"])
                             and np.array_equal(g_lg.cpu().numpy(), ref["step_g_lg"]))
        results.put((rank, rep))
    except BaseException:
        results.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# phase 29: the scene, sizes and device of the two ranks; the test room's
# route runs on a 2 x 1 mesh with the stratified sampler, so that both ranks
# trace whole chunks of 2^18 as one rank does
TWO_RANKS = dict(scene=TESTROOM, device="cuda:0", photons5=1 << 25, density5=2048.0, slots5=1 << 25, grid=4096,
                 route_photons=1 << 22, route_chunk=1 << 18)
ROUTE_RUNS = {"direct": dict(), "pallas": dict(traversal="pallas"),
              "bounces": dict(traversal="mxu", max_bounces=2, reflectance=0.25)}


def route_params(route, cfg: dict, fields: dict):
    """The SimParams of one ROUTE_RUNS entry: the route's, one iteration of
    cfg["route_photons"]."""
    from uvtrace_torch.sim import SimParams

    return dataclasses.replace(route.apply_to(SimParams()), photon_count=cfg["route_photons"], max_iterations=1,
                               **fields)


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
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.accumulate import hit_counts
    from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort
    from uvtrace_torch.bvh import native
    from uvtrace_torch.ops.generate import generate_native, generate_stratified
    from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays
    from uvtrace_torch.sim import SimParams, Simulator, ViewMode
    from uvtrace_torch.sim.launch import launch_counts

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
    if not native.available():  # g++ is on the card's machine: the Simulator clusters natively there
        fail("the native cluster builder (uvtrace_torch/bvh/cpp/builder.cpp) did not build with g++")
    say(f"build: {time.perf_counter() - t0:.1f} s ({lib.name}; ptxas: {'; '.join(ptxas)}; native cluster builder "
        f"{native._library_path().name})")

    # ---- 3. kernel vs plain on the card --------------------------------------
    mesh = load_glb(TESTROOM)
    # the clusters the Simulator builds: the native builder's
    scene = tm.build_mxu_scene(native.build_clusters_native(mesh.tris), device="cuda")
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
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
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
    per_wp = []
    for w in sim.route:
        lamp_w = (w.x, mesh.floor_height + params.light_height, w.y)
        wp_ms = cuda_ms(lambda: tm.fused_trace_counts(scene, key, lamp_w, params.light_length, chunk), 3)
        v = tm.fused_trace_counts(scene, key, lamp_w, params.light_length, chunk, with_visits=True)[3].float()
        per_wp.append(f"({w.x:.2f}, {w.y:.2f}) {wp_ms:.3f} ms, visits {v.mean().item():.2f} / "
                      f"{v.quantile(0.9).item():.0f} / {int(v.max())}")
    say(f"main path: {len(sim.route)} waypoints x 2 iterations, {sim._launch_n} rays per waypoint, "
        f"{launches} kernel launches (expected {expected}), {seconds:.2f} s, "
        f"{2 * len(sim.route) * sim._launch_n / seconds / 1e6:.1f} Mrays/s; dose max {dose_np.max():.4g} "
        f"mJ/cm^2, {hit_share:.3f} of triangles hit; 4 more iterations {rate / 1e6:.1f} Mrays/s | one 2^20-ray "
        f"launch per waypoint, (x, z) ms, visits per packet mean / p90 / max: {'; '.join(per_wp)} [{card}]")

    # ---- 6. split kernel vs plain ----------------------------------------------
    rays = generate_stratified(key, chunk, lamp, 1.0, device="cuda")
    kout = tm.traverse_mxu_padded(scene, rays.orig, rays.dir, with_counts=True, with_visits=True)
    plain = []
    split_plain_ms = cuda_ms(lambda: plain.append(tm.traverse_mxu_padded_reference(
        scene, rays.orig, rays.dir, with_counts=True, with_visits=True)), 1, warmup=False)
    stats, split_err = agree("B2 counts mode, 2^20 stratified rays", kout, plain[0], chunk,
                             visits_per_ray=scene.n_clusters)
    stats["bit_equal"] = all(torch.equal(a, b) for a, b in zip(kout, plain[0]))
    split_needed = tm.clusters_within(scene, rays.orig, rays.dir, plain[0][0])
    split_needed_tris = tm.clusters_within(scene, rays.orig, rays.dir, plain[0][0], triangles=True)
    split_ms = cuda_ms(lambda: tm.traverse_mxu_counts(scene, rays.orig, rays.dir), 20)
    # the first bounce segment of this chunk, as launch_counts makes it
    t_hit, hit = kout[0], kout[1]
    normals = torch.from_numpy(mesh.normals).cuda()[scene.tri_idx_flat.clamp_min(0).long()]
    rho = torch.full((scene.tri_idx_flat.shape[0],), 0.25, device="cuda")
    alive = torch.ones(chunk, dtype=torch.bool, device="cuda")
    bo, bd, alive = bounce_rays(rng.fold_in(rng.fold_in(key, 7919), 0), rays.orig, rays.dir, t_hit, hit,
                                normals, rho, alive)
    bo, bd, alive = coherence_sort(bo, bd, alive)
    n_live = int(alive.sum())
    if not bool(alive[:n_live].all()):
        fail("the coherence sort did not put the live lanes of the bounce segment first")
    m = 1 << 18
    kb = tm.traverse_mxu_padded(scene, bo[:m], bd[:m], packet=4096, with_counts=True, with_visits=True)
    plain = []
    bounce_plain_ms = cuda_ms(lambda: plain.append(tm.traverse_mxu_padded_reference(
        scene, bo[:m], bd[:m], packet=4096, with_counts=True, with_visits=True)), 1, warmup=False)
    bstats, bounce_err = agree("B2 slots mode, 2^18 first-bounce rays", kb, plain[0], m,
                               visits_per_ray=scene.n_clusters)
    bstats["bit_equal"] = all(torch.equal(a, b) for a, b in zip(kb, plain[0]))
    # the plain version's closest hits of every live lane of the segment
    # (parked lanes need no cluster: they miss every box)
    seg_t = torch.full((chunk,), tm.BIG, device="cuda")
    seg_t[:m] = plain[0][0]
    m_live = -(-n_live // 4096) * 4096
    if m_live > m:
        seg_t[m:m_live] = tm.traverse_mxu_padded_reference(scene, bo[m:m_live], bd[m:m_live], packet=4096)[0]
    seg_needed = tm.clusters_within(scene, bo, bd, seg_t)
    seg_needed_tris = tm.clusters_within(scene, bo, bd, seg_t, triangles=True)
    bounce_ms = cuda_ms(lambda: tm.traverse_mxu_slots(scene, bo[:m], bd[:m], packet=4096), 5)
    segment = []
    segment_ms = cuda_ms(lambda: segment.append(tm.traverse_mxu_padded(scene, bo, bd, packet=4096,
                                                                       with_visits=True)), 3)
    sv = segment[-1][2]
    live = (bo.view(-1, 4096, 3) != 1e6).any(2).any(1)
    say(f"split kernel vs plain: counts mode, 2^20 stratified rays, 1024-ray packets: "
        + ", ".join(f"{name} {v}" for name, v in stats.items())
        + f"; kernel {split_ms:.3f} ms ({chunk / split_ms / 1e3:.1f} Mrays/s), plain {split_plain_ms:.1f} ms; "
        f"(ray, leaf) tests per ray {kout[3].sum().item() / chunk:.3f}, clusters needed per ray "
        f"{split_needed.sum().item() / chunk:.3f} ({split_needed_tris.sum().item() / chunk:.1f} triangles) | slots mode, first 2^18 of a first bounce segment (rho 0.25), "
        f"4096-ray packets: " + ", ".join(f"{name} {v}" for name, v in bstats.items())
        + f"; kernel {bounce_ms:.3f} ms, plain {bounce_plain_ms:.1f} ms | whole 2^20-ray segment: "
        f"{n_live} live lanes, {int(live.sum())} of {live.numel()} packets with a live lane, "
        f"kernel {segment_ms:.3f} ms, (ray, leaf) tests per live ray {sv.sum().item() / n_live:.3f}, clusters "
        f"needed per live ray {seg_needed.sum().item() / n_live:.3f} ({seg_needed_tris.sum().item() / n_live:.1f} "
        f"triangles; of {scene.n_clusters} clusters), all-dead "
        f"packets {int(sv[~live].sum())} tests [{card}]")
    if int(sv[~live].sum()) != 0:
        fail("an all-dead bounce packet tested a cluster")

    # ---- 7. split pinned total ------------------------------------------------
    total = 0
    for i in range(5):
        r = generate_stratified(rng.fold_in(rng.PRNGKey(0), i), chunk, lamp, 1.0, device="cuda")
        total += int(tm.traverse_mxu_counts(scene, r.orig, r.dir)[2].sum())
    diff = total - PINNED_SPLIT_TOTAL
    if abs(diff) > PINNED_TOL:
        fail(f"split pinned total {total} vs {PINNED_SPLIT_TOTAL} (diff {diff})")
    say(f"split pinned total: {total} vs {PINNED_SPLIT_TOTAL}, diff {diff} (tolerance {PINNED_TOL})")

    # ---- 8. config 2: 4 bounces with Russian roulette ---------------------------
    rho2 = 0.25
    p2 = dataclasses.replace(SimParams(), photon_count=1 << 25, max_iterations=1, max_bounces=4,
                             reflectance=rho2)
    sim2 = Simulator(mesh, p2, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    chunks2 = (1 << 25) // sim2.ray_chunk
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose2 = sim2.compute()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    b2_launches = tm.traverse_mxu_padded.launches
    if b2_launches != chunks2 * (1 + 4) or tm.fused_trace_counts.launches != 0:
        fail(f"config 2 launched B2 {b2_launches} times (expected {chunks2 * 5}) and B1 "
             f"{tm.fused_trace_counts.launches} times (expected 0)")
    map1 = sim2.photon_map.clone()
    sim2.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim2.compute()
    torch.cuda.synchronize()
    seconds2 = time.perf_counter() - t0
    if not torch.equal(map1, sim2.photon_map):
        fail("config 2: a repeat run from reset gave another photon map")
    direct = Simulator(mesh, dataclasses.replace(p2, max_bounces=0, traversal="mxu"),
                       route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    direct.compute()
    deposits, primary = float(map1.sum()), float(direct.photon_map.sum())
    ratio, bound = deposits / primary, (1 - rho2 ** 5) / (1 - rho2)
    if not (np.isfinite(dose2.cpu().numpy()).all() and 1.0 < ratio <= bound):
        fail(f"config 2: dose finite {bool(torch.isfinite(dose2).all())}, deposits / primary hits {ratio:.5f} "
             f"not in (1, {bound:.5f}]")
    # the same launch code through the kernels and through their plain
    # versions, at one 2^18-ray chunk: the same photons, the same counts but
    # for the flips the kernel checks allow, at most n/1000 rays in each of
    # the 5 segments, each moving two triangle counts by one
    small = dict(t_count=mesh.triangle_count, n=1 << 18, chunk=1 << 18, max_bounces=4,
                 normals=sim2._normals_launch, reflectance=sim2._reflectance_launch(), slot_map=sim2._slot_map)
    lamp2, key2 = [0.0, mesh.floor_height + p2.light_height, 0.0], rng.fold_in(rng.PRNGKey(7), 0)
    via_kernel = launch_counts(sim2.scene, key2, lamp2, 1.0, **sim2._trace, **small)[0]
    via_plain = launch_counts(
        sim2.scene, key2, lamp2, 1.0, extend_fn=tm.traverse_mxu_padded_reference,
        extend_counts_fn=functools.partial(tm.traverse_mxu_padded_reference, with_counts=True),
        extend_bounce_fn=functools.partial(tm.traverse_mxu_padded_reference, packet=4096), **small)[0]
    launch_diff = int((via_kernel - via_plain).abs().sum())
    tot_k, tot_p = int(via_kernel.sum()), int(via_plain.sum())
    launch_bound = 5 * 2 * ((1 << 18) // 1000)
    if launch_diff > launch_bound:
        fail(f"config 2 launch of 2^18 photons: per-triangle |diff| {launch_diff} between the kernels and the "
             f"plain versions (bound {launch_bound}); deposits {tot_k} vs {tot_p}")
    lanes = 5 * (1 << 25)
    say(f"config 2 launch of 2^18 photons, kernels vs plain versions: {tot_k} vs {tot_p} deposits, "
        f"per-triangle |diff| {launch_diff} (bound {launch_bound})")
    say(f"config 2: testroomopt, 2^25 photons, 4 bounces, rho {rho2}: {b2_launches} B2 launches "
        f"({chunks2} chunks x 5), deposits / primary hits {ratio:.5f} (bound {bound:.5f}), "
        f"{int(deposits)} deposits; first iteration {first_s:.3f} s, repeat {seconds2:.3f} s (same map): "
        f"{lanes / seconds2 / 1e6:.1f} Mrays/s over all 5 segments ({(1 << 25) / seconds2 / 1e6:.2f} M photons/s, "
        f"{deposits / seconds2 / 1e6:.1f} M deposits/s) [{card}]")

    # ---- 9. probe grid ----------------------------------------------------------
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = sim.dose_grid(256)
    grid_s = time.perf_counter() - t0  # ends in the grid's copy to the host
    grid_launches = tm.traverse_mxu_padded.launches
    if grid_launches != 2 or grid.shape != (256, 256) or not np.isfinite(grid).all() or (grid > 0).mean() < 0.5:
        fail(f"probe grid: {grid_launches} B2 launches (expected 2), shape {grid.shape}, "
             f"{(grid > 0).mean():.3f} of cells with dose")
    verts = mesh.tris.reshape(-1, 3)
    po, pd = probe_rays(verts.min(0), verts.max(0), 256, device="cuda")
    hits = {}
    for name, fn in (("kernel", tm.traverse_mxu_slots), ("plain", tm.traverse_mxu_padded_reference)):
        hits[name] = first_hits_skip_ceiling(lambda o, d: fn(scene, o, d)[:2], po, pd, float(verts.min(0)[1]),
                                             float(verts.max(0)[1]))
    (kt, ks), (pt, ps) = hits["kernel"], hits["plain"]
    differ = ks != ps
    both = (ks >= 0) & (ps >= 0)
    tie_ok = bool((both[differ] & ((kt - pt).abs() <= 1e-5 * pt.abs())[differ]).all())
    if int(differ.sum()) > po.shape[0] // 1000 or not tie_ok:
        fail(f"probe grid: {int(differ.sum())} first hits differ from the plain version's (ties only: {tie_ok})")
    probe_ms = cuda_ms(lambda: tm.traverse_mxu_slots(scene, po, pd), 5)
    say(f"probe grid: 256^2 through B2 ({grid_launches} launches) in {grid_s * 1e3:.1f} ms including the "
        f"image's copy to the host; {(grid > 0).mean():.3f} of cells with dose; first hits vs plain: "
        f"{int(differ.sum())} differ, all ties; one probe launch {probe_ms:.3f} ms [{card}]")

    # ---- 10. gen-1 DFS (B3) vs plain ----------------------------------------------
    pscene = tp.build_pallas_scene(native.build_clusters_native(mesh.tris), device="cuda")
    t_count = mesh.triangle_count

    def b3_vs_plain(label, o, d, n):
        """B3 against the plain version: phase 3's agreement rule on (t, id,
        per-triangle counts, leaf visits); returns (stats, max |dt| on equal
        ids, the kernel's per-packet stats, the plain version's ms)."""
        k = tp.traverse_pallas(pscene, o, d, with_stats=True)
        plain = []
        p_ms = cuda_ms(lambda: plain.append(tp.traverse_pallas_reference(pscene, o, d, with_stats=True)), 1,
                       warmup=False)
        p = plain[0]
        as_agree = lambda r: (r[0], r[1], hit_counts(r[1], t_count), r[2][:, 0])  # noqa: E731
        st, err = agree(label, as_agree(k), as_agree(p), n)
        st["bit_equal"] = bool(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[2], p[2]))
        return st, err, k[2], p_ms

    b3_checks, b3_err, b3_ms, b3_stats = [], 0.0, {}, {}
    strat16 = generate_stratified(key, 1 << 16, lamp, 1.0, device="cuda")
    native16 = generate_native(key, 1 << 16, lamp, 1.0, device="cuda")
    for label, r in (("2^16 stratified", strat16), ("2^16 native", native16)):
        st, err, _, _ = b3_vs_plain(f"B3 {label} rays", r.orig, r.dir, 1 << 16)
        b3_err = max(b3_err, err)
        b3_checks.append(f"{label}: " + ", ".join(f"{a} {v}" for a, v in st.items()))
    # leaves with 1-3 active columns among full ones: every eighth column
    # (8 rays) of the stratified packets carries native iid rays; then a
    # packet of parked dead lanes and one with a NaN ray
    mo, md = strat16.orig.clone().view(-1, 8, 8, 3), strat16.dir.clone().view(-1, 8, 8, 3)
    mo[:, 0], md[:, 0] = native16.orig.view(-1, 8, 8, 3)[:, 0], native16.dir.view(-1, 8, 8, 3)[:, 0]
    mo, md = mo.view(-1, tp.PACKET, 3), md.view(-1, tp.PACKET, 3)
    parked_o = torch.full((1, tp.PACKET, 3), 1e6, device="cuda")
    parked_d = torch.tensor([1.0, 0.0, 0.0], device="cuda").expand(1, tp.PACKET, 3)
    nan_o = mo[:1].clone()
    nan_o[0, 5, 1] = float("nan")
    mo, md = torch.cat([mo, parked_o, nan_o]).view(-1, 3), torch.cat([md, parked_d, md[:1]]).view(-1, 3).contiguous()
    st, err, mixed_stats, _ = b3_vs_plain("B3 mixed packets", mo, md, mo.shape[0])
    if not st["bit_equal"] or int(mixed_stats[-2].sum()) != 0:
        fail(f"B3 mixed packets: not bit-equal to the plain version ({st}), or the parked packet visited a "
             f"leaf ({mixed_stats[-2].tolist()})")
    b3_err = max(b3_err, err)
    b3_checks.append(f"{mo.shape[0] // tp.PACKET} mixed packets (every eighth column native, one parked, one with "
                     f"a NaN ray; {mixed_stats[:-2, 1].float().mean().item() / mixed_stats[:-2, 0].float().mean().item():.1f} "
                     f"active columns per leaf): " + ", ".join(f"{a} {v}" for a, v in st.items()))
    strat20 = generate_stratified(key, chunk, lamp, 1.0, device="cuda")
    native20 = generate_native(key, chunk, lamp, 1.0, device="cuda")
    st, err, b3_stats["native"], b3_plain_ms = b3_vs_plain("B3 2^20 native rays", native20.orig, native20.dir,
                                                           chunk)
    # the ray-triangle tests the native rays' active columns need: 8 rays x the cluster's real triangles
    b3_tests = 8 * int(tp.traverse_pallas_reference(pscene, native20.orig, native20.dir, with_stats=True,
                                                    column_weight=pscene.tri_used.long())[2][:, 1].sum())
    b3_err = max(b3_err, err)
    b3_checks.append("2^20 native: " + ", ".join(f"{a} {v}" for a, v in st.items()))
    b3_stats["stratified"] = tp.traverse_pallas(pscene, strat20.orig, strat20.dir, with_stats=True)[2]
    for ray_kind, r in (("stratified", strat20), ("native", native20)):
        b3_ms[ray_kind] = cuda_ms(lambda: tp.traverse_pallas(pscene, r.orig, r.dir), 5)
    say(f"gen-1 DFS vs plain: {'; '.join(b3_checks)}; max |dt| on equal ids {b3_err:.3g} | 2^20 rays, "
        + ", ".join(f"{rk} {ms_:.3f} ms" for rk, ms_ in b3_ms.items())
        + f"; plain {b3_plain_ms:.1f} ms (2^20 native) | per packet: "
        + ", ".join(f"{rk} {s[:, 0].float().mean().item():.1f} leaves, {s[:, 1].float().mean().item():.1f} "
                    f"active columns" for rk, s in b3_stats.items())
        + f" (top tree {pscene.node_meta.shape[0] // 2} nodes, depth {pscene.depth}) [{card}]")

    # ---- 11. gen-1 pinned total -------------------------------------------------------
    total = 0
    for i in range(5):
        r = generate_stratified(rng.fold_in(rng.PRNGKey(0), i), chunk, lamp, 1.0, device="cuda")
        total += int(hit_counts(tp.traverse_pallas(pscene, r.orig, r.dir)[1], t_count).sum())
    diff = total - PINNED_SPLIT_TOTAL
    if abs(diff) > PINNED_TOL:
        fail(f"gen-1 pinned total {total} vs {PINNED_SPLIT_TOTAL} (diff {diff})")
    say(f"gen-1 pinned total: {total} vs {PINNED_SPLIT_TOTAL}, diff {diff} (tolerance {PINNED_TOL}) [{card}]")

    # ---- 12. pallas main path ----------------------------------------------------------
    pp = dataclasses.replace(route.apply_to(SimParams()), photon_count=1 << 25, max_iterations=1,
                             sampler="native", traversal="pallas")
    simp = Simulator(mesh, pp, route=route.waypoints, device="cuda")
    n_wp = simp.photons_per_light
    chunks_p = -(-n_wp // min(simp.ray_chunk, 1 << (n_wp - 1).bit_length()))
    expected_p = len(simp.route) * chunks_p
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose_p = simp.compute()
    torch.cuda.synchronize()
    first_p = time.perf_counter() - t0
    b3_launches = tp.traverse_pallas.launches
    if b3_launches != expected_p or tm.fused_trace_counts.launches or tm.traverse_mxu_padded.launches:
        fail(f"pallas main path: B3 launched {b3_launches} times (expected {expected_p}), B1 "
             f"{tm.fused_trace_counts.launches}, B2 {tm.traverse_mxu_padded.launches} (expected 0)")
    map_p = simp.photon_map.clone()
    dose_np = dose_p.cpu().numpy()
    hit_share_p = float((map_p > 0).float().mean())
    if not (np.isfinite(dose_np).all() and dose_np.max() > 0 and hit_share_p > 0.8):
        fail(f"pallas main path: dose finite {bool(np.isfinite(dose_np).all())}, max {dose_np.max()}, "
             f"triangles hit {hit_share_p:.3f} (need > 0.8)")
    simp.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simp.compute()
    torch.cuda.synchronize()
    repeat_p = time.perf_counter() - t0
    if not torch.equal(map_p, simp.photon_map):
        fail("pallas main path: a repeat run from reset gave another photon map")
    # one waypoint's launch through B3 and through B2, the same photons
    lamp_wp = [simp.route[0].x, mesh.floor_height + pp.light_height, simp.route[0].y]
    key_wp = rng.fold_in(rng.PRNGKey(0), 12)
    one = dict(t_count=t_count, n=n_wp, chunk=1 << 20, sampler="native")
    t0 = time.perf_counter()
    via_b3 = launch_counts(simp.scene, key_wp, lamp_wp, pp.light_length, **simp._trace, **one)[0]
    torch.cuda.synchronize()
    wp_b3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    via_b2 = launch_counts(sim.scene, key_wp, lamp_wp, pp.light_length, slot_map=sim._slot_map,
                           **{**sim._trace, "fused_counts_fn": None}, **one)[0]
    torch.cuda.synchronize()
    wp_b2_s = time.perf_counter() - t0
    wp_diff, wp_bound = int((via_b3 - via_b2).abs().sum()), 2 * (n_wp // 1000)
    if wp_diff > wp_bound:
        fail(f"pallas main path: one waypoint through B3 and B2, per-triangle |diff| {wp_diff} (bound {wp_bound})")
    rays_p = simp.photon_map_size
    say(f"pallas main path: {len(simp.route)} waypoints x {n_wp} native photons ({chunks_p} chunks of 2^20, the "
        f"last masked), {b3_launches} B3 launches (expected {expected_p}), no B1/B2; first iteration "
        f"{first_p:.3f} s, repeat {repeat_p:.3f} s (same map): {rays_p / repeat_p / 1e6:.2f} Mrays/s; dose max "
        f"{dose_np.max():.4g} mJ/cm^2, {hit_share_p:.3f} of triangles hit | one waypoint via B3 "
        f"{wp_b3_s * 1e3:.1f} ms vs via B2 {wp_b2_s * 1e3:.1f} ms: {int(via_b3.sum())} vs {int(via_b2.sum())} hits, "
        f"per-triangle |diff| {wp_diff} (bound {wp_bound}) [{card}]")

    # ---- 13. reference sampler ---------------------------------------------------------
    simr = Simulator(mesh, dataclasses.replace(pp, sampler="reference"), route=route.waypoints, device="cuda")
    tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose_r = simr.compute()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    seed = 0
    for w in simr.route:
        seed = rng.advance_global_seed([w.x, float(np.float32(mesh.floor_height + pp.light_height)), w.y], seed)
    mean_r, mean_n = float(dose_r.mean()), float(dose_p.mean())
    if simr.global_seed != seed or tp.traverse_pallas.launches != expected_p or abs(mean_r / mean_n - 1) > 0.01:
        fail(f"reference sampler: global seed {simr.global_seed} vs host replay {seed}, {tp.traverse_pallas.launches} "
             f"B3 launches, mean dose {mean_r:.6g} vs native {mean_n:.6g}")
    say(f"reference sampler: {simr.photon_map_size} photons through B3 in {ref_s:.3f} s "
        f"({simr.photon_map_size / ref_s / 1e6:.2f} Mrays/s), global seed {seed} equals the host replay, mean "
        f"dose {mean_r:.6g} vs native {mean_n:.6g} ({(mean_r / mean_n - 1) * 100:+.3f}%) [{card}]")

    # ---- 14. pallas bounces ---------------------------------------------------------------
    simb = Simulator(mesh, dataclasses.replace(pp, max_bounces=4, reflectance=0.25, photon_count=1 << 18),
                     route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    bkw = dict(t_count=t_count, n=1 << 18, chunk=1 << 18, sampler="native", max_bounces=4,
               normals=simb._normals_launch, reflectance=simb._reflectance_launch())
    lamp_b, key_b = [0.0, mesh.floor_height + pp.light_height, 0.0], rng.fold_in(rng.PRNGKey(7), 0)
    tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounce_k = launch_counts(simb.scene, key_b, lamp_b, 1.0, extend_fn=tp.traverse_pallas, **bkw)[0]
    torch.cuda.synchronize()
    bounce_s = time.perf_counter() - t0
    bounce_launches = tp.traverse_pallas.launches
    t0 = time.perf_counter()
    bounce_p = launch_counts(simb.scene, key_b, lamp_b, 1.0, extend_fn=tp.traverse_pallas_reference, **bkw)[0]
    torch.cuda.synchronize()
    bounce_plain_s = time.perf_counter() - t0
    b_diff, b_bound = int((bounce_k - bounce_p).abs().sum()), 5 * 2 * ((1 << 18) // 1000)
    if b_diff > b_bound or bounce_launches != 5:
        fail(f"pallas bounces: per-triangle |diff| {b_diff} (bound {b_bound}), {bounce_launches} B3 launches")
    say(f"pallas bounces: 2^18 native photons, 4 bounces, rho 0.25, unsorted segments: {int(bounce_k.sum())} vs "
        f"{int(bounce_p.sum())} deposits, per-triangle |diff| {b_diff} (bound {b_bound}); {bounce_launches} B3 "
        f"launches in {bounce_s * 1e3:.1f} ms, plain {bounce_plain_s * 1e3:.1f} ms [{card}]")

    # ---- 15. pallas probe grid ------------------------------------------------------------
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid_p = simp.dose_grid(256)
    grid_p_s = time.perf_counter() - t0  # ends in the grid's copy to the host
    if (tp.traverse_pallas.launches != 2 or tm.traverse_mxu_padded.launches or grid_p.shape != (256, 256)
            or not np.isfinite(grid_p).all() or (grid_p > 0).mean() < 0.5):
        fail(f"pallas probe grid: {tp.traverse_pallas.launches} B3 launches (expected 2), shape {grid_p.shape}, "
             f"{(grid_p > 0).mean():.3f} of cells with dose")
    hits = {}
    for name, fn in (("kernel", tp.traverse_pallas), ("plain", tp.traverse_pallas_reference)):
        hits[name] = first_hits_skip_ceiling(lambda o, d: fn(pscene, o, d)[:2], po, pd, float(verts.min(0)[1]),
                                             float(verts.max(0)[1]))
    (kt, kh), (pt, ph) = hits["kernel"], hits["plain"]
    differ = kh != ph
    tie_ok = bool((((kh >= 0) & (ph >= 0)) & ((kt - pt).abs() <= 1e-5 * pt.abs()))[differ].all())
    if int(differ.sum()) > po.shape[0] // 1000 or not tie_ok:
        fail(f"pallas probe grid: {int(differ.sum())} first hits differ from the plain version's")
    say(f"pallas probe grid: 256^2 through B3 (2 launches) in {grid_p_s * 1e3:.1f} ms vs {grid_s * 1e3:.1f} ms "
        f"through B2 (phase 9), both including the image's copy to the host; {(grid_p > 0).mean():.3f} of cells "
        f"with dose; first hits vs plain: {int(differ.sum())} differ, t equal: {bool(torch.equal(kt, pt))} [{card}]")

    # ---- 16. calibration ------------------------------------------------------------------
    t0 = time.perf_counter()
    watts = simp.calibrate_power(2909.0, 0.8, 1.0)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    if not (np.isfinite(watts) and 100.0 < watts < 1000.0):
        fail(f"calibration: calibrate_power(2909, 0.8, 1.0) gave {watts} W (expected a few hundred)")
    say(f"calibration: calibrate_power(2909, 0.8, 1.0) = {watts:.4f} W in {cal_s:.2f} s "
        f"(native photons through B3) [{card}]")

    # ---- 17. config 5: texel dose maps at 2^25 slots ----------------------------------------
    from uvtrace_torch.geometry.mesh import TriangleMesh
    from uvtrace_torch.io.checkpoint import save_checkpoint
    from uvtrace_torch.io.gltf_export import export_glb
    from uvtrace_torch.io.png import png_bytes, read_png
    from uvtrace_torch.io.texel_bake import bake_texel_atlas
    from uvtrace_torch.ops.shade import dosage_to_color
    from uvtrace_torch.viz.rasterizer import render_heatmap, render_textured

    slots5 = 1 << 25
    p5 = dataclasses.replace(SimParams(), photon_count=1 << 25, max_iterations=1, texel_density=2048.0,
                             texel_max_slots=slots5)
    t0 = time.perf_counter()
    sim5 = Simulator(mesh, p5, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    setup5_s = time.perf_counter() - t0
    n_slots = sim5.atlas.n_slots
    if n_slots > slots5:
        fail(f"config 5: {n_slots} texel slots, budget {slots5}")
    ppl5 = sim5.photons_per_light
    chunks5 = -(-ppl5 // min(sim5.ray_chunk, 1 << (ppl5 - 1).bit_length()))
    torch.cuda.reset_peak_memory_stats()
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim5.compute()
    torch.cuda.synchronize()
    first5_s = time.perf_counter() - t0
    c5_launches = (tm.traverse_mxu_padded.launches, tm.fused_trace_counts.launches, tp.traverse_pallas.launches)
    if c5_launches != (chunks5, 0, 0):
        fail(f"config 5 launched B2, B1, B3 {c5_launches} times, expected ({chunks5}, 0, 0)")
    map5, tex5 = sim5.photon_map.clone(), sim5.photon_map_tex.clone()
    sim5.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim5.compute()
    torch.cuda.synchronize()
    repeat5_s = time.perf_counter() - t0
    if not (torch.equal(map5, sim5.photon_map) and torch.equal(tex5, sim5.photon_map_tex)):
        fail("config 5: a repeat run from reset gave other triangle or texel maps")
    tex_dose5 = sim5.dosage_map_texels(ViewMode.DOSAGE)
    if not (bool(torch.isfinite(tex_dose5).all()) and float(tex_dose5.max()) > 0):
        fail("config 5: texel doses not finite or all zero")
    texels_hit = float((sim5.photon_map_tex > 0).float().mean())
    key5, lamp5 = rng.fold_in(rng.PRNGKey(11), 0), [0.0, mesh.floor_height + p5.light_height, 0.0]
    c1, t1 = texel_launch(sim5, sim5._trace, key5, lamp5, chunk)
    if not torch.equal(per_triangle(sim5.atlas, t1, t_count), c1.long()) or int(c1.sum()) == 0:
        fail("config 5: one chunk's texel counts do not sum to its triangle counts")
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid5 = sim5.dose_grid(4096)
    grid5_s = time.perf_counter() - t0  # ends in the image's copy to the host
    grid5_launches = tm.traverse_mxu_padded.launches
    if grid5_launches != 2 or grid5.shape != (4096, 4096) or not np.isfinite(grid5).all():
        fail(f"config 5 texel grid: {grid5_launches} B2 launches (expected 2), shape {grid5.shape}")
    peak5 = torch.cuda.max_memory_allocated()
    po5, pd5 = probe_rays(verts.min(0), verts.max(0), 4096, device="cuda")
    pick = torch.arange(0, po5.shape[0], po5.shape[0] // (1 << 16), device="cuda")[: 1 << 16]
    grid5_differ = first_hits_vs_plain(scene, po5[pick], pd5[pick], float(verts.min(0)[1]), float(verts.max(0)[1]))
    del po5, pd5
    say(f"config 5: testroomopt, 2^25 photons, texel density 2048: {n_slots} slots (budget {slots5}; "
        f"set-up {setup5_s:.2f} s), {c5_launches[0]} B2 launches ({chunks5} chunks), no B1/B3; first iteration "
        f"{first5_s:.3f} s, repeat {repeat5_s:.3f} s (same maps): {(1 << 25) / repeat5_s / 1e6:.1f} Mrays/s; "
        f"{texels_hit:.4f} of texels hit, texel dose max {float(tex_dose5.max()):.4g} mJ/cm^2; one chunk's "
        f"texels sum to its triangle counts | dose_grid(4096), texel view: {grid5_launches} B2 launches, "
        f"{grid5_s:.3f} s including the image's copy to the host, {(grid5 > 0).mean():.4f} of cells with dose; "
        f"first hits vs plain on 2^16 probes: {grid5_differ} differ, all ties | peak device memory "
        f"{peak5 / 2**30:.2f} GiB [{card}]")
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    host = {}
    t0 = time.perf_counter()
    image5, uvs5 = bake_texel_atlas(sim5.atlas, tex_dose5, p5.min_dosage)
    host["bake"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    png5 = png_bytes(image5)
    host["png"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_glb(os.path.join(out_dir, "c5.glb"), mesh.tris, uvs=uvs5, texture_png=png5)
    host["glb"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(out_dir, "c5.npz"), sim5)
    host["checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    render_textured(TriangleMesh(tris=mesh.tris, uvs=uvs5, texture=image5), width=960, height=720, device="cuda")
    host["texel render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    render_heatmap(mesh.tris, dosage_to_color(sim5.dosage_map(), p5.min_dosage), width=960, height=720)
    host["triangle render"] = time.perf_counter() - t0
    say(f"config 5 host steps: baked atlas {image5.shape[1]}x{image5.shape[0]}, its PNG {len(png5) / 1e6:.1f} MB; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in host.items()) + f" [{card}]")
    del image5, png5

    # ---- 18. texel launches, kernels vs plain -------------------------------------------------
    simp5 = Simulator(mesh, dataclasses.replace(p5, traversal="pallas"), route=[LightPos(0.0, 0.0, 1.0)],
                      device="cuda")
    n18 = 1 << 18
    plain_b2 = dict(extend_fn=tm.traverse_mxu_padded_reference,
                    extend_counts_fn=functools.partial(tm.traverse_mxu_padded_reference, with_counts=True))
    checks18 = []
    for label, s_, kernel_fns, plain_fns, counter in (
            ("B2", sim5, sim5._trace, plain_b2, tm.traverse_mxu_padded),
            ("B3", simp5, simp5._trace, dict(extend_fn=tp.traverse_pallas_reference), tp.traverse_pallas)):
        counter.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kc, kt = texel_launch(s_, kernel_fns, key5, lamp5, n18)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        k_launches = counter.launches
        t0 = time.perf_counter()
        pc, pt = texel_launch(s_, plain_fns, key5, lamp5, n18)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        hits = int(kc.sum())
        tri_diff, tex_diff = int((kc - pc).abs().sum()), int((kt - pt).abs().sum()) // 2
        exact = torch.equal(per_triangle(s_.atlas, kt, t_count), kc.long()) and torch.equal(
            per_triangle(s_.atlas, pt, t_count), pc.long())
        if not exact or k_launches != 1 or tri_diff > 2 * (n18 // 1000) or tex_diff > 2e-3 * hits:
            fail(f"{label} texel launch vs plain: texels sum to triangles {exact}, {k_launches} launches, triangle "
                 f"|diff| {tri_diff} (bound {2 * (n18 // 1000)}), texel counts moved {tex_diff} of {hits} hits")
        checks18.append(f"{label}: {hits} hits, triangle |diff| {tri_diff}, texel counts moved {tex_diff} "
                        f"({tex_diff / hits:.2e} of hits; bound 2e-3), texels sum to triangles; {k_ms:.1f} ms vs "
                        f"plain {p_ms:.1f} ms")
    del simp5
    say(f"texel launches, 2^18 photons, kernels vs plain versions: {'; '.join(checks18)} [{card}]")

    # ---- 19. the CLI on the card ---------------------------------------------------------------
    t0 = time.perf_counter()
    c5 = run_cli(["compute", TESTROOM, "--photon-count", str(1 << 25), "--iterations", "1", "--texel-density",
                  "2048", "--texel-max-slots", str(slots5), "--dose-grid", "4096", "--no-render",
                  "--output", os.path.join(out_dir, "c5")])
    cli5_s = time.perf_counter() - t0
    for name in ("dose_texels.npy", "irradiance_texels.npy", "texel_atlas.npz", "dose_grid.npy", "dose_grid.png"):
        if not os.path.isfile(os.path.join(out_dir, "c5", name)):
            fail(f"compute of config 5 wrote no {name}")
    tex_np = np.load(os.path.join(out_dir, "c5", "dose_texels.npy"), mmap_mode="r")
    if (c5["texels"] != n_slots or tex_np.shape != (n_slots,) or not np.isfinite(c5["tex_dose_max"])
            or not 0 <= c5["tex_dose_min"] <= c5["tex_dose_mean"] <= c5["tex_dose_max"]
            or not 0 <= c5["tex_coverage_above_min"] <= 1 or read_png(os.path.join(out_dir, "c5", "dose_grid.png")).shape
            != (4096, 4096, 3)):
        fail(f"compute of config 5: JSON {c5}, dose_texels.npy {tex_np.shape}")
    del tex_np
    c2dir = os.path.join(out_dir, "route")
    t0 = time.perf_counter()
    cr = run_cli(["compute", TESTROOM, "--route", ROUTE, "--photon-count", str(1 << 22), "--iterations", "1",
                  "--texel-density", "256", "--export-glb", "--checkpoint", "--output", c2dir])
    route_s = time.perf_counter() - t0
    for name, shape in (("dose.png", (720, 960, 3)), ("irradiance.png", (720, 960, 3)), ("legend.png", (32, 256, 3)),
                        ("dose_texels.png", (720, 960, 3))):
        img = read_png(os.path.join(c2dir, name))
        if img.shape != shape or img.max() == 0:
            fail(f"compute with route: {name} is {img.shape}, max {img.max()}")
    for name in ("dose.glb", "dose_texels.glb"):
        back = load_glb(os.path.join(c2dir, name))
        if back.triangle_count != mesh.triangle_count or (name == "dose_texels.glb" and back.texture is None):
            fail(f"compute with route: {name} loads back as {back.triangle_count} triangles")
    t0 = time.perf_counter()
    run_cli(["render", TESTROOM, "--checkpoint", os.path.join(c2dir, "checkpoint.npz"),
             "--output", os.path.join(out_dir, "render.png")])
    render_s = time.perf_counter() - t0
    if read_png(os.path.join(out_dir, "render.png")).shape != (720, 960, 3):
        fail("render of the checkpoint: wrong image size")
    t0 = time.perf_counter()
    resumed = run_cli(["compute", TESTROOM, "--route", ROUTE, "--photon-count", str(1 << 22), "--iterations", "2",
                       "--texel-density", "256", "--no-render", "--resume", os.path.join(c2dir, "checkpoint.npz"),
                       "--output", os.path.join(out_dir, "resumed")])
    resume_s = time.perf_counter() - t0
    if resumed["photons"] != 2 * cr["photons"] or resumed["texels"] != cr["texels"]:
        fail(f"compute --resume: {resumed['photons']} photons after {cr['photons']}")
    shutil.rmtree(out_dir, ignore_errors=True)
    say(f"CLI on the card: compute of config 5 with --dose-grid 4096 --no-render {cli5_s:.2f} s ({c5['seconds']:.3f} "
        f"s computing; texels {c5['texels']}, tex dose mean {c5['tex_dose_mean']:.4g} max {c5['tex_dose_max']:.4g}, "
        f"coverage {c5['tex_coverage_above_min']:.4f}) | compute with assets/route.xml, 2^22 photons, texel density "
        f"256 ({cr['texels']} slots), every export and a checkpoint {route_s:.2f} s ({cr['seconds']:.3f} s "
        f"computing); render of its checkpoint {render_s:.2f} s; compute --resume to 2 iterations {resume_s:.2f} s, "
        f"{resumed['photons']} photons [{card}]")

    del sim5, tex_dose5
    d4 = diff_phases(mesh, card, out_dir)

    # ---- 26. the native cluster builder ---------------------------------------------------
    nat = native_phase(card, mesh)

    # ---- 27. one NCCL rank: config 5 on a 1 x 1 mesh -----------------------------------------
    import torch.distributed as dist

    from uvtrace_torch.parallel import initialize, make_2d_mesh

    torch.cuda.set_device(0)
    initialize("nccl", world_size=1)
    sim11 = Simulator(mesh, p5, route=[LightPos(0.0, 0.0, 1.0)], device_mesh=make_2d_mesh(1, 1), device="cuda:0")
    sim11.compute()
    sim11.reset()
    tm.fused_trace_counts.launches = tm.traverse_mxu_padded.launches = tp.traverse_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim11.compute()
    torch.cuda.synchronize()
    nccl_s = time.perf_counter() - t0
    nccl_launches = (tm.traverse_mxu_padded.launches, tm.fused_trace_counts.launches, tp.traverse_pallas.launches)
    if nccl_launches != (chunks5, 0, 0):
        fail(f"config 5 on one NCCL rank launched B2, B1, B3 {nccl_launches} times, expected ({chunks5}, 0, 0)")
    if not (torch.equal(sim11.photon_map, map5) and torch.equal(sim11.full_texel_map(sim11.photon_map_tex), tex5)):
        fail("config 5 on one NCCL rank (1 x 1 mesh): other triangle or texel maps than phase 17's")
    if sim11.collectives.staged_bytes:
        fail(f"config 5 on one NCCL rank staged {sim11.collectives.staged_bytes} bytes through the host")
    nccl_calls = sim11.collectives.calls
    del sim11
    dist.destroy_process_group()
    say(f"one NCCL rank: config 5 on a 1 x 1 (rays x texels) mesh, cuda:0: the maps of phase 17 bit for bit; "
        f"{nccl_s:.3f} s per iteration vs {repeat5_s:.3f} s unsharded (phase 17, same run), {nccl_launches[0]} B2 "
        f"launches, {nccl_calls} collectives over the 2 iterations, none staged [{card}]")

    # ---- 28. the CLI under torchrun, one rank ------------------------------------------------
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    c28 = ["compute", TESTROOM, "--photon-count", str(1 << 22), "--iterations", "1", "--texel-density", "256",
           "--dose-grid", "4096", "--no-render"]
    run_cli([*c28, "--output", os.path.join(out_dir, "one")])
    t0 = time.perf_counter()
    rc, out28, err28 = run_group([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                                  "1", "-m", "uvtrace_torch", *c28, "--shards", "-1", "--output",
                                  os.path.join(out_dir, "torchrun")], timeout=300)
    torchrun_s = time.perf_counter() - t0
    json28 = [json.loads(ln) for ln in out28.splitlines() if ln.startswith("{")]
    if rc != 0 or len(json28) != 1:
        fail(f"compute under torchrun exited {rc} with {len(json28)} JSON lines: {err28[-3000:]}")
    for name in ("dose_mJ_cm2.npy", "irradiance_uW_cm2.npy", "dose_texels.npy", "irradiance_texels.npy",
                 "dose_grid.npy"):
        if not np.array_equal(np.load(os.path.join(out_dir, "one", name)),
                              np.load(os.path.join(out_dir, "torchrun", name))):
            fail(f"compute under torchrun (--shards -1, one rank): {name} differs from the unsharded CLI's")
    shutil.rmtree(out_dir, ignore_errors=True)
    say(f"CLI under torchrun --nproc-per-node 1: compute, 2^22 photons, texel density 256 ({json28[0]['texels']} "
        f"slots), --dose-grid 4096, --shards -1: the unsharded CLI's five maps bit for bit; {torchrun_s:.2f} s with "
        f"torchrun's start-up ({json28[0]['seconds']:.3f} s computing) [{card}]")

    # ---- 29. two ranks share cuda:0 over gloo -----------------------------------------------
    ref_dir = os.path.join(ROOT, "build", "chip_smoke_ranks")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    route = load_route_xml(ROUTE)
    refs = {}
    for name, fields in ROUTE_RUNS.items():
        s29 = Simulator(mesh, route_params(route, TWO_RANKS, fields), route=route.waypoints,
                        ray_chunk=TWO_RANKS["route_chunk"], device="cuda")
        s29.compute()
        refs[f"route_{name}"] = s29.photon_map.cpu().numpy()
    del s29
    np.savez(os.path.join(ref_dir, "ref.npz"), map5=map5.cpu().numpy(), step_loss=d4["step"]["loss"],
             step_g_raw=d4["step"]["g_raw"], step_g_lg=d4["step"]["g_lg"], **refs)
    np.save(os.path.join(ref_dir, "tex5.npy"), tex5.cpu().numpy())
    np.save(os.path.join(ref_dir, "grid5.npy"), grid5)
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{os.path.join(ref_dir, 'store')}"
    procs = [ctx.Process(target=two_rank_worker, args=(r, 2, init, ref_dir, TWO_RANKS, results)) for r in range(2)]
    t0 = time.perf_counter()
    for p_ in procs:
        p_.start()
    reports = {}
    try:
        for _ in procs:
            r, rep = results.get(timeout=400)
            if not isinstance(rep, dict):
                fail(f"two ranks on cuda:0 over gloo: rank {r} failed:\n{rep}")
            reports[r] = rep
    except Exception as e:  # queue.Empty: a rank hung
        fail(f"two ranks on cuda:0 over gloo: {type(e).__name__} after {time.perf_counter() - t0:.0f} s")
    finally:
        for p_ in procs:
            p_.join(timeout=60)
            if p_.is_alive():
                p_.kill()
    ranks_s = time.perf_counter() - t0
    shutil.rmtree(ref_dir, ignore_errors=True)
    expect = {"c5_launches": (chunks5 // 2, 0, 0), "grid_launches": (2, 0, 0), "direct_launches": (0, 12, 0),
              "pallas_launches": (0, 0, 12), "bounces_launches": (36, 0, 0), "step_launches": (12, 0, 0)}
    for r, rep in sorted(reports.items()):
        bad = [k for k in ("c5_equal", "grid_equal", "direct_equal", "pallas_equal", "bounces_equal", "step_equal")
               if not rep[k]]
        bad += [f"{k} {rep[k]} (expected {v})" for k, v in expect.items() if tuple(rep[k]) != v]
        if bad:
            fail(f"two ranks on cuda:0 over gloo, rank {r}: " + ", ".join(bad))
    r0 = reports[0]
    say(f"two ranks on cuda:0 over gloo (correctness and per-rank memory; two ranks on one card measure no "
        f"scaling): config 5 on 1 x 2, bit-equal to phase 17: " + "; ".join(
            f"rank {r}: {rep['c5_launches'][0]} B2 launches, {rep['c5_own_slots']} own slots, {rep['c5_s']:.3f} s, "
            f"peak device memory {rep['c5_peak'] / 2**30:.2f} GiB (with the grid {rep['peak'] / 2**30:.2f} GiB; "
            f"phase 17: {peak5 / 2**30:.2f} GiB), staged {rep['c5_staged_bytes'] / 2**20:.1f} MiB in "
            f"{rep['c5_staged_s']:.3f} s" for r, rep in sorted(reports.items()))
        + f" | dose_grid(4096) on 1 x 2, equal to phase 17's: {r0['grid_s']:.3f} s, staged in all "
        f"{r0['staged_bytes'] / 2**20:.1f} MiB in {r0['staged_s']:.3f} s | route.xml on 2 x 1, 2^22 photons, "
        f"bit-equal to one rank: direct (B1) {r0['direct_s']:.3f} s, pallas (B3) {r0['pallas_s']:.3f} s, 2 "
        f"bounces (B2) {r0['bounces_s']:.3f} s | config 4 direct step, shadow rays on 2 ranks: phase 22's loss and "
        f"gradients | {ranks_s:.1f} s with start-up [{card}]")

    # ---- 30-35. the plain traversals -------------------------------------------------------
    plain_traversal_phases(mesh, card, out_dir)

    # ---- 36. result -----------------------------------------------------------------------
    # outputs: t and slot or id, 8 B a ray; per-slot counts 4 B a slot
    out_rays, out_counts = 8 * chunk, 4 * scene.tri_idx_flat.numel()
    # B1: the real triangles of the clusters each packet visits, the first kv[p] in (entry, id) order
    pb = tm.generate_fused_rays(key, lamp, 1.0, chunk, device="cuda")[2]
    order = torch.sort(tm.frustum_entries(scene.box6, pb), dim=1, stable=True).indices
    visited = torch.arange(scene.n_clusters, device="cuda")[None] < kv[:, None]
    b1_tris = int((scene.tri_used[order] * visited).sum())
    b1_bound = roofline(nbytes(scene.box6, scene.tri_feat, scene.tri_used) + out_rays + out_counts,
                        float(b1_tris) * 1024 * FLOPS_PLUCKER)
    # B2: the real triangles of the clusters each ray needs under the visit
    # rule, whatever walks them
    b2_scene_bytes = nbytes(scene.node_box, scene.node_meta, scene.tri_feat)
    b2_bound = roofline(nbytes(rays.orig, rays.dir) + b2_scene_bytes + out_rays + out_counts,
                        float(split_needed_tris.sum()) * FLOPS_PLUCKER)
    seg_bound = roofline(nbytes(bo, bd) + b2_scene_bytes + out_rays,
                         float(seg_needed_tris.sum()) * FLOPS_PLUCKER)
    b3_bound = roofline(nbytes(native20.orig, native20.dir, pscene.node_box, pscene.node_meta, pscene.tri,
                               pscene.tri_used, pscene.tri_idx_flat) + out_rays, float(b3_tests) * FLOPS_MT)
    say(json.dumps({"kernels": [{
        "name": "fused_trace_counts", "route": "cuda", "source": "uvtrace_torch/csrc/fused_trace.cu",
        "replaces": "uvtrace/ops/traverse_mxu.py:807", "launches": launches,
        "max_abs_err": t_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
        "route_2x1_launches_per_rank": [reports[r]["direct_launches"][1] for r in sorted(reports)],
        "b1_443k_native_ms": nat["native"]["b1"], "b1_443k_numpy_ms": nat["numpy"]["b1"],
    }, {
        "name": "traverse_mxu_padded", "route": "cuda", "source": "uvtrace_torch/csrc/traverse_mxu.cu",
        "replaces": "uvtrace/ops/traverse_mxu.py:445", "launches": b2_launches,
        "max_abs_err": max(split_err, bounce_err), "ms": split_ms, "plain_ms": split_plain_ms,
        "bound_ms": b2_bound[0], "bound_by": b2_bound[1], "library_ms": None,
        "segment_ms": segment_ms, "segment_bound_ms": seg_bound[0], "segment_bound_by": seg_bound[1],
        "config5_launches": c5_launches[0], "config4_direct_launches": d4["b2_launches"],
        "config5_1x2_launches_per_rank": [reports[r]["c5_launches"][0] for r in sorted(reports)],
        "config4_direct_step_2_ranks_launches_per_rank": [reports[r]["step_launches"][0] for r in sorted(reports)],
        "b2_443k_native_ms": nat["native"]["b2"], "b2_443k_numpy_ms": nat["numpy"]["b2"],
        "b2_shadow_direct_ms": d4["direct"][0], "b2_shadow_direct_plain_ms": d4["direct"][1],
        "b2_shadow_direct_bound_ms": d4["direct"][2], "b2_shadow_direct_bound_by": d4["direct"][3],
        "b2_shadow_source_ms": d4["source-to-source"][0], "b2_shadow_source_bound_ms": d4["source-to-source"][2],
        "b2_shadow_receiver_ms": d4["receiver chunk"][0], "b2_shadow_receiver_plain_ms": d4["receiver chunk"][1],
        "b2_shadow_receiver_bound_ms": d4["receiver chunk"][2], "b2_shadow_receiver_bound_by": d4["receiver chunk"][3],
        "b2_shadow_max_abs_err": d4["max_dt"],
    }, {
        "name": "traverse_pallas", "route": "cuda", "source": "uvtrace_torch/csrc/traverse_pallas.cu",
        "replaces": "uvtrace/ops/traverse_pallas.py:242", "launches": b3_launches,
        "max_abs_err": b3_err, "ms": b3_ms["native"], "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None,
        "route_2x1_launches_per_rank": [reports[r]["pallas_launches"][2] for r in sorted(reports)],
        "b3_443k_native_ms": nat["native"]["b3"], "b3_443k_numpy_ms": nat["numpy"]["b3"],
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
