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
  20. the kernels' JSON line (times, plain times and bounds of all three
     kernels; B2's bounce segment and config 5's launches under keys of
     their own), then {"ok": true, "device": {...}} last.
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
PINNED_TOTAL, PINNED_TOL = 4_624_690, 64
PINNED_SPLIT_TOTAL = 4_624_808
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
    from uvtrace_torch.ops.cluster import build_clusters
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
    pscene = tp.build_pallas_scene(build_clusters(mesh.tris, cluster_size=128), device="cuda")
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

    # ---- 20. result -----------------------------------------------------------------------
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
    }, {
        "name": "traverse_mxu_padded", "route": "cuda", "source": "uvtrace_torch/csrc/traverse_mxu.cu",
        "replaces": "uvtrace/ops/traverse_mxu.py:445", "launches": b2_launches,
        "max_abs_err": max(split_err, bounce_err), "ms": split_ms, "plain_ms": split_plain_ms,
        "bound_ms": b2_bound[0], "bound_by": b2_bound[1], "library_ms": None,
        "segment_ms": segment_ms, "segment_bound_ms": seg_bound[0], "segment_bound_by": seg_bound[1],
        "config5_launches": c5_launches[0],
    }, {
        "name": "traverse_pallas", "route": "cuda", "source": "uvtrace_torch/csrc/traverse_pallas.cu",
        "replaces": "uvtrace/ops/traverse_pallas.py:242", "launches": b3_launches,
        "max_abs_err": b3_err, "ms": b3_ms["native"], "plain_ms": b3_plain_ms,
        "bound_ms": b3_bound[0], "bound_by": b3_bound[1], "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
