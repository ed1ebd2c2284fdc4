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
     kernel's pinned 4,624,690 within 64 (the bench's gate,
     uvtrace_torch/bench.py:check_pinned_total, which phases 7, 11, 30 and
     36 use too; bench.py:146-164);
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
     chunks x (1 + 4), K4's and K5's chunks x 4, B1's and K1's none, the
     dose must be finite, deposits over
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
     assets/lange_route.xml on the test room, the rays of each kind (rod to
     triangle samples, 4 x 44,866, drawn as the direct estimator draws them;
     as K12 makes them for the 2-bounce term, the 64 x 64 source-to-source
     rays and one receiver chunk of 16 x 179,464 rays that start on
     surfaces: 5 batches a waypoint),
     sorted and padded as B2 gets them: t and
     slots by phase 3's rule, visibility bits equal but on at most 0.1% of
     rays, and no ray that the plain version finds occluded visible to the
     kernel; B2 timed per 2^20 rays of each kind, with its bound;
  22. config 4 (CONFIGS.md section 4), the direct objective at full width:
     optimize_route on the test room with lange_route.xml (12 waypoints),
     n_samples 4, lr 0.05, the CLI's bounds, 1 warm-up and 5 timed steps
     between synchronize fences (s/step); B2 launches must equal 12 per step
     and the final dose, B1's and B3's none, K8, K7 and K9 one a waypoint
     and evaluation and K10 one a waypoint and step; loss, waypoints and
     gradients finite and not zero; the device time and the device launches
     of one step (profiler) and the idle share of the unprofiled step;
     autograd of mean(irradiance) against
     central FD in lamp x and z (eps 1e-3, rtol 0.08, atol 1e-5);
  23. config 4 with interreflection (rho 0.25, 64 sources): 2 bounces, 1
     warm-up and 2 timed steps; 4 bounces, 1 timed step; s/step, B2
     launches (the route's transfer plan 5 a waypoint once, then 2 a
     waypoint and evaluation), K7-K14's (the plan K11 one a waypoint, K12
     and K13 5; an evaluation K12 and K13, kept-visibility mode, 4 a
     waypoint; K14 4 a backward), peak device memory, finite results; one
     step of each by hand, without and with the plan (bit for bit the same
     loss and gradients): its peak memory above its inputs, its device
     time, B2's share and its device launches (profiler); then the receiver
     pass of
     waypoint 0 forward and backward under the profiler: no device launch
     besides K12, K7, B2, K13 and K14 but the 4 stable sorts', B2's own
     memsets' and the backward's 4;
  24. the dose image: plan_dose_image(128) and dose_image over the 12
     waypoints (n_samples 8) with the gradient of the worst lit pixel,
     timed; 14 B2 launches, K8, K9 and K10 12 and K7 14 (the plan's two
     probe traces pack through it); the plan's first hits equal the plain version's
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
  36. the bench's headline (uvtrace_torch/bench.py:main, in this process)
     on backends mxu-fused (B1), mxu (B2) and pallas (B3) at 5 and 20
     iterations of 2^20 rays, and clustered at 5: each total within its pin
     (4,624,690 / 18,499,935 fused, 4,624,808 / 18,500,845 the others,
     tolerance 64 per 5 iterations; the gate of bench.py:146-164), each
     kernel launched 4 x iterations times (one untimed run, 3 timed) and no
     other; the JSON lines printed, and for each kernel backend the device
     time of one more 20-iteration run (torch.profiler) beside the best
     run's wall time;
  37. bounce_row (--bounce): testroomopt at 2^20 photons, 4 bounces, rho
     0.5, and the 443k box room at rho 0.25: 20 B2 launches each, and each
     configuration's deposits over its primary hits above 1 and at most
     (1 - rho^5) / (1 - rho), their expectation in a closed room, plus 5
     standard deviations of their mean;
  38. scaling_rows(--devices 1): one spawned NCCL rank, efficiency 1.0;
     one device more than the cards: SystemExit;
  39. entry("cuda")'s step (one B2 launch) against the same step through
     B2's plain version: the step's rays by phase 6's rule, the photon maps
     apart by at most 2 hits a slot mismatch; dryrun_multichip(1) on one
     NCCL rank (2 [dryrun] lines) and dryrun_multichip(2, share_cards=True)
     on two gloo ranks sharing cuda:0 (3 lines, each rank half the texels);
  40. `python -m uvtrace_torch bench --bounce --rays 65536 --iters 1` in a
     process of its own: one JSON line with bench.py's keys;
  41. K1, threefry_uniform (rng.uniform on the card) against
     rng.uniform_reference on the card, bit for bit, at 2^20, 2^20 + 37
     and config 4's (4, triangles, 1), in [0, 1), [-1, 1) and [0, 2 pi);
  42. K2, generate_stratified against generate_stratified_reference, bit
     for bit, at 2^20 (packet 1024, grid (4, 16, 16)) and 2^20 - 1 (packet
     1023, grid (1, 25, 41));
  43. K3, generate_reference against generate_reference_reference, bit for
     bit, at 2^20 and 2^20 + 37 with photon ids from 0, 2^24 - 7, 2^31 -
     2^19 and 2^31 - 1000; each of 41-43 timed beside its bound: the
     kernel's time a launch (CUDA events around 50 launches enqueued behind
     a sleeping kernel, so that they run back to back, each writing a fresh
     output) at 2^20 and at the odd size, the kernel alone at 2^20
     (torch.profiler's device time over its recorded kernels), a wrapper call between CUDA events (host work
     included: keys, allocation, the ctypes call), the plain version at 2^20;
  44. K4, bounce_step against bounce_step_reference, bit for bit (new
     origins and directions, alive lanes, sort keys), on the 4 bounces of a
     config-2 chunk (2^20 stratified primaries through B2, each bounce
     segment made by K4 from the one before, coherence-sorted and traced by
     B2) at 2^20 and at 2^20 + 37 (the first 37 rays repeated);
  45. K5, hit_histogram against hit_histogram_reference, bit for bit into
     non-zero counts, on that chunk's 4 bounce segments (their alive hits)
     at both sizes; each segment's time beside index_add_'s on the same ids
     sent, as the port did until now, with every miss and dead lane into
     one overflow bin;
  46. K6, texel_bin against texel_bin_reference with config 5's atlas, bit
     for bit into non-zero counts, on the chunk's primaries and its first
     bounce segment (alive lanes) at both sizes; each of 44-46 timed as
     41-43 are (back to back, alone, a call, plain) beside its bound;
  47. K8 shadow_sample and K7 pack_sorted (csrc/diff_ops.cu) against their
     plain versions, bit for bit, at full width: testroomopt with
     lange_route.xml's waypoints 0 and 6 (n_samples 4: 4 x 44,866 rays) and
     the 128^2 dose-image plan's points (n_rod 8: 8 x 16,384 rays), the sort
     between them torch.sort's;
  48. K9 visibility_reduce on those batches traced by B2: the visibility
     bits equal (0 rays differ), E within rtol 1e-6;
  49. K10 direct_grad on a config-4 dL/dE (a softmin's weights): within
     1e-5 of the sum of the absolute values of the terms its plain version
     adds, the same on a repeat; then the Function's step (E and the lamp
     and power gradients) twice, bit for bit, its E equal to K8, K7, B2 and
     K9 in turn; each of K7-K10 timed at waypoint 0's and the plan's shapes
     as 41-43 are (back to back, alone, a call, plain) beside its bound;
     autograd against central FD of mean(irradiance) at waypoint 6, with
     the rays whose visibility flips between x - eps and x + eps;
  50. 100 steps of the direct optimize_route (CONFIGS.md section 4: lr 0.05,
     n_samples 4, the CLI's bounds): s/step (median and quartiles), B2 and
     K7-K10 launches a step (K8, K7, K9 12 an evaluation, K10 12 a step),
     finite results;
  51. K11 source_sample against its plain version, bit for bit, at config
     4's waypoint 0 (lange_route.xml, rho 0.25, 64 sources);
  52. K12 transfer_rays, bit for bit: the 64 x 64 source-to-source rays and
     the 4 receiver chunks of 16 x 179,464 rays (4 samples of 44,866
     triangles drawn in the kernel);
  53. K13 transfer_reduce on those batches traced by B2, bit for bit: the
     matrix F V (1 - I), and chunk after chunk the strength-weighted sums
     and the visibility bytes;
  54. K14 transfer_grad on a config-4 dL/dout (a softmin's weights), each
     chunk within 1e-5 of the sum of the absolute values of the terms its
     plain version adds, the same on a repeat; the 2-bounce term's step
     (value, lamp, power and reflectance gradients) twice bit for bit, its
     value w mean_s of K13's sums; each of K11-K14 (and K12's and K13's
     matrix cases) timed as 41-43 are (back to back, alone, a call, plain)
     beside its bound;
  55. the kernels' JSON line (times, plain times and bounds of the seventeen
     kernels; B2's bounce segment, config 5's and config 4's launches and
     its shadow rays under keys of their own, the launches per rank of the
     sharded phases, the 443k times on native and numpy clusters, the
     headline's launches and ms per iteration; each of K1-K6's launches on
     every path that counted them; K4's time per bounce, K5's and
     index_add_'s per segment), then {"ok": true, "device": {...}} last.
The sampler and launch-layer kernels are the end-to-end check of themselves
too: phases 7, 11, 30 and 36 draw their pinned totals' rays through K2 (and
count B3's and the clustered traversal's hits with K5), phase 13 replays
the reference sampler's seed, phase 8's deposits are bounded and its repeat
gives the same map, and phases 5, 8, 12, 13, 17, 22, 23, 24, 36 and 50 set
the counts of K1-K14 to 0 before their path and require its launches after it
(config 2: K2 a chunk, K4 and K5 a bounce, no K1; config 5: K2 and K6 a
chunk; the pallas path: K1 3 a chunk and K5 one; the reference path: K3 and
K5 a chunk; config 4's objective and the dose image: K8, K7 and K9 a
waypoint, K10 a waypoint's backward, no K1; the split bench backends K2 an
iteration, B3's and the clustered one's K5; none on the direct path).
Phases 8, 14 and 18 compare launches through the kernels with launches
through all their plain versions (B2 or B3, K4, K5, K6); phase 8 prints
the device launches of one config-2 chunk of 2^20 (torch.profiler).
The bound of a kernel is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its operations over the peak
for their type: f32 operations over 67 TFLOP/s, the H100's published peaks
at 700 W. The samplers' integer and f32 operations (32-bit) are counted
together against the card's issue rate: 4 schedulers an SM, each issuing
one 32-lane warp instruction a clock, x the SMs x the maximum SM clock
nvidia-smi reports (128 x 132 x 1980 MHz: 33.5 T operations/s, the f32
peak's instruction rate). The 64 INT32 lanes an SM has (H100 SXM) give
no lower bound on the time: ptxas issues part of the integer work as IMAD
on the FMA pipe (K1's kernel-only time is held against both rates in
phase 41). The operations are counted
from this run's data, on real triangles (a cluster's slots in use, not its
padding): B1's from the clusters its packets visit (the plain version's
frustum order, the kernel's visit counts) x 1024 rays x 80 flops, B3's from
its active columns x 8 rays x the cluster's triangles x 46 flops (the plain
version's walk, weighted), B2's from the work its inputs need whatever walks
them, the triangles of the clusters each ray needs x 80 flops; the
samplers' per element (K1_OPS, K2_OPS, K3_OPS below), K3's with the disc
candidates this run's photons draw (replayed with the plain streams).
Imports nothing of JAX.
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


def pinned(label: str, total: int, fused: bool, iters: int) -> str:
    """The bench's pin gate (uvtrace_torch/bench.py:check_pinned_total, the
    JAX package's pins of bench.py:146-164): fails the run outside the
    tolerance; returns the line's account of the total."""
    from uvtrace_torch.bench import check_pinned_total

    try:
        pin, tol = check_pinned_total(total, fused, iters)
    except RuntimeError as e:
        fail(f"{label}: {e}")
    return f"{total} vs {pin}, diff {total - pin} (tolerance {tol})"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def roofline(n_bytes: float, flops: float):
    """(bound ms, what bounds it): the least time the card could take."""
    b_ms, f_ms = n_bytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


# 32-bit integer operations of one threefry-2x32 draw, as few as the card
# can issue them: 20 rounds of add, rotate (one funnel shift) and xor; 5 key
# injections into x1 (the round constant folded in) and the last one into
# x0 (the other four fold into the next round's three-input add); the
# counter's add and the final xor
THREEFRY_INT_OPS = 20 * 3 + 5 + 1 + 1 + 1
# (int32, f32) operations. K1 per element: the draw, then shift and or of
# the mantissa trick; f32 sub, mul, add, max
K1_OPS = (THREEFRY_INT_OPS + 2, 4)
# K2 per ray: three K1 elements and the stratum cell's 4 divisions and
# remainders; f32: the uniforms' 12, height 2 and origin 2, dir.y 4, phi 3,
# r 4 (with its sqrt), cos, sin and 2 products
K2_OPS = (3 * K1_OPS[0] + 4, 3 * K1_OPS[1] + 2 + 2 + 4 + 3 + 4 + 2 + 2)
# K3 per photon (fixed part): the thread id's 3, the truncation, WangHash's 9
# and two xorshift32 steps of 6; f32: the seed's conversion and 4 adds, the
# clamp 2, two RandomFloats of 2, dir.y 2, xz_len 4, the normalisation 7, the
# origin 2. Per (x, z) candidate drawn: 2 xorshift32 steps (12) and f32 12
# (2 RandomFloats, 2 x (mul, sub), the disc test's 4)
K3_OPS, K3_PAIR_OPS = (3 + 1 + 9 + 2 * 6, 5 + 2 + 4 + 2 + 4 + 7 + 2), (12, 12)
# K4 per lane that hits and was alive: its roulette draw (a K1 element) and
# the compare; per survivor two more draws and the step's f32 work: facing 5,
# the hit point 6, the hemisphere 9 (sqrt, cos and sin one each), the basis
# 14, x t1 + y t2 + z n 15, the offset origin 6, the key's 3 divisions and
# floors; int32: the key's conversions, masks and sums (15). The four key
# splits are once a launch.
K4_RR_OPS = (K1_OPS[0], K1_OPS[1] + 1)
K4_SURVIVOR_OPS = (2 * K1_OPS[0] + 15, 2 * K1_OPS[1] + 5 + 6 + 9 + 14 + 15 + 6 + 6)
# K6 per counted hit: f32 the hit point and w 9, five dot products 25, det 4,
# u and v 8, the clamps 4, the fold 3, the cells 4; int32: the slot's 6 and
# the conversions 2
K6_HIT_OPS = (8, 9 + 25 + 4 + 8 + 4 + 3 + 4)
# Bytes the launch layer's kernels must move, counted from the run's own
# data: an input element read once where some lane needs it, an output
# written once. K4: every lane reads its hit (i32) and alive flag (bool) and
# writes a new origin and direction (f32[3] each), alive flag and sort key
# (i32); a survivor reads its origin, direction and t (f32); the
# reflectance (f32) of each slot a roulette lane hit and the normal
# (f32[3]) of each slot a survivor hit, once a slot.
K4_LANE_BYTES = 4 + 1 + 12 + 12 + 1 + 4
K4_SURVIVOR_BYTES = 12 + 12 + 4
K4_REFLECTANCE_BYTES, K4_NORMAL_BYTES = 4, 12
# K5: the alive flag of every lane, the id (i32) of the lanes that count, a
# read and a write (i32) of each bin they add into
K5_ALIVE_BYTES, K5_ID_BYTES, K5_BIN_BYTES = 1, 4, 8
# K6: every lane's hit (and alive flag); a counted hit's origin, direction
# and t; its triangle's v0, e1, e2 (f32[3] each) and atlas base and k (i32),
# once a triangle; a read and a write of each texel it adds into
K6_LANE_BYTES, K6_HIT_BYTES, K6_TRI_BYTES, K6_TEXEL_BYTES = 4, 12 + 12 + 4, 3 * 12 + 4 + 4, 8


# The direct estimator's kernels (csrc/diff_ops.cu), (int32, f32) operations.
# K8 per ray: int32 the coherence key (3 compares, 3 conversions, masks and
# sums: 15); f32 d 3, d.d 5, sqrt, clamp and 3 divisions 5, the clamp, d.n 5,
# abs, sqrt, 2 divisions and a product 5; per triangle ray also its u and v
# draws (two K1 elements), the fold 4 and q 12; per sample the rod draw (a K1
# element) and its height 2. The key splits are a launch's, not a ray's.
K8_RAY_OPS = (15, 3 + 5 + 5 + 1 + 5 + 5)
K8_TRI_OPS = (2 * K1_OPS[0], 2 * K1_OPS[1] + 4 + 12)
K8_SAMPLE_OPS = (K1_OPS[0], K1_OPS[1] + 2)
# K10 per visible ray: K8's d again (K8_TRI_OPS for a triangle target), d.d 5,
# the clamp, d.n 5, sqrt, G 4, sign 2, the two coefficients 6, the three
# components 9, the five sums 6; per target the five products 7
K10_RAY_OPS = (0, 3 + 5 + 1 + 5 + 1 + 4 + 2 + 6 + 9 + 6)
K10_TARGET_OPS = (0, 7)
# Bytes, each input read once where some lane needs it, each output written
# once. K8: a target's f32[3] rows (v0, e1, e2, normal, or point and normal),
# per ray its direction, length, G and key, per sample its rod point. K7: per
# ray its index (i64) and direction read, its origin row once a sample, the
# packed origin and direction and its inverse position written; a padding
# ray's 24 B written. K9: per ray its t, inverse position, length and G
# read, its visibility byte written; per target E. K10: per ray the
# visibility byte, per target dL/dE and its rows; the 5 gradients.
K8_RAY_BYTES, K8_SAMPLE_BYTES = 12 + 4 + 4 + 4, 12
K7_RAY_BYTES, K7_SAMPLE_BYTES, K7_PAD_BYTES = 8 + 12 + 12 + 12 + 4, 12, 24
K9_RAY_BYTES, K9_TARGET_BYTES = 4 + 4 + 4 + 4 + 1, 4
K10_RAY_BYTES, K10_TARGET_BYTES = 1, 4
# The interreflection term's kernels (csrc/bounce_ops.cu), (int32, f32)
# operations. K11 per source: the choice draw (a K1 element), 1 - u and the
# product; the two key splits (threefry blocks) and the u and v draws (two K1
# elements), the fold 4 and x 12; per step of the area CDF's binary search
# the midpoint and the branch (3) and a compare.
K11_SOURCE_OPS = (3 * K1_OPS[0] + 2 * THREEFRY_INT_OPS, 3 * K1_OPS[1] + 2 + 4 + 12)
K11_SEARCH_OPS = (3, 1)
# K12 per ray: int32 the coherence key (15); f32 d 3, d.d 5, sqrt, the
# clamp and 3 divisions 5, the clamp, sqrt, two dot products 10, two abs, two
# divisions, the product, pi D and the division 7. Per drawn receiver the two
# key splits and its u and v draws, the fold 4 and q 12.
K12_RAY_OPS = (15, 3 + 5 + 5 + 2 + 10 + 7)
K12_DRAW_OPS = (2 * THREEFRY_INT_OPS + 2 * K1_OPS[0], 2 * K1_OPS[1] + 4 + 12)
# K13 per ray: the threshold 2, the compare, F V, s (F V) and the sum; in
# kept-visibility mode the byte's test in place of the threshold and compare.
K13_RAY_OPS, K13_KEPT_RAY_OPS = (0, 6), (1, 3)
# K14 per visible ray: K12's F again (d 3, d.d 5, the clamp, sqrt, two dot
# products 10, abs 2, divisions 2, the product, pi D, the division: 26) and
# g F; per ray and source the block sum's add.
K14_RAY_OPS, K14_TERM_OPS = (0, 27), (0, 1)
# Bytes, each input read once where some lane needs it, each output written
# once. K11: per source its triangle's rows (v0, e1, e2, normal: 48 B), the
# CDF entries its search reads (4 B a step) and its outputs (8 + 12 + 12 B).
# K12: per ray its direction, length, F and key; per source its point and
# normal; the receivers' rows once: a triangle's 48 B, or a point's 24 B.
# K13: per ray its t (gathered), inverse position, length and F read, in
# reduce mode its visibility byte written, per receiver the sum written (and
# the sum so far read); in matrix mode per ray its product written; in
# kept-visibility mode per ray its F and its byte read. K14: per
# ray its visibility byte; per receiver dL/dout and its rows; per source its
# rows and its gradient.
K11_SOURCE_BYTES, K11_STEP_BYTES = 48 + 32, 4
K12_RAY_BYTES, K12_SOURCE_BYTES = 12 + 4 + 4 + 4, 24
K13_RAY_BYTES, K13_VIS_BYTES, K13_RECEIVER_BYTES, K13_SOURCE_BYTES = 16, 1, 4, 4
K13_KEPT_RAY_BYTES = 4 + 1
K14_RAY_BYTES, K14_RECEIVER_BYTES, K14_SOURCE_BYTES = 1, 4, 24 + 4


def issue_peak_ops_s(clock_mhz: float, sms: int) -> float:
    """32-bit operations per second, integer and f32 together: each of an
    SM's 4 schedulers issues one warp instruction (32 lanes) a clock, at the
    SM clock nvidia-smi reports as the card's maximum. (The 64 INT32 lanes
    of an SM are not the ceiling for integer work: ptxas issues part of it
    as IMAD on the FMA pipe.)"""
    return 128.0 * sms * clock_mhz * 1e6


def sampler_roofline(n_bytes: float, ops: float, issue_peak: float):
    """(bound ms, what bounds it) of a sampler kernel: the larger of its
    bytes over 3.35 TB/s and its 32-bit operations over the issue peak."""
    b_ms, o_ms = n_bytes / PEAK_BYTES_S * 1e3, ops / issue_peak * 1e3
    return (o_ms, "operations") if o_ms >= b_ms else (b_ms, "bytes")


B_ENTRIES = ("fused_trace_launch", "traverse_mxu_launch", "traverse_pallas_launch")  # B1, B2, B3
K_ENTRIES = {"K1": "threefry_uniform_launch", "K2": "generate_stratified_launch", "K3": "generate_reference_launch",
             "K4": "bounce_step_launch", "K5": "hit_histogram_launch", "K6": "texel_bin_launch",
             "K7": "pack_sorted_launch", "K8": "shadow_sample_launch", "K9": "visibility_reduce_launch",
             "K10": "direct_grad_launch", "K11": "source_sample_launch", "K12": "transfer_rays_launch",
             "K13": "transfer_reduce_launch", "K14": "transfer_grad_launch"}
_LAUNCHES_AT_ZERO: dict = {}  # entry point -> its launch counter when `zero_launches` last set it to 0


def launched(entry: str) -> int:
    """Launches of the C entry point `entry` (the program's counter
    `launches.<entry>`) since `zero_launches` last set it to 0."""
    from uvtrace_torch.utils import timing

    return timing.counters()[f"launches.{entry}"] - _LAUNCHES_AT_ZERO.get(entry, 0)


def zero_launches(*entries: str):
    from uvtrace_torch.utils import timing

    counts = timing.counters()
    _LAUNCHES_AT_ZERO.update({e: counts[f"launches.{e}"] for e in entries})


def k_launches() -> dict:
    """Launches of the sampler kernels K1-K3, the launch layer's K4-K6, the
    direct estimator's K7-K10 and the interreflection term's K11-K14 since
    their counts were set to 0."""
    return {k: launched(e) for k, e in K_ENTRIES.items()}


def zero_k_launches():
    zero_launches(*K_ENTRIES.values())


K_PER_PATH: dict = {}  # path -> the launches of K1-K14 in its run (the kernels line)


def k_after(path: str, expected: dict) -> dict:
    """The launches of K1-K14 in the run of `path` just made (their counts
    set to 0 just before it); fails unless they equal `expected` (a kernel
    it leaves out: no launch). Kept for the kernels line."""
    got = k_launches()
    want = {k: expected.get(k, 0) for k in got}
    if got != want:
        fail(f"{path}: K1-K14 launches {got}, expected {want}")
    K_PER_PATH[path] = got
    return got


@contextlib.contextmanager
def plain_launch_ops():
    """launch_counts with the plain versions of K4, K5 and K6 in place of the
    kernels (the kernel-vs-plain launches of phases 8, 14 and 18)."""
    from uvtrace_torch.ops import accumulate, bounce, texel
    from uvtrace_torch.sim import launch

    saved = launch.bounce_step, accumulate.hit_histogram, texel.texel_bin
    launch.bounce_step, accumulate.hit_histogram, texel.texel_bin = (
        bounce.bounce_step_reference, accumulate.hit_histogram_reference, texel.texel_bin_reference)
    try:
        yield
    finally:
        launch.bounce_step, accumulate.hit_histogram, texel.texel_bin = saved


def bits_equal(label: str, k, p) -> float:
    """A kernel's outputs against its plain version's, bit for bit (floats
    by their bits); returns the max |difference| (0)."""
    import torch

    for a, b in zip(k, p):
        bits = (lambda x: x.view(torch.int32)) if a.is_floating_point() else (lambda x: x)  # noqa: E731
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(bits(a), bits(b)):
            bad = int((bits(a) != bits(b)).sum()) if a.shape == b.shape and a.dtype == b.dtype else "shape or type"
            fail(f"{label}: the kernel differs from its plain version ({bad} elements)")
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0 for a, b in zip(k, p))


def launch_ms(fn, reps: int = 50) -> float:
    """Device time (ms) of one call of fn, a sampler kernel's single launch:
    CUDA events around `reps` calls that the host enqueues while the card
    sleeps in a kernel of its own, so that the launches run back to back
    (events around calls made at the host's pace would time the wrapper's
    host work, which outlasts these kernels; the profiler lost some of
    their events). Every output is kept, so each launch writes fresh memory
    (a freed output's block would be reused with its lines still in the L2),
    from blocks an untimed round left in the allocator's cache. Fails if the
    card woke before the last call was enqueued."""
    import torch

    outs = [fn() for _ in range(reps)]  # the allocator keeps their blocks: no cudaMalloc while timed
    del outs
    outs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s at 2 GHz: time to enqueue the calls
    start.record()
    for _ in range(reps):
        outs.append(fn())
    queued_behind = not start.query()
    end.record()
    torch.cuda.synchronize()
    if not queued_behind:
        fail("launch_ms: the card finished its sleep before the launches were enqueued")
    return start.elapsed_time(end) / reps


def kernel_only_ms(fn, reps: int = 50, tries: int = 3, kernels: int = 1) -> float:
    """Device time (ms) of the kernels alone that each call of fn launches
    (`kernels` of them): torch.profiler's device time over `reps` calls
    divided by the kernel events it recorded, times `kernels`. The profiler
    may drop some of these short kernels, now and then all of them: a trace
    with none is taken again, up to `tries` traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total += float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
                count += e.count
        if count:
            return total / count * kernels / 1e3
        say(f"kernel_only_ms: the profiler recorded no kernel in {reps} calls; tracing again")
    fail(f"kernel_only_ms: the profiler recorded no kernel in {tries} traces")


def reference_pairs(n: int, lamp, seed: int, start: int) -> int:
    """The (x, z) candidates K3 draws for these photons: the reference
    sampler's rejection rounds replayed with the plain streams on the card."""
    import torch

    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops.generate import REJECTION_ROUNDS

    s = rng.photon_seeds(n, lamp, seed, start=start, device="cuda")
    s = rng.random_float(rng.random_float(s)[0])[0]  # rod height, dir.y
    live, pairs = torch.ones(n, dtype=torch.bool, device="cuda"), 0
    for _ in range(REJECTION_ROUNDS + 1):
        s, ux = rng.random_float(s)
        s, uz = rng.random_float(s)
        dx, dz = ux * 2 - 1, uz * 2 - 1
        pairs += int(live.sum())
        live &= dx * dx + dz * dz > 1.0
        if not bool(live.any()):
            break
    return pairs


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


def quiet(fn, *args, **kw):
    """(fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue().strip().splitlines()


def run_cli(argv) -> dict:
    """`python -m uvtrace_torch` in this process; the JSON line it prints."""
    from uvtrace_torch import cli

    rc, lines = quiet(cli.main, argv)
    if rc != 0:
        fail(f"uvtrace_torch {' '.join(argv[:2])} exited {rc}")
    return json.loads(lines[-1])


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


def device_profile(fn) -> dict:
    """{device event name: [ms, count]} of the kernels and memsets that one
    call of fn runs, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
            entry = by_name.setdefault(e.key, [0.0, 0])
            entry[0] += us / 1e3
            entry[1] += e.count
    return by_name


def device_ms_of(fn, with_launches: bool = False):
    """Device time (ms) of the kernels that one call of fn runs, from
    torch.profiler; with_launches: (ms, the device events it recorded)."""
    by_name = device_profile(fn)
    total, count = sum(v[0] for v in by_name.values()), sum(v[1] for v in by_name.values())
    return (total, count) if with_launches else total


def ops_over(limit: int):
    """A torch dispatch mode that counts, by name, the torch ops (forward
    and backward) that read or write a tensor of at least `limit` elements;
    views, which launch nothing, aside. A kernel of this repository is a
    ctypes call, never seen by the dispatcher."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and max((x.numel() for x in tree_leaves((args, kwargs, out))
                                         if isinstance(x, torch.Tensor)), default=0) >= limit:
                self.seen[str(func)] = self.seen.get(str(func), 0) + 1
            return out

    return Recorder()


def shadow_vs_plain(label: str, trav, orig, dirs, dist, reps: int):
    """One batch of the estimator's shadow rays (origins, unit directions
    and lengths, sorted and padded as B2 gets them) through B2 and through
    its plain version: t and slots equal but
    for ties (phase 3's rule), visibility bits equal but on at most 0.1% of
    rays, and no ray that the plain version finds occluded (t < dist (1 -
    eps) - eps) visible to the kernel: that would be a lost occluder.
    Returns (stats, kernel ms per 2^20 rays, plain ms per 2^20 rays, bound
    ms per 2^20 rays, bound_by, max |dt| on equal slots)."""
    import torch

    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch.ops import traverse_mxu as tm

    o, d, inverse = est.pack_shadow_rays(orig, dirs)
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
    thr = dist.reshape(-1) * (1.0 - 1e-3) - 1e-3
    vis_k, vis_p = kt[inverse] >= thr, pt[inverse] >= thr
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


def lange_route(mesh):
    """Config 4's route (CONFIGS.md section 4): (rod base y, rod length,
    power, the CLI's bounds, its start waypoints f32[12,2] clipped into
    them (uvtrace/cli.py:382-401), the durations f32[12])."""
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams

    route4 = load_route_xml(LANGE_ROUTE)
    p4 = route4.apply_to(SimParams())
    lo, hi = mesh.aabb
    bounds = ((float(lo[0]) + 0.1, float(lo[2]) + 0.1), (float(hi[0]) - 0.1, float(hi[2]) - 0.1))
    wp0 = np.clip(np.array([[w.x, w.y] for w in route4.waypoints], np.float32),
                  np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
    durs0 = np.array([w.duration for w in route4.waypoints], np.float32)
    return mesh.floor_height + p4.light_height, p4.light_length, p4.light_intensity, bounds, wp0, durs0


def config4_step(mesh, dscene, device):
    """One step of config 4's direct objective by hand (assets/
    lange_route.xml, the CLI's bounds and clipped start, key PRNGKey(0)):
    step(**route_dose kwargs) -> (loss, (d loss / d raw waypoints, d loss /
    d duration logits))."""
    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.ops import rng

    base_y, rod_len, power, bounds, wp0, durs0 = lange_route(mesh)
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
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.png import read_png
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays

    def zero_counters():
        torch.cuda.synchronize()
        zero_launches(*B_ENTRIES)
        zero_k_launches()

    def counters():
        return launched("traverse_mxu_launch"), launched("fused_trace_launch"), launched("traverse_pallas_launch")

    base_y, rod_len, power, bounds, wp0, durs0 = lange_route(mesh)
    n_wp = len(wp0)
    t0 = time.perf_counter()
    dscene = D.make_diff_scene(mesh, device="cuda")
    setup_s = time.perf_counter() - t0
    trav = dscene.trav_scene
    t_count = mesh.triangle_count
    rho4 = torch.full((t_count,), 0.25, device="cuda")
    out = {}

    # ---- 21. the diff layer's shadow rays, B2 vs plain ----------------------------------------
    # the bounce term's batches as K12 (bounce.transfer_rays) makes them: (origins, directions, lengths)
    recorded = []
    rays = bounce.transfer_rays

    def record(key, n_s, targets, sources):
        res = rays(key, n_s, targets, sources)
        recorded.append((sources[0].repeat_interleave(res[1].shape[0] // sources[0].shape[0], 0), *res[:2]))
        return res

    key0 = rng.fold_in(rng.PRNGKey(0), 0)
    xz0 = torch.tensor(wp0[0], device="cuda")
    # the direct estimator's rays (K8 draws them on the card; here its draws by hand)
    keys0 = rng.split(key0, 3)
    tri0 = (dscene.v0, dscene.e1, dscene.e2, dscene.normal)
    direct_batch = est.shadow_rays(est._rod_points(xz0, base_y, rod_len, rng.uniform(keys0[1], (4, 1), "cuda")),
                                   bounce.receivers_reference(keys0[0], 4, tri0)[0].view(4, -1, 3))
    bounce.transfer_rays = record
    try:
        with torch.no_grad():
            D.bounce_irradiance(dscene, xz0, base_y, rod_len, power, rho4, mesh.areas, rng.fold_in(key0, 1),
                                n_samples=4, n_sources=64, n_bounces=2)
    finally:
        bounce.transfer_rays = rays
    if len(recorded) != 1 + 4:
        fail(f"one waypoint's 2-bounce term made {len(recorded)} batches through K12, expected 5")
    lines21, t_err = [], 0.0
    for label, rays_, reps in (("direct", direct_batch, 5), ("source-to-source", recorded[0], 20),
                               ("receiver chunk", recorded[1], 3)):
        stats, ms, plain_ms, bound_ms, bound_by, max_dt = shadow_vs_plain(label, trav, *rays_, reps)
        t_err = max(t_err, max_dt)
        out[label] = (ms, plain_ms, bound_ms, bound_by)
        lines21.append(f"{label}: " + ", ".join(f"{k} {v}" for k, v in stats.items())
                       + f"; per 2^20 rays kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
                       f"({bound_by})")
    out["max_dt"] = t_err
    del direct_batch
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
    # each of the 7 evaluations runs K8, K7 and K9 a waypoint, each of the 6
    # steps' backward K10 a waypoint (the final dose runs under no_grad)
    k_after("config4_direct", {"K7": n_wp * 7, "K8": n_wp * 7, "K9": n_wp * 7, "K10": n_wp * 6})
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
    dev_ms, dev_launches = device_ms_of(lambda: step(n_samples=4), with_launches=True)
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
    out["direct_step_launches"] = dev_launches
    say(f"config 4, direct objective: testroomopt, assets/lange_route.xml ({n_wp} waypoints), n_samples 4, lr 0.05, "
        f"CLI bounds: scene set-up {setup_s:.2f} s; 1 warm-up + 5 timed steps {step_s:.4f} s/step; B2 launches "
        f"{launches22[0]} (6 steps + the final dose, {n_wp} each), no B1/B3; K7-K10 "
        f"{', '.join(str(K_PER_PATH['config4_direct'][k]) for k in ('K7', 'K8', 'K9', 'K10'))}; device time of one "
        f"step {dev_ms:.2f} ms in {dev_launches} device launches (profiler), idle share {idle:.3f} of the unprofiled "
        f"step; loss {res.history[0]:.5g} -> "
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
        evals = steps + 1  # the steps' evaluations and the final dose's (under no_grad)
        # the plan traces a waypoint's source-to-source rays and 4 receiver chunks once; an evaluation
        # traces the direct rays and the sources' direct rays
        expected = n_wp * 5 + n_wp * 2 * evals
        if launches23 != (expected, 0, 0):
            fail(f"config 4, {n_bounces} bounces: B2, B1, B3 launched {launches23} times, expected ({expected}, 0, 0)")
        # the plan, a waypoint: K11, K7 for the 5 transfer batches, K12 and K13 for the matrix and the 4 chunks;
        # an evaluation, a waypoint: K8, K7 and K9 for the direct rays and the sources' direct rays, K12 and
        # K13 (kept visibility) a chunk; backward K10 twice, K14 a chunk
        k_after(f"config4_bounce{n_bounces}", {
            "K7": n_wp * 5 + n_wp * 2 * evals, "K8": n_wp * 2 * evals, "K9": n_wp * 2 * evals,
            "K10": n_wp * 2 * steps, "K11": n_wp, "K12": n_wp * 5 + n_wp * 4 * evals,
            "K13": n_wp * 5 + n_wp * 4 * evals, "K14": n_wp * 4 * steps})
        if not (np.isfinite(res.history).all() and np.isfinite(res.waypoints_xz).all()
                and np.isfinite(res.durations).all()):
            fail(f"config 4, {n_bounces} bounces: loss {res.history}, waypoints or durations not finite")
        # one step by hand, without and with the route's plan: its peak memory, then its device time, B2's share
        # and its device launches; both give the same loss and gradients bit for bit
        kw = dict(n_samples=4, reflectance=rho4, areas=mesh.areas, n_sources=64, n_bounces=n_bounces)
        plan = D.plan_route_transfer(dscene, rng.PRNGKey(0), n_wp, mesh.areas, n_samples=4, n_sources=64,
                                     n_bounces=n_bounces)
        plan_bytes = sum(v.nbytes for p_w in plan.waypoints for v in (p_w.src, p_w.x_m, p_w.n_m, p_w.f_ss, *p_w.vis))
        by_hand, results = {}, {}
        for label, more in (("unplanned", {}), ("planned", dict(transfer=plan))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            loss, grads = step(**kw, **more)
            torch.cuda.synchronize()
            step_peak = torch.cuda.max_memory_allocated() - base_mem
            results[label] = [loss.detach(), *grads]
            prof23 = device_profile(lambda: step(**kw, **more))
            dev_ms = sum(v[0] for v in prof23.values())
            b2_ms = sum(v[0] for k, v in prof23.items() if "traverse_mxu_kernel" in k)
            by_hand[label] = dict(device_ms=dev_ms, b2_ms=b2_ms, launches=sum(v[1] for v in prof23.values()),
                                  peak_bytes=step_peak)
        if not all(torch.equal(a, b) for a, b in zip(results["unplanned"], results["planned"])):
            fail(f"config 4, {n_bounces} bounces: the planned step's loss and gradients differ from the unplanned")
        out[f"bounce{n_bounces}_step_s"] = s_step
        out[f"bounce{n_bounces}_step"] = dict(by_hand["unplanned"], run_peak_bytes=peak)
        out[f"bounce{n_bounces}_planned_step"] = dict(by_hand["planned"], plan_bytes=plan_bytes)
        k_run = K_PER_PATH[f"config4_bounce{n_bounces}"]
        hand = "; ".join(f"{label}: peak {h['peak_bytes'] / 2**30:.3f} GiB above its inputs, device time "
                         f"{h['device_ms']:.2f} ms (B2 {h['b2_ms']:.2f}, the rest {h['device_ms'] - h['b2_ms']:.2f}) "
                         f"in {h['launches']} device launches (profiler)" for label, h in by_hand.items())
        lines23.append(f"{n_bounces} bounces: {'1 warm-up + 2 timed steps' if steps > 1 else '1 timed step'} "
                       f"{s_step:.3f} s/step, {launches23[0]} B2 launches, K11-K14 "
                       f"{', '.join(str(k_run[k]) for k in ('K11', 'K12', 'K13', 'K14'))}, peak device memory "
                       f"{peak / 2**30:.2f} GiB in the run; one step by hand, {hand}; the plan "
                       f"{plan_bytes / 2**20:.1f} MiB, the same loss and gradients bit for bit; loss "
                       f"{res.history[0]:.5g}")
    # the receiver pass of waypoint 0 (4 chunks of 16 x 179,464 rays, forward and backward) runs no torch op
    # over a chunk's rays but the stable sort (and the allocations and views of the kernels' outputs):
    # every other op the dispatcher sees during the pass is over the receivers or the sources
    keys_b, tri = rng.split(rng.fold_in(key0, 1), 4), tri0
    with torch.no_grad():
        x_m, n_m, strength, _ = est._source_field(dscene, xz0, base_y, rod_len, power, rho4, mesh.areas, keys_b,
                                                  n_samples=4, n_sources=64, n_bounces=2)
    s_req = strength.detach().requires_grad_(True)

    def receiver_pass():
        acc = bounce.receiver_transfer(dscene, s_req, (x_m, n_m), keys_b[3], 4, tri, 16)
        torch.autograd.grad(acc.sum(), s_req)

    receiver_pass()
    with ops_over(16 * 4 * t_count) as big:
        receiver_pass()
    torch.cuda.synchronize()
    eager = {k: v for k, v in big.seen.items() if k not in ("aten.sort.stable", "aten.empty.memory_format")}
    if eager or big.seen.get("aten.sort.stable") != 4:
        fail(f"the receiver pass ran torch ops over a chunk's {16 * 4 * t_count} rays besides the 4 stable sorts: "
             f"{big.seen}")
    pass_launches = device_ms_of(receiver_pass, with_launches=True)[1]
    out["receiver_pass"] = dict(launches=pass_launches, ops_over_rays=big.seen)
    say(f"config 4 with interreflection (rho 0.25, 64 sources): {' | '.join(lines23)} | the receiver pass of "
        f"waypoint 0, forward and backward: {pass_launches} device launches (profiler); torch ops over a chunk's "
        f"rays {big.seen} (views aside) [{card}]")

    # ---- 24. dose image ----------------------------------------------------------------------
    wp_t = torch.tensor(wp0, device="cuda", requires_grad=True)
    durs_t = torch.tensor(durs0, device="cuda", requires_grad=True)
    zero_counters()
    zero_k_launches()
    t0 = time.perf_counter()
    plan = D.plan_dose_image(dscene, res=128)
    img = D.dose_image(dscene, plan, wp_t, durs_t, base_y, rod_len, power, rng.PRNGKey(0), n_samples=8)
    flat = img.reshape(-1)
    lit = plan.mask & (flat > 0)
    g_wp, g_durs = torch.autograd.grad(softmin(torch.where(lit, flat, 1e9), 5.0), (wp_t, durs_t))
    img_np = img.detach().cpu().numpy()
    image_s = time.perf_counter() - t0
    launches24 = counters()
    # the plan's probes pack through K7 (2 traces); a waypoint runs K8, K7, K9 and K10
    k_after("dose_image", {"K7": n_wp + 2, "K8": n_wp, "K9": n_wp, "K10": n_wp})
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



def direct_kernel_phases(mesh, card: str, issue_peak: float) -> dict:
    """Phases 47-50: the direct estimator's kernels K8, K7, K9 and K10
    (csrc/diff_ops.cu) against their plain versions at full width, the
    Function's step repeated, and the 100-step direct optimize_route.
    Returns the kernels' numbers for the kernels line."""
    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import direct as dr
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm

    base_y, rod_len, power, bounds, wp0, durs0 = lange_route(mesh)
    dscene = D.make_diff_scene(mesh, device="cuda")
    plan = D.plan_dose_image(dscene, res=128)
    tri_targets = (dscene.v0, dscene.e1, dscene.e2, dscene.normal)
    cases = [(f"testroomopt, lange_route waypoint {w}, n_samples 4", tri_targets, 4, w, rng.fold_in(rng.PRNGKey(0), w))
             for w in (0, 6)]
    cases.append(("the 128^2 dose-image plan's points, n_rod 8", (plan.points, plan.normals), 8, 0,
                  rng.fold_in(rng.PRNGKey(0), 0)))
    err = {"K7": 0.0, "K8": 0.0, "K9": 0.0, "K10": 0.0}
    lines, timed = [], {}
    for label, targets, n_s, w, key in cases:
        xz = torch.tensor(wp0[w], device="cuda")
        m = targets[0].shape[0]
        r = n_s * m
        # ---- 47. K8 shadow_sample and K7 pack_sorted, bit for bit
        k8 = dr.shadow_sample(key, n_s, targets, xz, base_y, rod_len)
        err["K8"] = max(err["K8"], bits_equal(f"K8 {label}", k8,
                                              dr.shadow_sample_reference(key, n_s, targets, xz, base_y, rod_len)))
        rod, dirs, dist, g, sort_key = k8
        perm = torch.sort(sort_key, stable=True).indices
        k7 = dr.pack_sorted(perm, rod, dirs)
        err["K7"] = max(err["K7"], bits_equal(f"K7 {label}", k7, dr.pack_sorted_reference(perm, rod, dirs)))
        o, d, inverse = k7
        t = tm.traverse_mxu_slots(dscene.trav_scene, o, d, packet=dr.SHADOW_PACKET)[0]
        # ---- 48. K9 visibility_reduce: visibility bit-equal, E within rtol 1e-6
        e, vis = dr.visibility_reduce(t, inverse, dist, g, n_s, power)
        e_p, vis_p = dr.visibility_reduce_reference(t, inverse, dist, g, n_s, power)
        bits_equal(f"K9 visibility {label}", [vis], [vis_p])
        e_rel = float(((e - e_p).abs() / e_p.abs().clamp_min(1e-30)).max())
        if e_rel > 1e-6:
            fail(f"K9 {label}: E differs from the plain version's by rtol {e_rel:.3g} (> 1e-6)")
        err["K9"] = max(err["K9"], float((e - e_p).abs().max()))
        # ---- 49. K10 direct_grad within 1e-5 of the terms' absolute sum, on a config-4 dL/dE
        e_req = e.detach().requires_grad_(True)
        (w_e,) = torch.autograd.grad(-softmin(0.1 * float(durs0[w]) * e_req, 5.0), e_req)
        gargs = (w_e.contiguous(), vis, key, n_s, targets, xz, base_y, rod_len, power)
        k10 = dr.direct_grad(*gargs)
        p10 = dr.direct_grad_reference(*gargs)
        scale = dr.direct_grad_terms(*gargs).abs().sum((1, 2))
        k10_rel = float(((k10 - p10).abs() / scale).max())
        if k10_rel > 1e-5 or not torch.equal(k10, dr.direct_grad(*gargs)):
            fail(f"K10 {label}: {k10.tolist()} vs plain {p10.tolist()}, |diff| / sum|terms| {k10_rel:.3g} (> 1e-5), "
                 f"or not the same on a repeat")
        err["K10"] = max(err["K10"], float((k10 - p10).abs().max()))
        # the Function's step twice: E and the gradients bit for bit
        steps = []
        for _ in range(2):
            xz_t = xz.clone().requires_grad_(True)
            pw_t = torch.tensor(power, device="cuda", requires_grad=True)
            if len(targets) == 4:
                e_f = D.irradiance(dscene, xz_t, base_y, rod_len, pw_t, key, n_samples=n_s)
            else:
                e_f = D.estimator._points_direct(dscene, targets[0], targets[1], xz_t, base_y, rod_len, pw_t, key,
                                                 n_rod=n_s)
            steps.append([e_f.detach(), *torch.autograd.grad(-softmin(e_f, 5.0), (xz_t, pw_t))])
        bits_equal(f"the Function's step twice, {label}", steps[0], steps[1])
        if not torch.equal(steps[0][0], e):
            fail(f"the Function's E differs from K8, K7, B2 and K9 in turn ({label})")
        n_vis = int(vis.sum())
        lines.append(f"{label}: {r} rays ({o.shape[0]} packed), {n_vis / r:.4f} visible; K8, K7 and the visibility "
                     f"bit-equal, E rel err {e_rel:.3g}, K10 |diff| / sum|terms| {k10_rel:.3g} (grads "
                     f"{', '.join(f'{v:.5g}' for v in k10.tolist())}); the step twice bit-equal")
        tb = 48 if len(targets) == 4 else 24  # a target's f32[3] rows
        draw = K8_TRI_OPS if len(targets) == 4 else (0, 0)
        bounds_ = {
            "K8": sampler_roofline(tb * m + K8_RAY_BYTES * r + K8_SAMPLE_BYTES * n_s,
                                   r * (sum(K8_RAY_OPS) + sum(draw)) + n_s * sum(K8_SAMPLE_OPS), issue_peak),
            "K7": roofline(K7_RAY_BYTES * r + K7_SAMPLE_BYTES * n_s + K7_PAD_BYTES * (o.shape[0] - r), 0.0),
            "K9": roofline(K9_RAY_BYTES * r + K9_TARGET_BYTES * m, 0.0),
            "K10": sampler_roofline(K10_RAY_BYTES * r + (K10_TARGET_BYTES + tb) * m,
                                    n_vis * (sum(K10_RAY_OPS) + sum(K8_RAY_OPS) + sum(draw))
                                    + m * sum(K10_TARGET_OPS), issue_peak),
        }
        if w == 0 and len(targets) == 4 or len(targets) == 2:
            # ---- 50 (timed). back to back, alone, a call, plain: at the main path's shapes
            which = "triangles" if len(targets) == 4 else "points"
            fns = {
                "K8": (lambda: dr.shadow_sample(key, n_s, targets, xz, base_y, rod_len),
                       lambda: dr.shadow_sample_reference(key, n_s, targets, xz, base_y, rod_len), 1),
                "K7": (lambda: dr.pack_sorted(perm, rod, dirs), lambda: dr.pack_sorted_reference(perm, rod, dirs), 1),
                "K9": (lambda: dr.visibility_reduce(t, inverse, dist, g, n_s, power),
                       lambda: dr.visibility_reduce_reference(t, inverse, dist, g, n_s, power), 1),
                "K10": (lambda: dr.direct_grad(*gargs), lambda: dr.direct_grad_reference(*gargs), 2),
            }
            for name, (kfn, pfn, kernels) in fns.items():
                timed[(name, which)] = dict(
                    ms=launch_ms(kfn), kernel_only_ms=kernel_only_ms(kfn, kernels=kernels), call_ms=cuda_ms(kfn, 50),
                    plain_ms=cuda_ms(pfn, 3), bound_ms=bounds_[name][0], bound_by=bounds_[name][1])
    say("direct estimator kernels vs plain (phases 47-49): " + " | ".join(lines) + f" [{card}]")
    for which, shape in (("triangles", "waypoint 0, 4 x 44,866 rays"), ("points", "the 128^2 plan, 8 x 16,384 rays")):
        say(f"direct estimator kernels timed ({shape}): "
            + "; ".join(f"{n} {v['ms']:.4f} ms a launch back to back (alone {v['kernel_only_ms']:.4f}, a call "
                        f"{v['call_ms']:.4f}), plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms by "
                        f"{v['bound_by']}" for (n, wh), v in timed.items() if wh == which) + f" [{card}]")

    # ---- waypoint 6: autograd against central FD, and the visibility flips between x - eps and x + eps
    key6, xz6 = rng.fold_in(rng.PRNGKey(0), 6), torch.tensor(wp0[6], device="cuda")
    xt = xz6.clone().requires_grad_(True)
    g6 = torch.autograd.grad(D.irradiance(dscene, xt, base_y, rod_len, power, key6, n_samples=4).mean(), xt)[0]
    fd6 = []
    for i in range(2):
        ev = torch.zeros(2, device="cuda")
        ev[i] = 1e-3
        with torch.no_grad():
            side = []
            for sgn in (1.0, -1.0):
                rod, dirs, dist, g, sort_key = dr.shadow_sample(key6, 4, tri_targets, xz6 + sgn * ev, base_y, rod_len)
                t, inverse = dscene.trace_fn(dscene.trav_scene, rod, dirs, sort_key)
                side.append(dr.visibility_reduce(t, inverse, dist, g, 4, power))
        fd = float(side[0][0].mean() - side[1][0].mean()) / 2e-3
        fd6.append(f"{'xz'[i]} autograd {g6[i].item():.5g}, FD {fd:.5g} ({abs(g6[i].item() - fd) / abs(fd):.3f} "
                   f"apart), {int((side[0][1] != side[1][1]).sum())} of {side[0][1].numel()} rays flip visibility")
    say(f"waypoint 6 (testroomopt, n_samples 4): {'; '.join(fd6)} [{card}]")

    # ---- 50. 100 steps of the direct optimize_route (CONFIGS.md section 4)
    stamps = []

    def tick(i, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    zero_launches("traverse_mxu_launch")
    zero_k_launches()
    t0 = time.perf_counter()
    res = D.optimize_route(dscene, wp0, durs0, base_y, rod_len, power, steps=100, learning_rate=0.05, n_samples=4,
                           bounds=bounds, progress=tick)
    total_s = time.perf_counter() - t0
    n_wp = wp0.shape[0]
    # 101 evaluations (100 steps and the final dose), 100 backwards
    got = k_after("config4_direct_100", {"K7": n_wp * 101, "K8": n_wp * 101, "K9": n_wp * 101, "K10": n_wp * 100})
    if launched("traverse_mxu_launch") != n_wp * 101:
        fail(f"100-step optimize_route: {launched('traverse_mxu_launch')} B2 launches, expected {n_wp * 101}")
    if not (np.isfinite(res.history).all() and np.isfinite(res.waypoints_xz).all()
            and np.isfinite(res.final_dose_masked).all()):
        fail(f"100-step optimize_route: loss {res.history[0]} -> {res.history[-1]}, waypoints finite "
             f"{np.isfinite(res.waypoints_xz).all()}")
    step_ms = np.diff(np.array(stamps)) * 1e3
    q1, med, q3 = np.percentile(step_ms, [25, 50, 75])
    say(f"config 4, 100 direct optimize_route steps (CONFIGS.md section 4: lr 0.05, n_samples 4, the CLI's bounds): "
        f"{total_s:.2f} s in all, {(stamps[-1] - stamps[0]) / 99:.4f} s/step after the first (median "
        f"{med:.2f} ms, quartiles {q1:.2f}-{q3:.2f} ms); launches a step: B2 {n_wp}, K7-K10 "
        f"{got['K7'] / 101:.0f}, {got['K8'] / 101:.0f}, {got['K9'] / 101:.0f}, {got['K10'] / 100:.0f}; loss "
        f"{res.history[0]:.5g} -> {res.history[-1]:.5g} (lowest {min(res.history):.5g}), final min dose "
        f"{res.final_min_dose:.4g} mJ/cm^2 [{card}]")
    return dict(err=err, timed=timed, steps100_s=(stamps[-1] - stamps[0]) / 99, steps100_total_s=total_s)


def bounce_kernel_phases(mesh, card: str, issue_peak: float) -> dict:
    """Phases 51-54: the interreflection term's kernels K11-K14
    (csrc/bounce_ops.cu) against their plain versions at full width, config
    4's waypoint 0 (assets/lange_route.xml, rho 0.25, 64 sources, 2 bounces:
    the 64 x 64 source-to-source rays and 4 chunks of 16 x 179,464 receiver
    rays), the term's step repeated, each kernel timed. Returns the kernels'
    numbers for the kernels line."""
    import torch

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import bounce as vb
    from uvtrace_torch.diff import direct as dr
    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm

    base_y, rod_len, power, _, wp0, durs0 = lange_route(mesh)
    dscene = D.make_diff_scene(mesh, device="cuda")
    t_count = mesh.triangle_count
    rho = torch.full((t_count,), 0.25, device="cuda")
    tri = (dscene.v0, dscene.e1, dscene.e2, dscene.normal)
    key_b = rng.fold_in(rng.fold_in(rng.PRNGKey(0), 0), 1)  # route_dose's bounce key at waypoint 0
    keys = rng.split(key_b, 4)
    xz = torch.tensor(wp0[0], device="cuda")
    cdf = est._source_cdf(dscene, mesh.areas)[0]
    err = dict.fromkeys(("K11", "K12", "K13", "K14"), 0.0)

    def traced(src_rows, rays):
        o, d, inverse = dr.pack_sorted(torch.sort(rays[3], stable=True).indices, src_rows, rays[0])
        return tm.traverse_mxu_slots(dscene.trav_scene, o, d, packet=dr.SHADOW_PACKET)[0], inverse, o.shape[0]

    # ---- 51. K11 source_sample, bit for bit
    _, x_m, n_m = k11 = vb.source_sample((keys[0], keys[1]), 64, cdf, tri)
    err["K11"] = bits_equal("K11 source_sample", k11, vb.source_sample_reference((keys[0], keys[1]), 64, cdf, tri))
    with torch.no_grad():
        _, _, strength, w = est._source_field(dscene, xz, base_y, rod_len, power, rho, mesh.areas, keys, n_samples=4,
                                              n_sources=64, n_bounces=2)
    # ---- 52-53. K12 and K13 in matrix mode on the source-to-source rays, bit for bit
    sources = (x_m, n_m)
    km = vb.transfer_rays(None, 1, sources, sources)
    err["K12"] = bits_equal("K12 source-to-source", km, vb.transfer_rays_reference(None, 1, sources, sources))
    t_m, inv_m, _ = traced(x_m, km)
    f_ss = vb.transfer_reduce(t_m, inv_m, km[1], km[2], 64)
    err["K13"] = bits_equal("K13 matrix mode", [f_ss], [vb.transfer_reduce_reference(t_m, inv_m, km[1], km[2], 64)])
    # ---- 52-53. K12 and K13 in reduce mode on the 4 receiver chunks, chunk after chunk, bit for bit; K13's
    # kept-visibility mode on each chunk's bytes the traced reduce's sums and its plain version's, bit for bit
    acc_k = acc_p = None
    chunks = []
    for c in range(4):
        src_c = (x_m[16 * c:16 * c + 16].contiguous(), n_m[16 * c:16 * c + 16].contiguous())
        kr = vb.transfer_rays(keys[3], 4, tri, src_c)
        err["K12"] = max(err["K12"], bits_equal(f"K12 receiver chunk {c}", kr,
                                                vb.transfer_rays_reference(keys[3], 4, tri, src_c)))
        t, inverse, n_packed = traced(src_c[0], kr)
        s_c = strength[16 * c:16 * c + 16].contiguous()
        before = acc_k
        acc_k, vis = vb.transfer_reduce(t, inverse, kr[1], kr[2], 16, s_c, None if before is None else before.clone())
        acc_p, vis_p = vb.transfer_reduce_reference(t, inverse, kr[1], kr[2], 16, s_c, acc_p)
        err["K13"] = max(err["K13"], bits_equal(f"K13 reduce mode, chunk {c}", [acc_k, vis], [acc_p, vis_p]))
        kept, kept_vis = vb.transfer_reduce(None, None, None, kr[2], 16, s_c,
                                            None if before is None else before.clone(), vis)
        if kept_vis is not vis:
            fail(f"K13 kept-visibility mode, chunk {c}: the kept bytes are not returned as they are")
        err["K13"] = max(err["K13"], bits_equal(
            f"K13 kept-visibility mode, chunk {c}", [kept, kept],
            [vb.transfer_reduce_reference(None, None, None, kr[2], 16, s_c, before, vis)[0], acc_k]))
        chunks.append((src_c, kr, t, inverse, s_c, vis, n_packed))
    # ---- 54. K14 transfer_grad on a config-4 dL/dout (a softmin's weights), within 1e-5 of its terms
    a_req = acc_k.detach().requires_grad_(True)
    (g_out,) = torch.autograd.grad(-softmin(0.1 * float(durs0[0]) * w * a_req.view(4, -1).mean(0), 5.0), a_req)
    g_out = g_out.contiguous()
    k14_rel = 0.0
    for c, (src_c, _, _, _, _, vis, _) in enumerate(chunks):
        gargs = (g_out, vis, keys[3], 4, tri, src_c)
        k14, p14 = vb.transfer_grad(*gargs), vb.transfer_grad_reference(*gargs)
        scale = vb.transfer_grad_terms(*gargs).abs().sum(1)
        if not (bool(((k14 - p14).abs() <= 1e-5 * scale).all()) and torch.equal(k14, vb.transfer_grad(*gargs))):
            fail(f"K14 chunk {c}: {k14.tolist()} vs plain {p14.tolist()} (terms' absolute sums {scale.tolist()}), "
                 f"or not the same on a repeat")
        live = scale > 0
        k14_rel = max(k14_rel, float(((k14 - p14).abs()[live] / scale[live]).max()) if bool(live.any()) else 0.0)
        err["K14"] = max(err["K14"], float((k14 - p14).abs().max()))
    # the term's step twice, bit for bit, its value w mean_s of K13's sums
    steps = []
    for _ in range(2):
        xz_t, r_t = xz.clone().requires_grad_(True), rho.clone().requires_grad_(True)
        pw_t = torch.tensor(power, device="cuda", requires_grad=True)
        e = D.bounce_irradiance(dscene, xz_t, base_y, rod_len, pw_t, r_t, mesh.areas, key_b, n_samples=4,
                                n_sources=64, n_bounces=2)
        steps.append([e.detach(), *torch.autograd.grad(-softmin(e, 5.0), (xz_t, pw_t, r_t))])
    bits_equal("the 2-bounce term's step twice", steps[0], steps[1])
    if not torch.equal(steps[0][0], w * torch.mean(acc_k.view(4, -1), dim=0)):
        fail("the 2-bounce term differs from K11, K12, the trace and K13 in turn")
    n_vis = [int(ch[5].sum()) for ch in chunks]
    r = 16 * 4 * t_count
    say(f"interreflection kernels vs plain (phases 51-54; testroomopt, lange_route waypoint 0, rho 0.25, 64 sources, "
        f"4 chunks of 16 x {4 * t_count} rays): K11's sources, K12's rays and K13's matrix, sums and visibility "
        f"bytes bit-equal, K13's kept-visibility sums bit-equal to its plain version's and to the traced sums, {sum(n_vis) / (4 * r):.4f} of the receiver rays visible, "
        f"{float((f_ss > 0).float().mean()):.4f} of the matrix lit; K14 |diff| / sum|terms| {k14_rel:.3g}; the "
        f"term's step (value, lamp, power and reflectance gradients) twice bit-equal [{card}]")

    # ---- timed: back to back, alone, a call, plain, beside the bounds
    src0, kr0, t0_, inv0, s0, vis0, n_packed0 = chunks[0]
    n_steps = int(np.ceil(np.log2(t_count + 1)))
    bounds_ = {
        "K11": sampler_roofline(64 * (K11_SOURCE_BYTES + K11_STEP_BYTES * n_steps),
                                64 * (sum(K11_SOURCE_OPS) + n_steps * sum(K11_SEARCH_OPS)), issue_peak),
        "K12": sampler_roofline(K12_RAY_BYTES * r + K12_SOURCE_BYTES * 16 + 48 * t_count,
                                r * sum(K12_RAY_OPS) + 4 * t_count * sum(K12_DRAW_OPS), issue_peak),
        "K13": sampler_roofline((K13_RAY_BYTES + K13_VIS_BYTES) * r + K13_RECEIVER_BYTES * 4 * t_count
                                + K13_SOURCE_BYTES * 16, r * sum(K13_RAY_OPS), issue_peak),
        "K14": sampler_roofline(K14_RAY_BYTES * r + (K14_RECEIVER_BYTES * 4 + 48) * t_count + K14_SOURCE_BYTES * 16,
                                n_vis[0] * sum(K14_RAY_OPS) + r * sum(K14_TERM_OPS)
                                + 4 * t_count * sum(K12_DRAW_OPS), issue_peak),
        "K12 matrix": sampler_roofline(K12_RAY_BYTES * 4096 + K12_SOURCE_BYTES * 64 * 2, 4096 * sum(K12_RAY_OPS),
                                       issue_peak),
        "K13 matrix": sampler_roofline(20 * 4096, 4096 * sum(K13_RAY_OPS), issue_peak),
        "K13 kept": sampler_roofline(K13_KEPT_RAY_BYTES * r + K13_RECEIVER_BYTES * 4 * t_count + K13_SOURCE_BYTES * 16,
                                     r * sum(K13_KEPT_RAY_OPS), issue_peak),
    }
    fns = {
        "K11": (lambda: vb.source_sample((keys[0], keys[1]), 64, cdf, tri),
                lambda: vb.source_sample_reference((keys[0], keys[1]), 64, cdf, tri), 1),
        "K12": (lambda: vb.transfer_rays(keys[3], 4, tri, src0),
                lambda: vb.transfer_rays_reference(keys[3], 4, tri, src0), 1),
        "K13": (lambda: vb.transfer_reduce(t0_, inv0, kr0[1], kr0[2], 16, s0),
                lambda: vb.transfer_reduce_reference(t0_, inv0, kr0[1], kr0[2], 16, s0), 1),
        "K14": (lambda: vb.transfer_grad(g_out, vis0, keys[3], 4, tri, src0),
                lambda: vb.transfer_grad_reference(g_out, vis0, keys[3], 4, tri, src0), 2),
        "K12 matrix": (lambda: vb.transfer_rays(None, 1, sources, sources),
                       lambda: vb.transfer_rays_reference(None, 1, sources, sources), 1),
        "K13 matrix": (lambda: vb.transfer_reduce(t_m, inv_m, km[1], km[2], 64),
                       lambda: vb.transfer_reduce_reference(t_m, inv_m, km[1], km[2], 64), 1),
        "K13 kept": (lambda: vb.transfer_reduce(None, None, None, kr0[2], 16, s0, None, vis0),
                     lambda: vb.transfer_reduce_reference(None, None, None, kr0[2], 16, s0, None, vis0), 1),
    }
    timed = {}
    for name, (kfn, pfn, kernels) in fns.items():
        timed[name] = dict(ms=launch_ms(kfn), kernel_only_ms=kernel_only_ms(kfn, kernels=kernels),
                           call_ms=cuda_ms(kfn, 50), plain_ms=cuda_ms(pfn, 3), bound_ms=bounds_[name][0],
                           bound_by=bounds_[name][1])
    say("interreflection kernels timed (K11: 64 sources; K12-K14 and K13 kept: receiver chunk 0, 16 x 179,464 rays; "
        "matrix: 64 x 64): " + "; ".join(f"{n} {v['ms']:.4f} ms a launch back to back (alone {v['kernel_only_ms']:.4f}, a call "
                            f"{v['call_ms']:.4f}), plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f} ms by "
                            f"{v['bound_by']}" for n, v in timed.items()) + f" [{card}]")
    return dict(err=err, timed=timed, k14_rel=k14_rel)


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
        zero_launches(*B_ENTRIES)

    def counters():
        return launched("traverse_mxu_launch"), launched("fused_trace_launch"), launched("traverse_pallas_launch")

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
            account = pinned(f"clustered pinned total at {i + 1} x 2^20 rays", total, False, i + 1)
            lines.append(f"{i + 1} x 2^20: {account}, overflow {overflow}, {time.perf_counter() - t0:.2f} s")
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


@contextlib.contextmanager
def bench_env(**env):
    """os.environ with the UVTRACE_BENCH_* variables set as given (and no
    others of them), restored after."""
    keys = ("UVTRACE_BENCH_BACKEND", "UVTRACE_BENCH_RAYS", "UVTRACE_BENCH_ITERS", "UVTRACE_BENCH_PRECISION")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update({f"UVTRACE_BENCH_{k.upper()}": str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def bench_phases(mesh, card: str) -> dict:
    """Phases 36-40: the port's bench and entry points on the card (the
    headline on all four backends with the 5- and 20-iteration pins, the
    --bounce rows, --scaling on one NCCL rank, entry() against B2's plain
    version, the dry runs, the bench through the CLI). Returns the headline
    rows and the launches of the headline runs by kernel."""
    import torch

    from uvtrace_torch import bench
    from uvtrace_torch.entry import dryrun_multichip, entry
    from uvtrace_torch.geometry.procedural import make_box_room
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.generate import generate_stratified
    from uvtrace_torch.sim import SimParams, Simulator

    def zero_counters():
        torch.cuda.synchronize()
        zero_launches(*B_ENTRIES)
        zero_k_launches()

    def counters():
        return {"B1": launched("fused_trace_launch"), "B2": launched("traverse_mxu_launch"),
                "B3": launched("traverse_pallas_launch")}

    # ---- 36. the headline on all four backends, at 5 and 20 iterations -----------------------
    kernel_of = {"mxu-fused": "B1", "mxu": "B2", "pallas": "B3", "clustered": None}
    rows, launches = {}, {"B1": 0, "B2": 0, "B3": 0}
    for backend, iters in (("mxu-fused", 5), ("mxu-fused", 20), ("mxu", 5), ("mxu", 20), ("pallas", 5),
                           ("pallas", 20), ("clustered", 5)):
        zero_counters()
        t0 = time.perf_counter()
        with bench_env(backend=backend, iters=iters):
            try:
                row, printed = quiet(bench.main, device="cuda")
            except RuntimeError as e:  # the pin gate
                fail(f"bench headline, backend {backend}, {iters} iterations: {e}")
        wall = time.perf_counter() - t0
        got = counters()
        want = {k: (4 * iters if k == kernel_of[backend] else 0) for k in got}  # warm-up + 3 timed runs
        if got != want:
            fail(f"bench headline, backend {backend}, {iters} iterations: launches {got}, expected {want}")
        # the split backends draw their rays with K2, B1 draws its own; the
        # backends without an in-kernel histogram count hits with K5
        k_after(f"bench_{backend}_{iters}", {"K2": 0 if backend == "mxu-fused" else 4 * iters,
                                             "K5": 4 * iters if backend in ("pallas", "clustered") else 0})
        if len(printed) != 1 or json.loads(printed[0]) != row or not row["value"] > 0:
            fail(f"bench headline, backend {backend}: printed {printed!r}")
        for k, v in got.items():
            launches[k] += v
        rows[(backend, iters)] = row
        account = bench.check_pinned_total(row["hit_total"], backend == "mxu-fused", iters)
        busy = ""
        if iters == 20 and kernel_of[backend]:
            # device time of one more 20-iteration run, by torch.profiler: the
            # device's idle share against the headline's best run
            run = bench.headline_pipeline(mesh, backend, 1 << 20, "cuda")
            run(20)
            dev_ms = device_ms_of(lambda: run(20)) / 20
            wall_ms = 1e3 * (1 << 20) / row["value"]
            rows[(backend, iters)] = dict(row, device_ms=dev_ms)
            busy = (f", device {dev_ms:.3f} ms of the best run's {wall_ms:.3f} ms an iteration (idle "
                    f"{100 * (1 - dev_ms / wall_ms):.1f}%)")
        say(f"bench headline ({backend}, {iters} x 2^20 rays, best of 3 runs after one untimed): {printed[0]} | "
            f"pin {account[0]} (diff {row['hit_total'] - account[0]}, tolerance {account[1]}), launches {got}, "
            f"{wall:.1f} s with the warm-up and the scene build{busy} [{card}]")

    # ---- 37. bench --bounce: the testroom row, and config 2 on the 443k room -------------------
    room443 = make_box_room(subdivisions=192, clutter=96)
    for label, kw in (("testroomopt, rho 0.5", dict()),
                      (f"443k box room ({room443.triangle_count} tris), rho 0.25",
                       dict(scene_mesh=room443, reflectance=0.25))):
        zero_counters()
        t0 = time.perf_counter()
        row = bench.bounce_row(device="cuda", **kw)
        wall = time.perf_counter() - t0
        got = counters()
        if got != {"B1": 0, "B2": 4 * 5, "B3": 0} or row["segments_per_photon"] != 5 or not row["value"] > 0:
            fail(f"bench --bounce ({label}): {row}, launches {got} (expected 20 of B2: 4 iterations x 5 segments)")
        # the configuration's deposits against its primary hits, from the same
        # photons (phase 8's rule)
        rho = kw.get("reflectance", 0.5)
        params = SimParams(photon_count=1 << 20, max_iterations=1, max_bounces=4, reflectance=rho, seed=0)
        maps = []
        for p in (params, dataclasses.replace(params, max_bounces=0, traversal="mxu")):
            sim = Simulator(kw.get("scene_mesh", mesh), p, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=1 << 20,
                            device="cuda")
            sim.run_iteration()
            maps.append(float(sim.photon_map.sum()))
        del sim
        # a photon deposits D = 1 + (the bounces Russian roulette lets it
        # make, at most 4) times if every bounce hits: E[D] = sum rho^k, the
        # bound, which a closed room reaches; its mean over the primary
        # hits may pass it by 5 standard deviations of that mean at most
        ratio, bound = maps[0] / maps[1], (1 - rho ** 5) / (1 - rho)
        sigma = ((sum((2 * k + 1) * rho ** k for k in range(5)) - bound ** 2) / maps[1]) ** 0.5
        if not 1.0 < ratio <= bound + 5 * sigma:
            fail(f"bench --bounce ({label}): deposits / primary hits {ratio:.5f} not in (1, {bound:.5f} + 5 x "
                 f"{sigma:.2g}]")
        say(f"bench --bounce ({label}, 2^20 photons, 4 bounces, best of 3 after one warm-up): {json.dumps(row)} | "
            f"{got['B2']} B2 launches, deposits / primary hits {ratio:.5f} (expected at most {bound:.5f}, "
            f"sigma {sigma:.2g}), {wall:.1f} s with the scene build [{card}]")
    del room443

    # ---- 38. bench --scaling on one NCCL rank ---------------------------------------------------
    t0 = time.perf_counter()
    scaling = bench.scaling_rows(device_counts=[1], device="cuda")
    wall = time.perf_counter() - t0
    if (len(scaling) != 1 or scaling[0]["efficiency"] != 1.0 or scaling[0]["platform"] != "cuda"
            or not scaling[0]["rays_per_sec"] > 0):
        fail(f"bench --scaling --devices 1: {scaling}")
    try:
        bench.scaling_rows(device_counts=[torch.cuda.device_count() + 1], device="cuda")
        fail("bench --scaling past the card count did not exit")
    except SystemExit as e:
        refusal = str(e)
    say(f"bench --scaling --devices 1 (one spawned NCCL rank, 2^20 photons x 3 iterations): {json.dumps(scaling[0])}"
        f" | {wall:.1f} s with the rank's start-up; {torch.cuda.device_count() + 1} devices: SystemExit "
        f"\"{refusal}\" [{card}]")

    # ---- 39. entry() on the card, against B2's plain version, and the dry runs ----------------
    step, args = entry("cuda")
    zero_counters()
    maps_k = step(*args)
    entry_launches = counters()
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    slots_fn = tm.traverse_mxu_slots
    tm.traverse_mxu_slots = lambda scene, o, d, packet=tm.PACKET: tm.traverse_mxu_padded_reference(
        scene, o, d, packet=packet)
    try:
        maps_p = step(*args)
    finally:
        tm.traverse_mxu_slots = slots_fn
    scene, key, lamp_e = args[0], args[3], args[4]
    rays = generate_stratified(key, 2048, lamp_e, 1.0, device="cuda")
    stats, _ = agree("entry() step, B2 vs plain", tm.traverse_mxu_padded(scene, rays.orig, rays.dir, with_counts=True),
                     tm.traverse_mxu_padded_reference(scene, rays.orig, rays.dir, with_counts=True), 2048,
                     with_visits=False)
    map_diff = int(((maps_k[0] - maps_p[0]).abs() / args[5]).sum())
    if entry_launches != {"B1": 0, "B2": 1, "B3": 0} or map_diff > 2 * stats["slot_mismatches"] or not (
            torch.equal(maps_k[1] > 0, maps_k[0] > 0) and float(maps_k[0].sum()) > 0):
        fail(f"entry() step on the card: launches {entry_launches}, photon map |diff| {map_diff} hits against "
             f"B2's plain version with {stats['slot_mismatches']} slot mismatches")
    _, dry1 = quiet(dryrun_multichip, 1)
    _, dry2 = quiet(dryrun_multichip, 2, share_cards=True)
    if len(dry1) != 2 or len(dry2) != 3 or not all(ln.startswith("[dryrun] ok: ") for ln in dry1 + dry2):
        fail(f"dry runs: {dry1 + dry2}")
    say(f"entry() on the card: 2048 stratified rays, one B2 launch, {float(maps_k[0].sum()):.0f} photon-map units, "
        f"a step {min(step_ms):.3f} ms (best of 5 after the first, host clock between synchronizes), "
        f"photon maps against B2's plain version |diff| {map_diff} hits ({', '.join(f'{k} {v}' for k, v in stats.items())})"
        f" | dryrun_multichip(1), one NCCL rank: " + " / ".join(dry1) + " | dryrun_multichip(2, share_cards=True), "
        "two gloo ranks on cuda:0: " + " / ".join(dry2) + f" [{card}]")

    # ---- 40. the bench through the CLI -------------------------------------------------------
    t0 = time.perf_counter()
    rc, out40, err40 = run_group([sys.executable, "-m", "uvtrace_torch", "bench", "--bounce", "--rays", "65536",
                                  "--iters", "1"], timeout=600)
    lines40 = [ln for ln in out40.splitlines() if ln.startswith("{")]
    row40 = json.loads(lines40[0]) if rc == 0 and len(lines40) == 1 else None
    if row40 is None or not ({"metric", "value", "unit", "vs_baseline"} <= row40.keys() and row40["value"] > 0):
        fail(f"python -m uvtrace_torch bench --bounce exited {rc} with {lines40}: {err40[-3000:]}")
    say(f"python -m uvtrace_torch bench --bounce --rays 65536 --iters 1: {lines40[0]} | "
        f"{time.perf_counter() - t0:.1f} s with the process start [{card}]")
    return {"rows": rows, "launches": launches}


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
        from uvtrace_torch.utils import timing

        def staged():
            """(bytes, seconds) the rank's collectives staged through the host so far."""
            seconds = sum(s.seconds for s in timing.spans() if s.name.startswith("collective."))
            return timing.counters()["collective.staged_bytes"], seconds

        def counters():
            if torch.device(cfg["device"]).type == "cuda":
                torch.cuda.synchronize()
            return launched("traverse_mxu_launch"), launched("fused_trace_launch"), launched("traverse_pallas_launch")

        def zero():
            zero_launches(*B_ENTRIES)

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
        with timing.tracing():  # the collectives' spans time the staging
            sim.compute()
        rep["c5_launches"] = counters()
        rep["c5_s"] = time.perf_counter() - t0
        rep["c5_staged_bytes"], rep["c5_staged_s"] = staged()
        rep["c5_peak"] = torch.cuda.max_memory_allocated() if on_card else 0
        rep["c5_own_slots"] = sim.photon_map_tex.shape[0]
        tex = sim.full_texel_map(sim.photon_map_tex).cpu().numpy()
        rep["c5_equal"] = (np.array_equal(sim.photon_map.cpu().numpy(), ref["map5"])
                           and np.array_equal(tex, np.load(os.path.join(ref_dir, "tex5.npy"))))
        del tex
        zero()
        t0 = time.perf_counter()
        with timing.tracing():
            grid = sim.dose_grid(cfg["grid"])
        rep["grid_s"] = time.perf_counter() - t0
        rep["grid_launches"] = counters()
        rep["grid_equal"] = np.array_equal(grid, np.load(os.path.join(ref_dir, "grid5.npy")))
        rep["staged_bytes"], rep["staged_s"] = staged()
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
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        sm_clock_mhz = float(clk.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no maximum SM clock: {clk.stdout!r} {clk.stderr!r}")
    issue_peak = issue_peak_ops_s(sm_clock_mhz, torch.cuda.get_device_properties(0).multi_processor_count)
    say(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind} x{torch.cuda.device_count()} "
        f"| max SM clock {sm_clock_mhz:.0f} MHz, issue peak {issue_peak / 1e12:.2f} T 32-bit operations/s")

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
    say(f"pinned total: {pinned('pinned total', total, True, 5)}")

    # ---- 5. main path --------------------------------------------------------
    route = load_route_xml(ROUTE)
    params = route.apply_to(SimParams())
    params = dataclasses.replace(params, photon_count=1 << 25, max_iterations=2)
    sim = Simulator(mesh, params, route=route.waypoints, device="cuda")
    ppl = sim.photons_per_light
    chunk_main = min(sim.ray_chunk, 1 << (ppl - 1).bit_length())
    expected = params.max_iterations * len(sim.route) * -(-ppl // chunk_main)
    zero_launches(*B_ENTRIES)
    zero_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose = sim.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k_after("direct", {})  # B1 draws its rays itself and histograms them
    launches = launched("fused_trace_launch")
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
    say(f"split pinned total: {pinned('split pinned total', total, False, 5)}")

    # ---- 8. config 2: 4 bounces with Russian roulette ---------------------------
    rho2 = 0.25
    p2 = dataclasses.replace(SimParams(), photon_count=1 << 25, max_iterations=1, max_bounces=4,
                             reflectance=rho2)
    sim2 = Simulator(mesh, p2, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    chunks2 = (1 << 25) // sim2.ray_chunk
    zero_launches(*B_ENTRIES)
    zero_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose2 = sim2.compute()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # a chunk: K2 for its primary rays (B2 histograms them), then a bounce
    # step (K4) and a histogram of its segment (K5) a bounce, and no K1
    k_after("config2", {"K2": chunks2, "K4": chunks2 * 4, "K5": chunks2 * 4})
    b2_launches = launched("traverse_mxu_launch")
    if b2_launches != chunks2 * (1 + 4) or launched("fused_trace_launch") != 0:
        fail(f"config 2 launched B2 {b2_launches} times (expected {chunks2 * 5}) and B1 "
             f"{launched('fused_trace_launch')} times (expected 0)")
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
    with plain_launch_ops():
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
    # the device launches of one chunk of the path: every kernel and memset the profiler records
    from torch.profiler import ProfilerActivity, profile

    one_chunk = dict(small, n=chunk, chunk=chunk)
    launch_counts(sim2.scene, key2, lamp2, 1.0, **sim2._trace, **one_chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launch_counts(sim2.scene, key2, lamp2, 1.0, **sim2._trace, **one_chunk)
        torch.cuda.synchronize()
    per_chunk = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_chunk[e.key[:60]] = per_chunk.get(e.key[:60], 0) + e.count
    chunk_launches = sum(per_chunk.values())
    lanes = 5 * (1 << 25)
    say(f"config 2 launch of 2^18 photons, kernels vs plain versions (B2, K4, K5 and their plain versions): "
        f"{tot_k} vs {tot_p} deposits, per-triangle |diff| {launch_diff} (bound {launch_bound}) | one chunk of "
        f"2^20 photons: {chunk_launches} device launches ("
        + ", ".join(f"{k} {v}" for k, v in sorted(per_chunk.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    say(f"config 2: testroomopt, 2^25 photons, 4 bounces, rho {rho2}: {b2_launches} B2 launches "
        f"({chunks2} chunks x 5), deposits / primary hits {ratio:.5f} (bound {bound:.5f}), "
        f"{int(deposits)} deposits; first iteration {first_s:.3f} s, repeat {seconds2:.3f} s (same map): "
        f"{lanes / seconds2 / 1e6:.1f} Mrays/s over all 5 segments ({(1 << 25) / seconds2 / 1e6:.2f} M photons/s, "
        f"{deposits / seconds2 / 1e6:.1f} M deposits/s) [{card}]")

    # ---- 9. probe grid ----------------------------------------------------------
    zero_launches(*B_ENTRIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = sim.dose_grid(256)
    grid_s = time.perf_counter() - t0  # ends in the grid's copy to the host
    grid_launches = launched("traverse_mxu_launch")
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
    say(f"gen-1 pinned total: {pinned('gen-1 pinned total', total, False, 5)} [{card}]")

    # ---- 12. pallas main path ----------------------------------------------------------
    pp = dataclasses.replace(route.apply_to(SimParams()), photon_count=1 << 25, max_iterations=1,
                             sampler="native", traversal="pallas")
    simp = Simulator(mesh, pp, route=route.waypoints, device="cuda")
    n_wp = simp.photons_per_light
    chunks_p = -(-n_wp // min(simp.ray_chunk, 1 << (n_wp - 1).bit_length()))
    expected_p = len(simp.route) * chunks_p
    zero_launches(*B_ENTRIES)
    zero_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose_p = simp.compute()
    torch.cuda.synchronize()
    first_p = time.perf_counter() - t0
    k_after("pallas", {"K1": 3 * expected_p, "K5": expected_p})  # generate_native: 3 draws a chunk
    b3_launches = launched("traverse_pallas_launch")
    if b3_launches != expected_p or launched("fused_trace_launch") or launched("traverse_mxu_launch"):
        fail(f"pallas main path: B3 launched {b3_launches} times (expected {expected_p}), B1 "
             f"{launched('fused_trace_launch')}, B2 {launched('traverse_mxu_launch')} (expected 0)")
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
    zero_launches("traverse_pallas_launch")
    zero_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dose_r = simr.compute()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    k_after("reference", {"K3": expected_p, "K5": expected_p})  # one K3 launch and one histogram a chunk
    seed = 0
    for w in simr.route:
        seed = rng.advance_global_seed([w.x, float(np.float32(mesh.floor_height + pp.light_height)), w.y], seed)
    mean_r, mean_n = float(dose_r.mean()), float(dose_p.mean())
    if simr.global_seed != seed or launched("traverse_pallas_launch") != expected_p or abs(mean_r / mean_n - 1) > 0.01:
        fail(f"reference sampler: global seed {simr.global_seed} vs host replay {seed}, {launched('traverse_pallas_launch')} "
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
    zero_launches("traverse_pallas_launch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounce_k = launch_counts(simb.scene, key_b, lamp_b, 1.0, extend_fn=tp.traverse_pallas, **bkw)[0]
    torch.cuda.synchronize()
    bounce_s = time.perf_counter() - t0
    bounce_launches = launched("traverse_pallas_launch")
    t0 = time.perf_counter()
    with plain_launch_ops():
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
    zero_launches(*B_ENTRIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid_p = simp.dose_grid(256)
    grid_p_s = time.perf_counter() - t0  # ends in the grid's copy to the host
    if (launched("traverse_pallas_launch") != 2 or launched("traverse_mxu_launch") or grid_p.shape != (256, 256)
            or not np.isfinite(grid_p).all() or (grid_p > 0).mean() < 0.5):
        fail(f"pallas probe grid: {launched('traverse_pallas_launch')} B3 launches (expected 2), shape {grid_p.shape}, "
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
    zero_launches(*B_ENTRIES)
    zero_k_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim5.compute()
    torch.cuda.synchronize()
    first5_s = time.perf_counter() - t0
    k_after("config5", {"K2": chunks5, "K6": chunks5})  # B2 histograms the triangles
    c5_launches = (launched("traverse_mxu_launch"), launched("fused_trace_launch"), launched("traverse_pallas_launch"))
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
    zero_launches(*B_ENTRIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid5 = sim5.dose_grid(4096)
    grid5_s = time.perf_counter() - t0  # ends in the image's copy to the host
    grid5_launches = launched("traverse_mxu_launch")
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
            ("B2", sim5, sim5._trace, plain_b2, "traverse_mxu_launch"),
            ("B3", simp5, simp5._trace, dict(extend_fn=tp.traverse_pallas_reference), "traverse_pallas_launch")):
        zero_launches(counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kc, kt = texel_launch(s_, kernel_fns, key5, lamp5, n18)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        k_launches = launched(counter)
        t0 = time.perf_counter()
        with plain_launch_ops():
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
    from uvtrace_torch.utils import timing

    torch.cuda.set_device(0)
    initialize("nccl", world_size=1)
    collectives_before = timing.counters()
    sim11 = Simulator(mesh, p5, route=[LightPos(0.0, 0.0, 1.0)], device_mesh=make_2d_mesh(1, 1), device="cuda:0")
    sim11.compute()
    sim11.reset()
    zero_launches(*B_ENTRIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim11.compute()
    torch.cuda.synchronize()
    nccl_s = time.perf_counter() - t0
    nccl_launches = (launched("traverse_mxu_launch"), launched("fused_trace_launch"), launched("traverse_pallas_launch"))
    if nccl_launches != (chunks5, 0, 0):
        fail(f"config 5 on one NCCL rank launched B2, B1, B3 {nccl_launches} times, expected ({chunks5}, 0, 0)")
    if not (torch.equal(sim11.photon_map, map5) and torch.equal(sim11.full_texel_map(sim11.photon_map_tex), tex5)):
        fail("config 5 on one NCCL rank (1 x 1 mesh): other triangle or texel maps than phase 17's")
    staged_bytes = timing.counters()["collective.staged_bytes"] - collectives_before["collective.staged_bytes"]
    if staged_bytes:
        fail(f"config 5 on one NCCL rank staged {staged_bytes} bytes through the host")
    nccl_calls = timing.counters()["collective.calls"] - collectives_before["collective.calls"]
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

    # ---- 36-40. the bench and the entry points ---------------------------------------------
    benched = bench_phases(mesh, card)

    # ---- 41-43. the sampler kernels against their plain versions ---------------------------
    from uvtrace_torch.ops.generate import (generate_reference, generate_reference_reference,
                                            generate_stratified_reference)

    two_pi = float(np.float32(2.0 * np.pi))
    odd = chunk + 37  # not a whole number of 256-thread blocks
    k1_err = 0.0
    for shape in (chunk, odd, (4, mesh.triangle_count, 1)):
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (0.0, 2.0 * np.pi)):
            k1_err = max(k1_err, bits_equal(f"K1 {shape} [{lo}, {hi})", [rng.uniform(key, shape, "cuda", lo, hi)],
                                            [rng.uniform_reference(key, shape, "cuda", lo, hi)]))
    k1_ms = launch_ms(lambda: rng.uniform(key, chunk, "cuda", 0.0, two_pi))
    k1_odd_ms = launch_ms(lambda: rng.uniform(key, odd, "cuda", 0.0, two_pi))
    k1_call_ms = cuda_ms(lambda: rng.uniform(key, chunk, "cuda", 0.0, two_pi), 50)
    k1_alone_ms = kernel_only_ms(lambda: rng.uniform(key, chunk, "cuda", 0.0, two_pi))
    k1_plain_ms = cuda_ms(lambda: rng.uniform_reference(key, chunk, "cuda", 0.0, two_pi), 5)
    k1_bound = sampler_roofline(4 * chunk, sum(K1_OPS) * chunk, issue_peak)
    say(f"K1 threefry_uniform vs plain: bit-equal at 2^20, 2^20 + 37 and (4, {mesh.triangle_count}, 1) in "
        f"[0, 1), [-1, 1), [0, 2 pi) | 2^20: kernel {k1_ms:.4f} ms a launch back to back (2^20 + 37 "
        f"{k1_odd_ms:.4f} ms; the kernel alone {k1_alone_ms:.4f} ms, against "
        f"{sum(K1_OPS) * chunk / (issue_peak / 2) * 1e3:.4f} ms for its operations on 64 lanes an SM), a call "
        f"{k1_call_ms:.4f} ms between events, plain {k1_plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms by "
        f"{k1_bound[1]} ({K1_OPS[0]} int32 and {K1_OPS[1]} f32 operations an element) [{card}]")

    k2_err = 0.0
    for n2, packet2 in ((chunk, 1024), ((1 << 20) - 1, 1023)):  # grids (4, 16, 16) and (1, 25, 41)
        k2_err = max(k2_err, bits_equal(
            f"K2 n={n2} packet={packet2}", generate_stratified(key, n2, lamp, 1.0, packet=packet2, device="cuda"),
            generate_stratified_reference(key, n2, lamp, 1.0, packet=packet2, device="cuda")))
    k2_ms = launch_ms(lambda: generate_stratified(key, chunk, lamp, 1.0, device="cuda"))
    k2_odd_ms = launch_ms(lambda: generate_stratified(key, (1 << 20) - 1, lamp, 1.0, packet=1023, device="cuda"))
    k2_call_ms = cuda_ms(lambda: generate_stratified(key, chunk, lamp, 1.0, device="cuda"), 50)
    k2_alone_ms = kernel_only_ms(lambda: generate_stratified(key, chunk, lamp, 1.0, device="cuda"))
    k2_plain_ms = cuda_ms(lambda: generate_stratified_reference(key, chunk, lamp, 1.0, device="cuda"), 5)
    t0 = time.perf_counter()
    for _ in range(100):
        rng.split(key, 3)
    key_split_ms = (time.perf_counter() - t0) * 10
    k2_bound = sampler_roofline(24 * chunk, sum(K2_OPS) * chunk, issue_peak)
    say(f"K2 generate_stratified vs plain: origins and directions bit-equal at 2^20 (packet 1024) and 2^20 - 1 "
        f"(packet 1023) | 2^20: kernel {k2_ms:.4f} ms a launch back to back (2^20 - 1 {k2_odd_ms:.4f} ms; the "
        f"kernel alone {k2_alone_ms:.4f} ms), a "
        f"call {k2_call_ms:.4f} ms between events (the host's rng.split(key, 3) alone {key_split_ms:.4f} ms), plain "
        f"{k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms by {k2_bound[1]} [{card}]")

    k3_err, seed3 = 0.0, 3458748736
    # photon ids from 0, and across 2^24 and the int32 wrap at 2^31
    for n3, start3 in ((chunk, 0), (chunk, (1 << 31) - (1 << 19)), (odd, (1 << 31) - 1000), (odd, (1 << 24) - 7)):
        k3_err = max(k3_err, bits_equal(
            f"K3 n={n3} start={start3}", generate_reference(n3, lamp, 1.0, seed3, start3, device="cuda"),
            generate_reference_reference(n3, lamp, 1.0, seed3, start3, device="cuda")))
    k3_ms = launch_ms(lambda: generate_reference(chunk, lamp, 1.0, seed3, 0, device="cuda"))
    k3_odd_ms = launch_ms(lambda: generate_reference(odd, lamp, 1.0, seed3, (1 << 31) - 1000, device="cuda"))
    k3_call_ms = cuda_ms(lambda: generate_reference(chunk, lamp, 1.0, seed3, 0, device="cuda"), 50)
    k3_alone_ms = kernel_only_ms(lambda: generate_reference(chunk, lamp, 1.0, seed3, 0, device="cuda"))
    k3_plain_ms = cuda_ms(lambda: generate_reference_reference(chunk, lamp, 1.0, seed3, 0, device="cuda"), 3)
    pairs = reference_pairs(chunk, lamp, seed3, 0)
    k3_bound = sampler_roofline(24 * chunk, sum(K3_OPS) * chunk + sum(K3_PAIR_OPS) * pairs, issue_peak)
    say(f"K3 generate_reference vs plain: origins and directions bit-equal at 2^20 and 2^20 + 37, photon ids "
        f"from 0, 2^24 - 7, 2^31 - 2^19 and 2^31 - 1000 | 2^20 from 0: kernel {k3_ms:.4f} ms a launch back to "
        f"back (2^20 + 37 {k3_odd_ms:.4f} ms; the kernel alone {k3_alone_ms:.4f} ms), a call {k3_call_ms:.4f} ms between events, plain "
        f"{k3_plain_ms:.3f} ms, {pairs / chunk:.4f} disc candidates a photon, bound {k3_bound[0]:.4f} ms by "
        f"{k3_bound[1]} [{card}]")

    # ---- 44-46. the launch layer's kernels against their plain versions ---------------------
    from uvtrace_torch.ops.accumulate import hit_histogram, hit_histogram_reference
    from uvtrace_torch.ops.bounce import bounce_step, bounce_step_reference, sort_rays
    from uvtrace_torch.ops.texel import texel_bin, texel_bin_reference, texel_slots

    # one chunk of config 2 as launch_counts runs it: 2^20 stratified primaries
    # through B2 (every lane alive), then 4 bounce segments, each made by K4
    # from the one before, coherence-sorted and traced by B2
    normals2, rho2_t = sim2._normals_launch, sim2._reflectance_launch()
    r0 = generate_stratified(key2, chunk, lamp2, 1.0, device="cuda")
    segs = [(r0.orig, r0.dir, *tm.traverse_mxu_slots(sim2.scene, r0.orig, r0.dir),
             torch.ones(chunk, dtype=torch.bool, device="cuda"))]
    bkeys = [rng.fold_in(rng.fold_in(key2, 7919 + b), 0) for b in range(4)]
    for b in range(4):
        o_, d_, a_, sk_ = bounce_step(bkeys[b], *segs[b][:4], normals2, rho2_t, segs[b][4])
        o_, d_, a_ = sort_rays(sk_, o_, d_, a_)
        segs.append((o_, d_, *tm.traverse_mxu_slots(sim2.scene, o_, d_, packet=4096), a_))

    def at(seg, n):
        """A segment at n rays: 2^20 + 37 repeats its first 37 rays at the end."""
        return seg if n == chunk else tuple(torch.cat([x, x[:n - chunk]]).contiguous() for x in seg)

    def step_args(b, n):
        o_, d_, t_, h_, a_ = at(segs[b], n)
        return bkeys[b], o_, d_, t_, h_, normals2, rho2_t, a_

    k4_err = 0.0
    for b in range(4):
        for n4 in (chunk, odd):
            k4_err = max(k4_err, bits_equal(f"K4 bounce {b + 1} at {n4}", bounce_step(*step_args(b, n4)),
                                            bounce_step_reference(*step_args(b, n4))))
    k4_ms = [launch_ms(lambda: bounce_step(*step_args(b, chunk))) for b in range(4)]
    odd_args = step_args(0, odd)  # made once: at() concatenates
    k4_odd_ms = launch_ms(lambda: bounce_step(*odd_args))
    k4_alone_ms = kernel_only_ms(lambda: bounce_step(*step_args(0, chunk)))
    k4_call_ms = cuda_ms(lambda: bounce_step(*step_args(0, chunk)), 50)
    k4_plain_ms = cuda_ms(lambda: bounce_step_reference(*step_args(0, chunk)), 3)

    def distinct(x):
        return int(torch.unique(x).numel())

    k4_bound, k4_lanes = [], []
    for b in range(4):  # the bounds from each bounce's own roulette lanes and survivors
        h_, a_ = segs[b][3], segs[b][4]
        rr, surv = a_ & (h_ >= 0), bounce_step(*step_args(b, chunk))[2]
        n_rr, n_surv = int(rr.sum()), int(surv.sum())
        k4_lanes.append((n_rr, n_surv))
        k4_bound.append(sampler_roofline(
            K4_LANE_BYTES * chunk + K4_SURVIVOR_BYTES * n_surv + K4_REFLECTANCE_BYTES * distinct(h_[rr])
            + K4_NORMAL_BYTES * distinct(h_[surv]), n_rr * sum(K4_RR_OPS) + n_surv * sum(K4_SURVIVOR_OPS),
            issue_peak))
    say(f"K4 bounce_step vs plain: new rays, alive lanes and sort keys bit-equal on the 4 bounces of a config-2 "
        f"chunk (rho 0.25; {', '.join(str(int(sg[4].sum())) for sg in segs[1:])} lanes alive after them) at "
        f"2^20 and 2^20 + 37 | bounce 1..4: kernel {', '.join(f'{v:.4f}' for v in k4_ms)} ms a launch back to back "
        f"(2^20 + 37 {k4_odd_ms:.4f} ms; the kernel alone {k4_alone_ms:.4f} ms), a call {k4_call_ms:.4f} ms between "
        f"events, plain {k4_plain_ms:.3f} ms, bound {', '.join(f'{v[0]:.4f}' for v in k4_bound)} ms by "
        f"{', '.join(v[1] for v in k4_bound)} (roulette draws, survivors: "
        f"{', '.join(f'{r_}, {s_}' for r_, s_ in k4_lanes)}) [{card}]")

    bins2 = normals2.shape[0]
    start2 = torch.randint(0, 50, (bins2,), dtype=torch.int32, device="cuda")
    k5_err, k5_ms, k5_lib_ms, k5_bound = 0.0, [], [], []
    for b in range(1, 5):
        for n5 in (chunk, odd):
            _, _, _, h_, a_ = at(segs[b], n5)
            k5_err = max(k5_err, bits_equal(f"K5 bounce segment {b} at {n5}", [hit_histogram(h_, start2.clone(), a_)],
                                            [hit_histogram_reference(h_, start2.clone(), a_)]))
        _, _, _, h_, a_ = segs[b]
        buf = start2.clone()
        k5_ms.append(launch_ms(lambda: hit_histogram(h_, buf, a_)))
        # the library's call on the same ids, as the port made its histogram
        # until now: every miss and dead lane into one overflow bin
        ids_m = torch.where(a_ & (h_ >= 0), h_, bins2).long()
        ones_m, lib_out = torch.ones(chunk, dtype=torch.int32, device="cuda"), torch.zeros(bins2 + 1, dtype=torch.int32,
                                                                                            device="cuda")
        k5_lib_ms.append(launch_ms(lambda: lib_out.index_add_(0, ids_m, ones_m)))
        counted = a_ & (h_ >= 0)
        k5_bound.append(roofline(K5_ALIVE_BYTES * chunk + K5_ID_BYTES * int(a_.sum())
                                 + K5_BIN_BYTES * distinct(h_[counted]), 0.0))
    h1, a1 = segs[1][3], segs[1][4]
    buf = start2.clone()
    _, _, _, h1_odd, a1_odd = at(segs[1], odd)
    k5_odd_ms = launch_ms(lambda: hit_histogram(h1_odd, buf, a1_odd))
    k5_alone_ms = kernel_only_ms(lambda: hit_histogram(h1, buf, a1))
    k5_call_ms = cuda_ms(lambda: hit_histogram(h1, buf, a1), 50)
    k5_plain_ms = cuda_ms(lambda: hit_histogram_reference(h1, buf, a1), 5)
    say(f"K5 hit_histogram vs plain: bit-equal into non-zero counts on the 4 bounce segments of a config-2 chunk "
        f"({', '.join(str(int((sg[4] & (sg[3] >= 0)).sum())) for sg in segs[1:])} alive hits of 2^20) at 2^20 and "
        f"2^20 + 37 | segments 1..4: kernel {', '.join(f'{v:.4f}' for v in k5_ms)} ms a launch back to back, "
        f"index_add_ on the same ids (misses into an overflow bin) {', '.join(f'{v:.4f}' for v in k5_lib_ms)} ms, "
        f"bound {', '.join(f'{v[0]:.4f}' for v in k5_bound)} ms by bytes | segment 1: 2^20 + 37 {k5_odd_ms:.4f} ms, "
        f"the kernel alone {k5_alone_ms:.4f} ms, a call {k5_call_ms:.4f} ms between events, plain "
        f"{k5_plain_ms:.3f} ms [{card}]")

    sim5b = Simulator(mesh, p5, route=[LightPos(0.0, 0.0, 1.0)], device="cuda")
    if not torch.equal(sim5b._slot_map, sim2._slot_map):
        fail("config 5's and config 2's Simulators index different slots")
    tex_geo = (sim5b._tri_v0, sim5b._tri_e1, sim5b._tri_e2)
    atlas5 = sim5b._atlas_launch
    start5 = torch.randint(0, 5, (sim5b._n_texels,), dtype=torch.int32, device="cuda")
    k6_err = 0.0
    for label, b, with_alive in (("primaries", 0, False), ("bounce segment 1", 1, True)):
        for n6 in (chunk, odd):
            o_, d_, t_, h_, a_ = at(segs[b], n6)
            a_ = a_ if with_alive else None
            k6_err = max(k6_err, bits_equal(
                f"K6 {label} at {n6}", [texel_bin(atlas5, o_, d_, t_, h_, *tex_geo, start5.clone(), a_)],
                [texel_bin_reference(atlas5, o_, d_, t_, h_, *tex_geo, start5.clone(), a_)]))
    tex_buf = start5.clone()
    prim = segs[0][:4]
    k6_ms = launch_ms(lambda: texel_bin(atlas5, *prim, *tex_geo, tex_buf))
    prim_odd = at(segs[0], odd)[:4]
    k6_odd_ms = launch_ms(lambda: texel_bin(atlas5, *prim_odd, *tex_geo, tex_buf))
    k6_alone_ms = kernel_only_ms(lambda: texel_bin(atlas5, *prim, *tex_geo, tex_buf))
    k6_call_ms = cuda_ms(lambda: texel_bin(atlas5, *prim, *tex_geo, tex_buf), 50)
    k6_plain_ms = cuda_ms(lambda: texel_bin_reference(atlas5, *prim, *tex_geo, tex_buf), 3)
    n_hits6, tris6 = int((prim[3] >= 0).sum()), distinct(prim[3][prim[3] >= 0])
    touched6 = distinct(texel_slots(atlas5, *prim, *tex_geo)) - 1
    k6_bound = sampler_roofline(K6_LANE_BYTES * chunk + K6_HIT_BYTES * n_hits6 + K6_TRI_BYTES * tris6
                                + K6_TEXEL_BYTES * touched6, n_hits6 * sum(K6_HIT_OPS), issue_peak)
    del sim5b, start5, tex_buf
    say(f"K6 texel_bin vs plain: config 5's atlas ({atlas5.n_slots} slots): texel counts bit-equal into non-zero "
        f"counts on a chunk's primaries and its first bounce segment (alive lanes) at 2^20 and 2^20 + 37 | "
        f"primaries, 2^20: kernel {k6_ms:.4f} ms a launch back to back (2^20 + 37 {k6_odd_ms:.4f} ms; the kernel "
        f"alone {k6_alone_ms:.4f} ms), a call {k6_call_ms:.4f} ms between events, plain {k6_plain_ms:.3f} ms, "
        f"bound {k6_bound[0]:.4f} ms by {k6_bound[1]} ({n_hits6} hits on {tris6} triangles into {touched6} texels) "
        f"[{card}]")

    # ---- 47-50. the direct estimator's kernels against their plain versions, 100 steps ---------
    dk = direct_kernel_phases(mesh, card, issue_peak)

    # ---- 51-54. the interreflection term's kernels against their plain versions ---------------
    bk = bounce_kernel_phases(mesh, card, issue_peak)

    # ---- 55. result -----------------------------------------------------------------------
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

    def bench_ms(backend):
        """ms per 2^20-ray iteration of the 20-iteration headline (phase 36)."""
        return 1e3 * (1 << 20) / benched["rows"][(backend, 20)]["value"]

    say(json.dumps({"kernels": [{
        "name": "fused_trace_counts", "route": "cuda", "source": "uvtrace_torch/csrc/fused_trace.cu",
        "replaces": "uvtrace/ops/traverse_mxu.py:807", "launches": launches,
        "max_abs_err": t_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
        "route_2x1_launches_per_rank": [reports[r]["direct_launches"][1] for r in sorted(reports)],
        "bench_launches": benched["launches"]["B1"], "bench_ms_per_iteration": bench_ms("mxu-fused"),
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
        "bench_launches": benched["launches"]["B2"], "bench_ms_per_iteration": bench_ms("mxu"),
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
        "bench_launches": benched["launches"]["B3"], "bench_ms_per_iteration": bench_ms("pallas"),
        "b3_443k_native_ms": nat["native"]["b3"], "b3_443k_numpy_ms": nat["numpy"]["b3"],
    }, {
        "name": "threefry_uniform", "route": "cuda", "source": "uvtrace_torch/csrc/samplers.cu",
        "replaces": "uvtrace/ops/generate.py:111-117, uvtrace/ops/bounce.py:39-40,74, "
                    "uvtrace/diff/estimator.py:222-223,276,304,407-408 (jax.random.uniform, an XLA fusion, "
                    "no pl.pallas_call)",
        "launches": K_PER_PATH["pallas"]["K1"], "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None, "odd_ms": k1_odd_ms, "call_ms": k1_call_ms, "kernel_only_ms": k1_alone_ms,
        "launches_per_path": {k: v["K1"] for k, v in K_PER_PATH.items()},
    }, {
        "name": "generate_stratified", "route": "cuda", "source": "uvtrace_torch/csrc/samplers.cu",
        "replaces": "uvtrace/ops/generate.py:170-177 (jax.random.uniform, an XLA fusion, no pl.pallas_call)",
        "launches": K_PER_PATH["config2"]["K2"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None, "odd_ms": k2_odd_ms, "call_ms": k2_call_ms, "kernel_only_ms": k2_alone_ms,
        "launches_per_path": {k: v["K2"] for k, v in K_PER_PATH.items()},
    }, {
        "name": "generate_reference", "route": "cuda", "source": "uvtrace_torch/csrc/samplers.cu",
        "replaces": "uvtrace/ops/generate.py:44-101 (generate_reference: XLA ops and the rejection loop's "
                    "lax.while_loop at :97, no pl.pallas_call)",
        "launches": K_PER_PATH["reference"]["K3"], "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        "odd_ms": k3_odd_ms, "call_ms": k3_call_ms, "kernel_only_ms": k3_alone_ms, "launches_per_path": {k: v["K3"] for k, v in K_PER_PATH.items()},
    }, {
        "name": "bounce_step", "route": "cuda", "source": "uvtrace_torch/csrc/launch_ops.cu",
        "replaces": "uvtrace/ops/bounce.py:24-84,111-121 (bounce_rays with cosine_hemisphere and "
                    "orthonormal_basis, and coherence_sort's key: XLA fusions, no pl.pallas_call)",
        "launches": K_PER_PATH["config2"]["K4"], "max_abs_err": k4_err, "ms": k4_ms[0], "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound[0][0], "bound_by": k4_bound[0][1], "library_ms": None, "ms_per_bounce": k4_ms,
        "bound_ms_per_bounce": [v[0] for v in k4_bound],
        "odd_ms": k4_odd_ms, "call_ms": k4_call_ms, "kernel_only_ms": k4_alone_ms,
        "launches_per_path": {k: v["K4"] for k, v in K_PER_PATH.items()},
    }, {
        "name": "hit_histogram", "route": "cuda", "source": "uvtrace_torch/csrc/launch_ops.cu",
        "replaces": "uvtrace/ops/accumulate.py:31-47 (counts_sort and counts_segment: XLA sort and scatter, "
                    "no pl.pallas_call)",
        "launches": K_PER_PATH["config2"]["K5"], "max_abs_err": k5_err, "ms": k5_ms[0], "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound[0][0], "bound_by": k5_bound[0][1], "library_ms": k5_lib_ms[0],
        "ms_per_segment": k5_ms, "library_ms_per_segment": k5_lib_ms,
        "bound_ms_per_segment": [v[0] for v in k5_bound], "odd_ms": k5_odd_ms, "call_ms": k5_call_ms,
        "kernel_only_ms": k5_alone_ms, "launches_per_path": {k: v["K5"] for k, v in K_PER_PATH.items()},
    }, {
        "name": "texel_bin", "route": "cuda", "source": "uvtrace_torch/csrc/launch_ops.cu",
        "replaces": "uvtrace/sim/launch.py:107-115 with uvtrace/ops/texel.py:68-100 (barycentrics, texel_ids "
                    "and the histogram: XLA fusions, no pl.pallas_call)",
        "launches": K_PER_PATH["config5"]["K6"], "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": None, "odd_ms": k6_odd_ms,
        "call_ms": k6_call_ms, "kernel_only_ms": k6_alone_ms,
        "launches_per_path": {k: v["K6"] for k, v in K_PER_PATH.items()},
    }, *({
        "name": name, "route": "cuda", "source": "uvtrace_torch/csrc/diff_ops.cu", "replaces": replaces,
        "launches": K_PER_PATH["config4_direct"][k], "max_abs_err": dk["err"][k],
        "ms": dk["timed"][(k, "triangles")]["ms"], "plain_ms": dk["timed"][(k, "triangles")]["plain_ms"],
        "bound_ms": dk["timed"][(k, "triangles")]["bound_ms"], "bound_by": dk["timed"][(k, "triangles")]["bound_by"],
        "library_ms": None, "call_ms": dk["timed"][(k, "triangles")]["call_ms"],
        "kernel_only_ms": dk["timed"][(k, "triangles")]["kernel_only_ms"],
        "dose_image_plan": dk["timed"][(k, "points")],
        "launches_per_path": {p_: v[k] for p_, v in K_PER_PATH.items()},
    } for k, name, replaces in (
        ("K7", "pack_sorted", "uvtrace/diff/estimator.py:99-140 (the mxu extend's jax.lax.sort carrying the rays "
                              "and the padding concatenations; uvtrace/ops/bounce.py:120; no pl.pallas_call)"),
        ("K8", "shadow_sample", "uvtrace/diff/estimator.py:217-227,253-294,297-320 (_sample_triangle_points, the "
                                "rod draw, G, the shadow rays and the coherence key: XLA fusions, no pl.pallas_call)"),
        ("K9", "visibility_reduce", "uvtrace/diff/estimator.py:230-250,293 (_visibility's comparison and power * "
                                    "mean(g * vis): XLA fusions, no pl.pallas_call)"),
        ("K10", "direct_grad", "the backward jax.grad derives for uvtrace/diff/estimator.py:253-320 (XLA fusions, "
                               "no pl.pallas_call)"))), *({
        "name": name, "route": "cuda", "source": "uvtrace_torch/csrc/bounce_ops.cu", "replaces": replaces,
        "launches": K_PER_PATH["config4_bounce2"][k], "max_abs_err": bk["err"][k],
        "ms": bk["timed"][k]["ms"], "plain_ms": bk["timed"][k]["plain_ms"], "bound_ms": bk["timed"][k]["bound_ms"],
        "bound_by": bk["timed"][k]["bound_by"], "library_ms": None, "call_ms": bk["timed"][k]["call_ms"],
        "kernel_only_ms": bk["timed"][k]["kernel_only_ms"], "matrix": bk["timed"].get(f"{k} matrix"),
        "kept": bk["timed"].get(f"{k} kept"), "launches_per_path": {p_: v[k] for p_, v in K_PER_PATH.items()},
    } for k, name, replaces in (
        ("K11", "source_sample", "uvtrace/diff/estimator.py:404-413 (_source_field's jax.random.choice, the point "
                                 "draws and gathers: XLA fusions, no pl.pallas_call)"),
        ("K12", "transfer_rays", "uvtrace/diff/estimator.py:217-227,230-250,425-430,466-480 (the receivers' draws, "
                                 "the shadow rays, distances and cosines: XLA fusions, no pl.pallas_call)"),
        ("K13", "transfer_reduce", "uvtrace/diff/estimator.py:431-443,473-483,488 (the visibility comparison, F V "
                                   "(1 - I) and the strength-weighted chunk sums: XLA fusions, no pl.pallas_call)"),
        ("K14", "transfer_grad", "the backward jax.grad derives for uvtrace/diff/estimator.py:480-483 (XLA fusions, "
                                 "no pl.pallas_call)"))),
    ]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
