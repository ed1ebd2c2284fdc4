"""Time the port's three trace kernels on one scene, on an NVIDIA GPU.

    python3 scripts/torch_kernel_scale.py                 # testroomopt and the 443k-triangle box room
    python3 scripts/torch_kernel_scale.py --scene box192  # only the box room
    python3 scripts/torch_kernel_scale.py --scene testroomopt \
        --root build/parent --root . --root . --root build/parent   # two checkouts, in turns

For each scene: ms per 2^20 stratified rays (lamp at (0, floor + 0.8, 0),
1 m rod, key fold_in(PRNGKey(0), 0)) of the fused kernel B1, the split
kernel B2 at 1024-ray packets and the gen-1 DFS B3, B3 on 2^20 native iid
rays, B2 (4096-ray packets) and B3 on a first bounce segment of those
stratified rays (rho 0.25, coherence-sorted, parked dead lanes, as
launch_counts makes it), and one B2 launch of the 256^2 probe grid; CUDA
events over 5 launches after a warm-up. B3's hits are checked against B2's
(the same closest hits but for t-ties and edge flips, at most 0.1% of rays),
and on the first 2^16 rays of the bounce segment B2's hit total must equal
its plain version's and B3's be within 0.1% of it.

A root is a directory that holds a `uvtrace_torch/` package (this checkout,
or a `git archive` of another commit unpacked under a git-ignored
directory); each root runs in its own process, in the order given, and
builds its own kernels. Only functions that every checkout since B3's port
offers are called; B2's statistic is the (ray, leaf) tests of its per-ray
walk, or the cluster visits of the packet walk that it replaced; B1's is the
clusters its packets visit (mean and the most of any packet). Prints one
JSON line per root and scene, with the card's name and power limit. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = ("testroomopt", "box192")


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(name: str, card: str, pkg_root: str) -> dict:
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.geometry.procedural import make_box_room
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort
    from uvtrace_torch.ops.cluster import build_clusters
    from uvtrace_torch.ops.generate import generate_native, generate_stratified
    from uvtrace_torch.ops.probes import probe_rays

    if not os.path.samefile(os.path.dirname(tm.__file__), os.path.join(pkg_root, "uvtrace_torch", "ops")):
        raise SystemExit(f"imported {tm.__file__}, not the package under {pkg_root}")
    t0 = time.perf_counter()
    if name == "testroomopt":
        mesh = load_glb(os.path.join(ROOT, "assets", "testroomopt.glb"))
    else:
        mesh = make_box_room(subdivisions=192, clutter=96)
    clusters = build_clusters(mesh.tris, cluster_size=128)
    mscene = tm.build_mxu_scene(clusters, device="cuda")
    pscene = tp.build_pallas_scene(clusters, device="cuda")
    build_s = time.perf_counter() - t0
    n = 1 << 20
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    strat = generate_stratified(key, n, lamp, 1.0, device="cuda")
    native = generate_native(key, n, lamp, 1.0, device="cuda")
    t_hit, slot = tm.traverse_mxu_slots(mscene, strat.orig, strat.dir)
    b2_ids = torch.where(slot >= 0, mscene.tri_idx_flat[slot.clamp_min(0).long()], -1)
    _, b3_ids, stats = tp.traverse_pallas(pscene, strat.orig, strat.dir, with_stats=True)
    _, _, stats_iid = tp.traverse_pallas(pscene, native.orig, native.dir, with_stats=True)
    differ = int((b2_ids != b3_ids).sum())
    if differ > n // 1000:
        raise SystemExit(f"{name}: B3 and B2 first hits differ on {differ} of {n} rays")
    # a first bounce segment of the stratified rays, as launch_counts makes it
    normals = torch.from_numpy(mesh.normals).cuda()[mscene.tri_idx_flat.clamp_min(0).long()]
    rho = torch.full((mscene.tri_idx_flat.shape[0],), 0.25, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    bo, bd, alive = bounce_rays(rng.fold_in(rng.fold_in(key, 7919), 0), strat.orig, strat.dir, t_hit, slot,
                                normals, rho, alive)
    bo, bd, alive = coherence_sort(bo, bd, alive)
    n_live = int(alive.sum())
    seg_tests = tm.traverse_mxu_padded(mscene, bo, bd, packet=4096, with_visits=True)[2]
    m = 1 << 16
    hits = {"b2": int((tm.traverse_mxu_slots(mscene, bo[:m], bd[:m], packet=4096)[1] >= 0).sum()),
            "plain": int((tm.traverse_mxu_padded_reference(mscene, bo[:m], bd[:m], packet=4096)[1] >= 0).sum()),
            "b3": int((tp.traverse_pallas(pscene, bo[:m], bd[:m])[1] >= 0).sum())}
    if hits["b2"] != hits["plain"] or abs(hits["b3"] - hits["plain"]) > m // 1000:
        raise SystemExit(f"{name}: hit totals of the first 2^16 bounce rays {hits}")
    b1_visits = tm.fused_trace_counts(mscene, key, lamp, 1.0, n, with_visits=True)[3].float()
    verts = mesh.tris.reshape(-1, 3)
    po, pd = probe_rays(verts.min(0), verts.max(0), 256, device="cuda")
    out = {
        "root": os.path.abspath(pkg_root), "scene": name, "triangles": mesh.triangle_count, "clusters": clusters.n_clusters,
        "top_tree_nodes": pscene.node_meta.shape[0] // 2, "top_tree_depth": pscene.depth,
        "host_build_s": build_s, "b2_b3_id_differ": differ,
        "b1_ms": cuda_ms(lambda: tm.fused_trace_counts(mscene, key, lamp, 1.0, n)),
        "b2_ms": cuda_ms(lambda: tm.traverse_mxu_counts(mscene, strat.orig, strat.dir)),
        "b3_ms": cuda_ms(lambda: tp.traverse_pallas(pscene, strat.orig, strat.dir)),
        "b3_native_ms": cuda_ms(lambda: tp.traverse_pallas(pscene, native.orig, native.dir)),
        "bounce_live_rays": n_live, "bounce_hits_2_16": hits,
        "b2_bounce_ms": cuda_ms(lambda: tm.traverse_mxu_slots(mscene, bo, bd, packet=4096)),
        "b3_bounce_ms": cuda_ms(lambda: tp.traverse_pallas(pscene, bo, bd)),
        "b2_bounce_tests_per_live_ray": seg_tests.sum().item() / n_live,
        "b2_probe_ms": cuda_ms(lambda: tm.traverse_mxu_slots(mscene, po, pd)),
        "b1_visits_per_packet": b1_visits.mean().item(), "b1_most_visits": int(b1_visits.max()),
        "b3_leaves_per_packet": stats[:, 0].float().mean().item(),
        "b3_active_columns_per_packet": stats[:, 1].float().mean().item(),
        "b3_native_leaves_per_packet": stats_iid[:, 0].float().mean().item(),
        "b3_native_active_columns_per_packet": stats_iid[:, 1].float().mean().item(),
        "card": card,
    }
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", choices=SCENES, action="append")
    p.add_argument("--root", action="append", help="a directory holding uvtrace_torch/ (default: this checkout)")
    p.add_argument("--one", help=argparse.SUPPRESS)  # measure this root in this process
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    scenes = args.scene or list(SCENES)
    if args.one:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
        sys.path.insert(0, args.one)
        for name in scenes:
            print(json.dumps(measure(name, card, args.one)), flush=True)
        return 0
    for root in args.root or [ROOT]:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root)]
        rc = subprocess.run(cmd + [a for name in scenes for a in ("--scene", name)]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
