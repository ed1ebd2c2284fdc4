"""Time the port's three trace kernels on one scene, on an NVIDIA GPU.

    python3 scripts/torch_kernel_scale.py                 # testroomopt and the 443k-triangle box room
    python3 scripts/torch_kernel_scale.py --scene box192  # only the box room

For each scene: ms per 2^20 stratified rays (lamp at (0, floor + 0.8, 0),
1 m rod, key fold_in(PRNGKey(0), 0)) of the fused kernel B1, the split
kernel B2 at 1024-ray packets and the gen-1 DFS B3, and B3 on 2^20 native
iid rays; CUDA events over 5 launches after a warm-up.
B3's hits are checked against B2's (the same closest hits but for t-ties and
edge flips, at most 0.1% of rays). Prints one JSON line per scene, with the
card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from uvtrace_torch.geometry.gltf import load_glb  # noqa: E402
from uvtrace_torch.geometry.procedural import make_box_room  # noqa: E402
from uvtrace_torch.ops import rng  # noqa: E402
from uvtrace_torch.ops import traverse_mxu as tm  # noqa: E402
from uvtrace_torch.ops import traverse_pallas as tp  # noqa: E402
from uvtrace_torch.ops.cluster import build_clusters  # noqa: E402
from uvtrace_torch.ops.generate import generate_native, generate_stratified  # noqa: E402

SCENES = {
    "testroomopt": lambda: load_glb(os.path.join(ROOT, "assets", "testroomopt.glb")),
    "box192": lambda: make_box_room(subdivisions=192, clutter=96),
}


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


def measure(name: str, card: str) -> dict:
    t0 = time.perf_counter()
    mesh = SCENES[name]()
    clusters = build_clusters(mesh.tris, cluster_size=128)
    mscene = tm.build_mxu_scene(clusters, device="cuda")
    pscene = tp.build_pallas_scene(clusters, device="cuda")
    build_s = time.perf_counter() - t0
    n = 1 << 20
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    strat = generate_stratified(key, n, lamp, 1.0, device="cuda")
    native = generate_native(key, n, lamp, 1.0, device="cuda")
    _, slot = tm.traverse_mxu_slots(mscene, strat.orig, strat.dir)
    b2_ids = torch.where(slot >= 0, mscene.tri_idx_flat[slot.clamp_min(0).long()], -1)
    _, b3_ids, stats = tp.traverse_pallas(pscene, strat.orig, strat.dir, with_stats=True)
    _, _, stats_iid = tp.traverse_pallas(pscene, native.orig, native.dir, with_stats=True)
    differ = int((b2_ids != b3_ids).sum())
    if differ > n // 1000:
        raise SystemExit(f"{name}: B3 and B2 first hits differ on {differ} of {n} rays")
    out = {
        "scene": name, "triangles": mesh.triangle_count, "clusters": clusters.n_clusters,
        "top_tree_nodes": pscene.node_meta.shape[0] // 2, "top_tree_depth": pscene.depth,
        "host_build_s": build_s, "b2_b3_id_differ": differ,
        "b1_ms": cuda_ms(lambda: tm.fused_trace_counts(mscene, key, lamp, 1.0, n)),
        "b2_ms": cuda_ms(lambda: tm.traverse_mxu_counts(mscene, strat.orig, strat.dir)),
        "b3_ms": cuda_ms(lambda: tp.traverse_pallas(pscene, strat.orig, strat.dir)),
        "b3_native_ms": cuda_ms(lambda: tp.traverse_pallas(pscene, native.orig, native.dir)),
        "b3_leaves_per_packet": stats[:, 0].float().mean().item(),
        "b3_active_columns_per_packet": stats[:, 1].float().mean().item(),
        "b3_native_leaves_per_packet": stats_iid[:, 0].float().mean().item(),
        "b3_native_active_columns_per_packet": stats_iid[:, 1].float().mean().item(),
        "card": card,
    }
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", choices=sorted(SCENES), action="append")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    for name in args.scene or ["testroomopt", "box192"]:
        print(json.dumps(measure(name, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
