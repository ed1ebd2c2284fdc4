"""Time the port's two plain-torch traversals on the test room, on an NVIDIA GPU.

    python3 scripts/torch_plain_traversals.py
    python3 scripts/torch_plain_traversals.py --rays 262144   # a shorter run

The clustered traversal (uvtrace_torch/ops/traverse_clustered.py, 525
clusters of 128 from the native builder) on 2^20 stratified rays (lamp at
(0, floor + 0.8, 0), 1 m rod, key fold_in(PRNGKey(0), 0)) at budgets 32 and
48, and on 2^20 native iid rays at 512 and at the cluster count; the fine-BVH
walk (uvtrace_torch/ops/traverse.py, build_bvh_native, leaves of at most 8)
on both ray sets, with its lockstep steps. Each against the gen-1 DFS B3 on
the same rays: hits equal but for t-ties (t within rtol 1e-5), the count of
differing ids printed. CUDA events around one call after a warm-up call;
peak device memory of each. Prints one JSON line with the card's name and
power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn) -> tuple[float, object]:
    """(ms of one call of fn after a warm-up call, its result)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from uvtrace_torch.bvh import native
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse as tr
    from uvtrace_torch.ops import traverse_clustered as tc
    from uvtrace_torch.ops import traverse_pallas as tp
    from uvtrace_torch.ops.generate import generate_native, generate_stratified

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    mesh = load_glb(os.path.join(ROOT, "assets", "testroomopt.glb"))
    clusters = native.build_clusters_native(mesh.tris)
    ca = tc.cluster_arrays(clusters, device="cuda")
    pscene = tp.build_pallas_scene(clusters, device="cuda")
    bvh = native.build_bvh_native(mesh.tris, max_leaf_size=8)
    sa = tr.scene_arrays(bvh, device="cuda")
    lamp = (0.0, mesh.floor_height + 0.8, 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    n = args.rays
    rays = {"stratified": generate_stratified(key, n, lamp, 1.0, device="cuda"),
            "native": generate_native(key, n, lamp, 1.0, device="cuda")}
    out = dict(card=card, rays=n, clusters=clusters.n_clusters, bvh_nodes=bvh.n_nodes, max_leaf=bvh.max_leaf_size)
    runs = [("clustered", "stratified", 32), ("clustered", "stratified", 48), ("clustered", "native", 512),
            ("clustered", "native", clusters.n_clusters), ("jax", "stratified", None), ("jax", "native", None)]
    for name, kind, budget in runs:
        r = rays[kind]
        b3_t, b3_hit = tp.traverse_pallas(pscene, r.orig, r.dir)
        if name == "clustered":
            fn = functools.partial(tc.traverse_clustered, ca, r.orig, r.dir, max_clusters=budget,
                                   return_overflow=True)
        else:
            fn = functools.partial(tr.traverse, sa, r.orig, r.dir, max_leaf=bvh.max_leaf_size, with_steps=True)
        ms, res = cuda_ms(fn)
        t, hit = res[0], res[1]
        differ = hit != b3_hit
        both = (hit >= 0) & (b3_hit >= 0)
        rel = torch.where(both, (t - b3_t).abs() / b3_t.abs(), 0.0)
        row = dict(ms=ms, ms_per_2_20=ms * (1 << 20) / n, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   ids_differ_from_b3=int(differ.sum()), t_rel_max_vs_b3=rel.max().item(),
                   hit_miss_flips=int(((hit >= 0) != (b3_hit >= 0)).sum()))
        row["overflow" if name == "clustered" else "steps"] = int(res[2])
        out[f"{name}_{kind}" + (f"_{budget}" if budget else "")] = row
        print(json.dumps({f"{name}_{kind}_{budget}": row}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
