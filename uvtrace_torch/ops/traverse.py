"""Fine-BVH traversal (uvtrace/ops/traverse.py) in plain torch: the batched,
masked short-stack walk, the JAX package's oracle traversal.

The reference's per-thread ordered depth-first walk (cl/extend.cl:40-81:
near child first, a short local stack, boxes rejected against the best hit
so far) runs for every ray in lockstep: every lane carries its own node,
stack and best hit, the leaf and internal steps are computed for every lane
and applied where they apply, and the leaf loop tests a static `max_leaf`
triangles. The rules are JAX's, one for one: the near child is the second
on d1 > d2 (strict), a leaf keeps a triangle on t < t_best (strict), the
push writes at min(sp, STACK_DEPTH - 1), and no finished lane changes.

Because finished lanes are frozen, the host asks whether every lane is done
only every `CHECK_EVERY` steps, and then drops the finished lanes from the
batch once they are most of it: neither changes a value, and the walk's
cost on the card is its launches per step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uvtrace_torch.device import resolve
from uvtrace_torch.ops.intersect import BIG, intersect_aabb, intersect_tri, safe_inv_dir

STACK_DEPTH = 48  # the reference keeps 32 (cl/extend.cl:42); uvtrace keeps 48
CHECK_EVERY = 8  # steps between two reads of the lanes still walking


class SceneArrays(NamedTuple):
    """A flat BVH and its leaf-ordered triangles on one device."""

    node_min: torch.Tensor  # f32[N, 3]
    node_max: torch.Tensor  # f32[N, 3]
    left_first: torch.Tensor  # i64[N]
    tri_count: torch.Tensor  # i64[N]
    v0: torch.Tensor  # f32[T, 3] triangles in leaf order
    v1: torch.Tensor
    v2: torch.Tensor
    tri_idx: torch.Tensor  # i32[T] leaf order -> original triangle id


def scene_arrays(bvh, device="cuda") -> SceneArrays:
    """The arrays of any object with FlatBVH's fields (bvh/types.py, or the
    JAX package's numpy FlatBVH) on `device`; "cuda" raises without a card."""
    device = resolve(device)
    # writable copies: torch refuses to share a read-only numpy array
    to = lambda a, dtype: torch.from_numpy(np.array(a, dtype, order="C")).to(device)  # noqa: E731
    st = to(bvh.sorted_tris, np.float32)
    return SceneArrays(node_min=to(bvh.node_min, np.float32), node_max=to(bvh.node_max, np.float32),
                       left_first=to(bvh.left_first, np.int64), tri_count=to(bvh.tri_count, np.int64),
                       v0=st[:, 0].contiguous(), v1=st[:, 1].contiguous(), v2=st[:, 2].contiguous(),
                       tri_idx=to(bvh.tri_idx, np.int32))


def _step(scene: SceneArrays, s: dict, orig, direction, inv_dir, max_leaf: int):
    """One lockstep step of every lane of the state `s` (updated in place)."""
    n_nodes, n_tris = scene.node_min.shape[0], scene.v0.shape[0]
    lanes = torch.arange(orig.shape[0], device=orig.device)
    active = ~s["done"]
    node, sp = s["node"], s["sp"]
    lf, tc = scene.left_first[node], scene.tri_count[node]
    is_leaf = tc > 0
    # leaf: up to max_leaf triangles
    t_new, hit_new = s["t"], s["hit"]
    for i in range(max_leaf):
        j = (lf + i).clamp(0, n_tris - 1)
        t = intersect_tri(orig, direction, scene.v0[j], scene.v1[j], scene.v2[j])
        upd = active & is_leaf & (i < tc) & (t < t_new)
        t_new, hit_new = torch.where(upd, t, t_new), torch.where(upd, j, hit_new)
    # internal: both children, the near one first (a gather past the last
    # node clamps, as XLA's does; only leaves make one, and they pop)
    c1, c2 = lf.clamp(0, n_nodes - 1), (lf + 1).clamp(0, n_nodes - 1)
    d1 = intersect_aabb(orig, inv_dir, scene.node_min[c1], scene.node_max[c1], t_new)
    d2 = intersect_aabb(orig, inv_dir, scene.node_min[c2], scene.node_max[c2], t_new)
    swap = d1 > d2
    near, far = torch.where(swap, c2, c1), torch.where(swap, c1, c2)
    miss_both = torch.minimum(d1, d2) >= BIG
    push_far = ~is_leaf & ~miss_both & (torch.maximum(d1, d2) < BIG)
    # next node and stack: pop after a leaf or when both children are missed
    pops = is_leaf | miss_both
    finish = active & pops & (sp == 0)
    top = s["stack"][lanes, (sp - 1).clamp_min(0)]
    s["node"] = torch.where(active, torch.where(pops, top, near), node)
    s["sp"] = torch.where(active, torch.where(pops, (sp - 1).clamp_min(0), sp + push_far.long()), sp)
    at = sp.clamp(0, STACK_DEPTH - 1)
    s["stack"][lanes, at] = torch.where(active & push_far, far, s["stack"][lanes, at])
    s["t"] = torch.where(active, t_new, s["t"])
    s["hit"] = torch.where(active, hit_new, s["hit"])
    s["done"] = s["done"] | finish


def traverse(scene: SceneArrays, orig: torch.Tensor, direction: torch.Tensor, *, max_leaf: int = 8,
             with_steps: bool = False, **_):
    """Closest hits of R rays, orig and direction f32[R, 3] on the scene's
    device. max_leaf: the static bound on a leaf's triangles
    (FlatBVH.max_leaf_size; a larger leaf is cut short, so the builder must
    keep to it). Returns (t f32[R], hit i32[R]) in original triangle ids,
    (1e30, -1) on a miss, and with with_steps the number of lockstep steps
    until every lane was done (a multiple of CHECK_EVERY)."""
    r, dev = orig.shape[0], orig.device
    out_t = torch.full((r,), BIG, device=dev)
    out_hit = torch.full((r,), -1, dtype=torch.int64, device=dev)
    lane_ids = torch.arange(r, device=dev)
    s = dict(node=torch.zeros(r, dtype=torch.int64, device=dev), sp=torch.zeros(r, dtype=torch.int64, device=dev),
             stack=torch.zeros((r, STACK_DEPTH), dtype=torch.int64, device=dev), t=out_t.clone(),
             hit=out_hit.clone(), done=torch.zeros(r, dtype=torch.bool, device=dev))
    inv_dir = safe_inv_dir(direction)
    steps = 0
    while lane_ids.numel():
        for _ in range(CHECK_EVERY):
            _step(scene, s, orig, direction, inv_dir, max_leaf)
        steps += CHECK_EVERY
        live = ~s["done"]
        n_live = int(live.sum())
        if n_live <= lane_ids.numel() // 2:  # keep the walking lanes only
            out_t[lane_ids], out_hit[lane_ids] = s["t"], s["hit"]
            keep = live.nonzero().squeeze(1)
            lane_ids, orig, direction, inv_dir = lane_ids[keep], orig[keep], direction[keep], inv_dir[keep]
            s = {name: v[keep] for name, v in s.items()}
    hit = torch.where(out_hit >= 0, scene.tri_idx[out_hit.clamp_min(0)], -1)
    return (out_t, hit, steps) if with_steps else (out_t, hit)
