"""The gen-1 packet DFS over a top tree of cluster AABBs (TPU kernel B3).

Port of uvtrace/ops/traverse_pallas.py (`_traverse_pallas_padded`, the TPU
kernel `_kernel` + `_mt_columns`, behind `traverse_pallas`). It traces any
rays, coherent or not, with no candidate budget. Each packet of 1024
consecutive rays walks a binned-SAH tree over the 128-triangle clusters with
one shared stack:

  - at an inner node both children are slab-tested against every ray; a
    child is pushed when some ray enters it before both the packet bound and
    its own best t; the far child (by the least entry over the rays that hit
    it) is pushed first, so the near one is popped next;
  - at a leaf, a column of 8 consecutive rays (8g..8g+7, one TPU lane) is
    active when one of its rays enters the cluster's box before its best t;
    every ray of an active column runs Möller–Trumbore against the cluster's
    128 triangles, takes the lowest lane on equal t, and keeps it when it is
    strictly nearer than its best so far (the first visited cluster wins a
    tie between clusters); the packet bound becomes the max of the best t.
    (A ray's own best t is never above that bound, so the CUDA kernel leaves
    the bound out; and it tests a cluster's triangles only up to
    `PallasScene.tri_used`, since the all-zero padding behind hits nothing.)

Two versions, with the same visit order and tie rules:
  - `traverse_pallas` launches the CUDA kernel csrc/traverse_pallas.cu for
    CUDA tensors and runs the plain version for CPU tensors;
  - `traverse_pallas_reference` is the plain PyTorch version: the same DFS
    with all packets of the batch in lockstep, one node per packet per step.
Both compute each f32 product and sum in the JAX kernel's order, without
multiply-add contraction, so t, triangle ids and the leaf statistics agree
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uvtrace_torch.bvh.builder import build_bvh
from uvtrace_torch.device import resolve
from uvtrace_torch.ops.cluster import ClusteredScene

BIG = 1e30  # miss distance (f32 rounding in tensors)
PACKET = 1024
STACK_DEPTH = 128
TRI_ROWS = 16  # v0(3), e1(3), e2(3), padding (the JAX tile layout)
LANES = 128  # triangles per cluster
_COLUMN = 8  # rays per column: one TPU lane of an (8, 128) ray tile
_MT_COLUMNS = 8192  # active columns per Möller–Trumbore batch of the plain version


class PallasScene(NamedTuple):
    """Scene arrays on one device, in the JAX PallasScene's layout."""

    node_box: torch.Tensor  # f32[Nn*8] minx, miny, minz, maxx, maxy, maxz, pad, pad
    node_meta: torch.Tensor  # i32[Nn*2] (left child | cluster id, is_leaf)
    tri: torch.Tensor  # f32[L, 16, 128] rows v0.xyz, e1.xyz, e2.xyz; lanes = the cluster's triangles
    tri_idx_flat: torch.Tensor  # i32[L*128] slot -> original triangle (-1 for padding)
    tri_used: torch.Tensor  # i32[L] slots in use: one past the cluster's last triangle that is not all zeros
    box_min: torch.Tensor  # f32[L, 3] cluster AABBs
    box_max: torch.Tensor  # f32[L, 3]
    depth: int  # levels of the top tree; the kernel's stack holds STACK_DEPTH

    @property
    def n_clusters(self) -> int:
        return int(self.tri.shape[0])


def cluster_top_tree(box_min: np.ndarray, box_max: np.ndarray):
    """The top tree over cluster AABBs f32[L, 3] that the tree kernels walk
    (B3 here, B2 in ops/traverse_mxu.py), on the host: the binned-SAH
    builder's with each cluster's AABB as a degenerate triangle (min, max,
    centre), one cluster per leaf (uvtrace/ops/traverse_pallas.py:61-98).
    Returns (node_box f32[Nn, 8] min.xyz, max.xyz, 2 pads; node_meta
    i32[Nn, 2] (left child | cluster id, is_leaf); depth in levels)."""
    pseudo = np.stack([box_min, box_max, 0.5 * (box_min + box_max)], axis=1).astype(np.float32)
    top = build_bvh(pseudo, max_leaf_size=1)
    node_box = np.zeros((top.n_nodes, 8), np.float32)
    node_box[:, 0:3] = top.node_min
    node_box[:, 3:6] = top.node_max
    node_meta = np.zeros((top.n_nodes, 2), np.int32)
    leaf = top.tri_count > 0
    node_meta[:, 1] = leaf
    node_meta[leaf, 0] = top.tri_idx[top.left_first[leaf]]  # the leaf's cluster
    node_meta[~leaf, 0] = top.left_first[~leaf]  # left child; the right one follows it
    return node_box, node_meta, top.max_depth


def used_slots(nonzero: np.ndarray) -> np.ndarray:
    """i32[L] slots in use per cluster, from bool[L, C] "this slot's triangle
    has a non-zero value": one past the last such slot (0 for none). A
    triangle whose values are all zeros, as the padding's are, hits no ray
    (its determinant is 0), so the kernels test a cluster's slots only up to
    here."""
    c_sz = nonzero.shape[1]
    return np.where(nonzero.any(1), c_sz - np.argmax(nonzero[:, ::-1], axis=1), 0).astype(np.int32)


def build_pallas_scene(cs: ClusteredScene, device="cuda") -> PallasScene:
    """Top tree over the cluster AABBs (`cluster_top_tree`) plus lane-major
    triangle tiles, on the host (uvtrace/ops/traverse_pallas.py:61-98), then
    on `device` ("cuda" raises when torch sees no card; "cpu" gives the
    plain version's scene). Raises when the tree is deeper than the
    kernel's stack."""
    device = resolve(device)
    if cs.cluster_size != LANES:
        raise ValueError(f"the gen-1 kernel takes clusters of {LANES} triangles, got {cs.cluster_size}")
    node_box, node_meta, depth = cluster_top_tree(cs.box_min, cs.box_max)
    if depth > STACK_DEPTH:
        # the DFS holds at most one pending sibling per level plus the node
        raise ValueError(f"top tree of {cs.n_clusters} clusters is {depth} levels deep; the kernel's "
                         f"stack holds {STACK_DEPTH}")
    tri = np.zeros((cs.n_clusters, TRI_ROWS, LANES), np.float32)
    v0 = cs.tris[:, :, 0]
    tri[:, 0:3] = np.moveaxis(v0, 2, 1)
    tri[:, 3:6] = np.moveaxis(cs.tris[:, :, 1] - v0, 2, 1)
    tri[:, 6:9] = np.moveaxis(cs.tris[:, :, 2] - v0, 2, 1)
    to = lambda a: torch.from_numpy(np.array(a, order="C")).to(device)  # noqa: E731  (a writable copy)
    return PallasScene(node_box=to(node_box.reshape(-1)), node_meta=to(node_meta.reshape(-1)), tri=to(tri),
                       tri_idx_flat=to(cs.tri_idx.reshape(-1)), tri_used=to(used_slots((tri != 0).any(1))),
                       box_min=to(cs.box_min),
                       box_max=to(cs.box_max), depth=depth)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def _slab(box: torch.Tensor, o: torch.Tensor, inv: torch.Tensor):
    """Slab test of boxes f32[k, 8] against rays f32[k, m, 3]
    (uvtrace/ops/traverse_pallas.py:172-181). Returns (tmin, hit) [k, m].
    torch.minimum/maximum propagate NaN as jnp's do: a NaN axis is a miss."""
    tmin = torch.full(o.shape[:2], -BIG, device=o.device)
    tmax = torch.full_like(tmin, BIG)
    for ax in range(3):
        t1 = (box[:, None, ax] - o[..., ax]) * inv[..., ax]
        t2 = (box[:, None, ax + 3] - o[..., ax]) * inv[..., ax]
        tmin = torch.maximum(tmin, torch.minimum(t1, t2))
        tmax = torch.minimum(tmax, torch.maximum(t1, t2))
    return tmin, (tmax >= tmin) & (tmax > 0)


def _mt_columns(o: torch.Tensor, d: torch.Tensor, tile: torch.Tensor):
    """Möller–Trumbore of rays f32[k, 8, 3] against tiles f32[k, 16, 128],
    in the formulas and operation order of uvtrace/ops/traverse_pallas.py:
    126-148. Returns each ray's nearest t (1e30 on a miss) and its lowest
    lane among equal t, [k, 8] each."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tile[:, r, None, :] for r in range(9))
    cox, coy, coz = (o[..., c, None] for c in range(3))
    cdx, cdy, cdz = (d[..., c, None] for c in range(3))
    hx = cdy * e2z - cdz * e2y
    hy = cdz * e2x - cdx * e2z
    hz = cdx * e2y - cdy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / torch.where(a == 0.0, 1.0, a)
    sx = cox - v0x
    sy = coy - v0y
    sz = coz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (cdx * qx + cdy * qy + cdz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = (a.abs() >= 1e-5) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    t = torch.where(valid, t, BIG)
    col_t = t.amin(-1)
    lane = torch.arange(LANES, device=t.device)
    return col_t, torch.where(t == col_t[..., None], lane, LANES).amin(-1)


def traverse_pallas_reference(scene: PallasScene, orig: torch.Tensor, direction: torch.Tensor, *,
                              with_stats: bool = False, column_weight: torch.Tensor | None = None):
    """Plain PyTorch version of `traverse_pallas`: every packet runs the
    kernel's DFS, all packets in lockstep, one popped node per packet per
    step (a host loop that ends when every stack is empty). With
    column_weight i64[L], an active column of cluster c counts
    column_weight[c] in the second statistic instead of 1: with
    scene.tri_used, the triangles the active columns have to test."""
    r_count = orig.shape[0]
    if r_count % PACKET:
        raise ValueError(f"{r_count} rays is not a whole number of {PACKET}-ray packets")
    g = r_count // PACKET
    dev = orig.device
    o = orig.reshape(g, PACKET, 3)
    d = direction.reshape(g, PACKET, 3)
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    box = scene.node_box.view(-1, 8)
    meta = scene.node_meta.view(-1, 2).long()
    t_best = torch.full((g, PACKET), BIG, device=dev)
    slot = torch.full((g, PACKET), -1, dtype=torch.int64, device=dev)
    t_ub = torch.full((g,), BIG, device=dev)
    # two spare entries take the unconditional pushes above the top
    stack = torch.zeros((g, STACK_DEPTH + 2), dtype=torch.int64, device=dev)
    sp = torch.ones(g, dtype=torch.int64, device=dev)
    leaves = torch.zeros(g, dtype=torch.int64, device=dev)
    columns = torch.zeros(g, dtype=torch.int64, device=dev)
    rows = torch.arange(g, device=dev)
    ray_in_col = torch.arange(_COLUMN, device=dev)
    while True:
        live = sp > 0
        if not bool(live.any()):
            break
        node = stack[rows, (sp - 1).clamp_min(0)]
        sp = sp - live.long()
        is_leaf = meta[node, 1] == 1

        pk = torch.nonzero(live & is_leaf).flatten()  # packets at a leaf
        if pk.numel():
            tmin, hit = _slab(box[node[pk]], o[pk], inv[pk])
            act = hit & (tmin < t_best[pk])
            col = act.view(-1, PACKET // _COLUMN, _COLUMN).any(2)
            leaves[pk] += 1
            cid = meta[node[pk], 0]
            columns[pk] += col.sum(1) * (1 if column_weight is None else column_weight[cid])
            ci, cg = torch.nonzero(col, as_tuple=True)  # active (packet, column) pairs
            for k0 in range(0, ci.numel(), _MT_COLUMNS):
                p_sel, g_sel = ci[k0:k0 + _MT_COLUMNS], cg[k0:k0 + _MT_COLUMNS]
                ray = pk[p_sel, None] * PACKET + g_sel[:, None] * _COLUMN + ray_in_col  # [k, 8] flat rays
                col_t, col_arg = _mt_columns(orig[ray], direction[ray], scene.tri[cid[p_sel]])
                cur_t = t_best.view(-1)[ray]
                better = col_t < cur_t
                t_best.view(-1)[ray] = torch.where(better, col_t, cur_t)
                slot.view(-1)[ray] = torch.where(better, cid[p_sel, None] * LANES + col_arg, slot.view(-1)[ray])
            t_ub[pk] = t_best[pk].amax(1)

        pk = torch.nonzero(live & ~is_leaf).flatten()  # packets at an inner node
        if pk.numel():
            c1 = meta[node[pk], 0]
            c2 = c1 + 1
            tb, ub = t_best[pk], t_ub[pk, None]
            tmin1, m1 = _slab(box[c1], o[pk], inv[pk])
            tmin2, m2 = _slab(box[c2], o[pk], inv[pk])
            v1 = (m1 & (tmin1 < ub) & (tmin1 < tb)).any(1)
            v2 = (m2 & (tmin2 < ub) & (tmin2 < tb)).any(1)
            d1 = torch.where(m1, tmin1, BIG).amin(1)
            d2 = torch.where(m2, tmin2, BIG).amin(1)
            near_first = d1 <= d2  # the far child is pushed first, the near one on top
            first, second = torch.where(near_first, c2, c1), torch.where(near_first, c1, c2)
            v_first, v_second = torch.where(near_first, v2, v1), torch.where(near_first, v1, v2)
            s = sp[pk]
            stack[pk, s] = first
            s1 = s + v_first.long()
            stack[pk, s1] = second
            sp[pk] = s1 + v_second.long()

    t = t_best.reshape(-1)
    slot = slot.reshape(-1)
    hit = torch.where(slot >= 0, scene.tri_idx_flat[slot.clamp_min(0)], -1)
    hit = torch.where(t >= BIG, -1, hit).to(torch.int32)
    if with_stats:
        return t, hit, torch.stack([leaves, columns], 1).to(torch.int32)
    return t, hit


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


def traverse_pallas(scene: PallasScene, orig: torch.Tensor, direction: torch.Tensor, *,
                    with_stats: bool = False):
    """Closest hits of any rays through the gen-1 packet DFS (replaces the
    TPU kernel of uvtrace/ops/traverse_pallas.py:242), one block per packet
    of 1024 rays.

    orig, direction: f32[R, 3] on the scene's device, R a multiple of 1024.
    Returns (t f32[R], original triangle id i32[R][, stats i32[R/1024, 2]]),
    (1e30, -1) on a miss; stats are each packet's leaf visits and the active
    8-ray columns summed over them. Rays on the CPU run the plain version;
    CUDA rays run the kernel or raise."""
    dev = scene.tri.device
    r_count = orig.shape[0]
    if orig.device != dev or direction.device != dev:
        raise ValueError(f"rays on {orig.device}/{direction.device}, scene on {dev}")
    if r_count % PACKET:
        raise ValueError(f"{r_count} rays is not a whole number of {PACKET}-ray packets")
    if dev.type == "cpu":
        return traverse_pallas_reference(scene, orig, direction, with_stats=with_stats)
    if dev.type != "cuda":
        raise ValueError(f"traverse_pallas runs on cpu or cuda tensors, not {dev}")
    if scene.depth > STACK_DEPTH:
        raise ValueError(f"top tree of depth {scene.depth} exceeds the kernel's stack of {STACK_DEPTH}")
    from uvtrace_torch import _build

    g = r_count // PACKET
    n_nodes, l_count = scene.node_meta.shape[0] // 2, scene.n_clusters
    _build.check_tensor("scene.node_box", scene.node_box, torch.float32, (8 * n_nodes,), dev)
    _build.check_tensor("scene.node_meta", scene.node_meta, torch.int32, (2 * n_nodes,), dev)
    _build.check_tensor("scene.tri", scene.tri, torch.float32, (l_count, TRI_ROWS, LANES), dev)
    _build.check_tensor("scene.tri_idx_flat", scene.tri_idx_flat, torch.int32, (l_count * LANES,), dev)
    _build.check_tensor("scene.tri_used", scene.tri_used, torch.int32, (l_count,), dev)
    _build.check_tensor("orig", orig, torch.float32, (r_count, 3), dev)
    _build.check_tensor("direction", direction, torch.float32, (r_count, 3), dev)
    t = torch.empty(r_count, dtype=torch.float32, device=dev)
    hit = torch.empty(r_count, dtype=torch.int32, device=dev)
    stats = torch.empty((g, 2), dtype=torch.int32, device=dev) if with_stats else None
    if g:
        ptr = _build.ptr
        _build.launch("traverse_pallas_launch", dev, ptr(orig), ptr(direction), g, ptr(scene.node_box),
                      ptr(scene.node_meta), ptr(scene.tri), ptr(scene.tri_used), ptr(scene.tri_idx_flat), ptr(t),
                      ptr(hit), ptr(stats), rays=r_count)
    return (t, hit, stats) if with_stats else (t, hit)
