"""Binned-SAH BVH builder (numpy copy of uvtrace/bvh/builder.py, kept equal
to it by tests/test_torch_host.py).

Same algorithm and termination rule as the reference builder (bvh.cpp:13-179):
top-down subdivision, 8-bin binned SAH over the centroid extent of a node,
split plane chosen to minimize left_count*left_area + right_count*right_area,
split aborted when the SAH cost is not below the leaf cost. The cluster
builder (ops/cluster.py) reuses `_sah_best_split`; the gen-1 kernel's top tree
over cluster AABBs (ops/traverse_pallas.py) is `build_bvh` with one cluster per
leaf. Nodes are emitted in DFS order; `max_leaf_size` forces median splits of
bigger leaves.
"""

from __future__ import annotations

import numpy as np

from uvtrace_torch.bvh.types import FlatBVH

BINS = 8  # bvh.h:26


def _sah_best_split(cmin, cmax, centroids, verts_min, verts_max):
    """Best (axis, split_bin, cost) over 3 axes x 7 planes for one node.

    centroids: [n,3]; verts_min/verts_max: [n,3] per-triangle vertex AABBs.
    Returns (axis, split_pos, cost) with cost=inf if no axis is splittable.
    """
    best = (np.inf, -1, -1)
    for axis in range(3):
        lo, hi = cmin[axis], cmax[axis]
        if lo == hi:
            continue
        scale = BINS / (hi - lo)
        bin_idx = np.minimum(BINS - 1, ((centroids[:, axis] - lo) * scale).astype(np.int32))
        counts = np.bincount(bin_idx, minlength=BINS)
        bmin = np.full((BINS, 3), np.inf, dtype=np.float64)
        bmax = np.full((BINS, 3), -np.inf, dtype=np.float64)
        np.minimum.at(bmin, bin_idx, verts_min)
        np.maximum.at(bmax, bin_idx, verts_max)
        # prefix/suffix scans over bins -> plane areas
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        lcount = np.cumsum(counts)[:-1]
        rcount = np.cumsum(counts[::-1])[::-1][1:]

        def half_area(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        cost = np.where(
            (lcount > 0) & (rcount > 0),
            lcount * half_area(lmin, lmax) + rcount * half_area(rmin, rmax),
            np.inf,
        )
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (float(cost[i]), axis, i + 1)
    return best[1], best[2], best[0]


def build_bvh(tris: np.ndarray, max_leaf_size: int | None = None) -> FlatBVH:
    """Build a flat binned-SAH BVH over float32[T,3,3] triangles."""
    tris = np.ascontiguousarray(tris, dtype=np.float32)
    t_count = tris.shape[0]
    centroids = tris.mean(axis=1).astype(np.float64)
    verts_min = tris.min(axis=1).astype(np.float64)
    verts_max = tris.max(axis=1).astype(np.float64)

    tri_idx = np.arange(t_count, dtype=np.int32)
    node_min, node_max, left_first, tri_count = [], [], [], []

    def emit(lo_v, hi_v, lf, tc) -> int:
        node_min.append(lo_v)
        node_max.append(hi_v)
        left_first.append(lf)
        tri_count.append(tc)
        return len(node_min) - 1

    # stack entries: (node_id, start, count) — partition happens in tri_idx
    root_lo = verts_min.min(axis=0) if t_count else np.zeros(3)
    root_hi = verts_max.max(axis=0) if t_count else np.zeros(3)
    root = emit(root_lo, root_hi, 0, t_count)
    stack = [(root, 0, t_count)]

    while stack:
        node, start, count = stack.pop()
        ids = tri_idx[start : start + count]
        c = centroids[ids]
        vmin = verts_min[ids]
        vmax = verts_max[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)

        axis, split_pos, split_cost = _sah_best_split(cmin, cmax, c, vmin, vmax)
        ext = np.maximum(vmax.max(axis=0) - vmin.min(axis=0), 0.0)
        leaf_cost = (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]) * count

        forced = max_leaf_size is not None and count > max_leaf_size
        use_sah = axis >= 0 and split_cost < leaf_cost
        if not use_sah and not forced:
            continue  # stays a leaf (emitted with tri_count=count already)

        if use_sah:
            scale = BINS / (cmax[axis] - cmin[axis])
            bin_idx = np.minimum(BINS - 1, ((c[:, axis] - cmin[axis]) * scale).astype(np.int32))
            go_left = bin_idx < split_pos
            if not go_left.any() or go_left.all():
                if not forced:
                    continue
                use_sah = False
        if not use_sah:
            # forced median split on the widest centroid axis (bounded-leaf mode)
            axis = int(np.argmax(cmax - cmin))
            order = np.argsort(c[:, axis], kind="stable")
            half = count // 2
            go_left = np.zeros(count, dtype=bool)
            go_left[order[:half]] = True
            if half == 0 or half == count:
                continue

        left_ids = ids[go_left]
        right_ids = ids[~go_left]
        tri_idx[start : start + len(left_ids)] = left_ids
        tri_idx[start + len(left_ids) : start + count] = right_ids

        lmin, lmax = vmin[go_left].min(axis=0), vmax[go_left].max(axis=0)
        rmin, rmax = vmin[~go_left].min(axis=0), vmax[~go_left].max(axis=0)
        lchild = emit(lmin, lmax, start, len(left_ids))
        rchild = emit(rmin, rmax, start + len(left_ids), len(right_ids))
        # convert this node to an internal node
        left_first[node] = lchild
        tri_count[node] = 0
        stack.append((rchild, start + len(left_ids), len(right_ids)))
        stack.append((lchild, start, len(left_ids)))

    bvh = FlatBVH(
        node_min=np.asarray(node_min, dtype=np.float32),
        node_max=np.asarray(node_max, dtype=np.float32),
        left_first=np.asarray(left_first, dtype=np.int32),
        tri_count=np.asarray(tri_count, dtype=np.int32),
        tri_idx=tri_idx,
        sorted_tris=tris[tri_idx],
    )
    return bvh


def single_leaf_bvh(tris: np.ndarray) -> FlatBVH:
    """A 1-node BVH holding all triangles — what the reference swaps in for
    power calibration (raytracer.cpp:173-190)."""
    tris = np.ascontiguousarray(tris, dtype=np.float32)
    t = tris.shape[0]
    return FlatBVH(
        node_min=tris.reshape(-1, 3).min(axis=0)[None].astype(np.float32),
        node_max=tris.reshape(-1, 3).max(axis=0)[None].astype(np.float32),
        left_first=np.zeros(1, np.int32),
        tri_count=np.full(1, t, np.int32),
        tri_idx=np.arange(t, dtype=np.int32),
        sorted_tris=tris.copy(),
    )
