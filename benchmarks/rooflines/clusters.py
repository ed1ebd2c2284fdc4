"""Clusters of at most 128 triangles, built on the host from the triangles
alone: a frozen copy of the binned-SAH cluster builder (8 bins a node, a
median split where SAH finds none), so that the benchmark's work counts and
its reference's traversal do not move when the program's builder does.

A cluster is a leaf of the split: nodes are split while they hold more than
`cluster_size` triangles and never below that.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BINS = 8


class Clusters(NamedTuple):
    tri_idx: np.ndarray  # int64[L, C] triangle ids, -1 for padding
    box_min: np.ndarray  # f32[L, 3] over the cluster's real triangles
    box_max: np.ndarray  # f32[L, 3]
    real: np.ndarray  # int64[L] real triangles a cluster

    @property
    def n_clusters(self) -> int:
        return int(self.tri_idx.shape[0])


def _best_split(cmin, cmax, centroids, vmin, vmax):
    """(axis, split bin, cost) of the cheapest of 3 axes x 7 planes; axis -1
    where no axis can be split."""
    best = (np.inf, -1, -1)
    for axis in range(3):
        lo, hi = cmin[axis], cmax[axis]
        if lo == hi:
            continue
        b = np.minimum(BINS - 1, ((centroids[:, axis] - lo) * (BINS / (hi - lo))).astype(np.int32))
        counts = np.bincount(b, minlength=BINS)
        bmin = np.full((BINS, 3), np.inf)
        bmax = np.full((BINS, 3), -np.inf)
        np.minimum.at(bmin, b, vmin)
        np.maximum.at(bmax, b, vmax)
        lmin = np.minimum.accumulate(bmin, axis=0)[:-1]
        lmax = np.maximum.accumulate(bmax, axis=0)[:-1]
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1][1:]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1][1:]
        lc = np.cumsum(counts)[:-1]
        rc = np.cumsum(counts[::-1])[::-1][1:]

        def half_area(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        cost = np.where((lc > 0) & (rc > 0), lc * half_area(lmin, lmax) + rc * half_area(rmin, rmax), np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best[0]:
            best = (float(cost[i]), axis, i + 1)
    return best[1], best[2], best[0]


def build_clusters(tris: np.ndarray, cluster_size: int = 128) -> Clusters:
    tris = np.ascontiguousarray(tris, np.float32)
    centroids = tris.mean(axis=1).astype(np.float64)
    vmin = tris.min(axis=1).astype(np.float64)
    vmax = tris.max(axis=1).astype(np.float64)
    leaves = []
    stack = [np.arange(tris.shape[0], dtype=np.int64)] if tris.shape[0] else []
    while stack:
        ids = stack.pop()
        if len(ids) <= cluster_size:
            leaves.append(ids)
            continue
        c = centroids[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        axis, split, _ = _best_split(cmin, cmax, c, vmin[ids], vmax[ids])
        left = None
        if axis >= 0:
            b = np.minimum(BINS - 1, ((c[:, axis] - cmin[axis]) * (BINS / (cmax[axis] - cmin[axis]))).astype(np.int32))
            left = b < split
            if left.all() or not left.any():
                left = None
        if left is None:
            axis = int(np.argmax(cmax - cmin))
            left = np.zeros(len(ids), bool)
            left[np.argsort(c[:, axis], kind="stable")[: len(ids) // 2]] = True
        stack.append(ids[left])
        stack.append(ids[~left])
    n = max(1, len(leaves))
    tri_idx = np.full((n, cluster_size), -1, np.int64)
    box_min = np.zeros((n, 3), np.float32)
    box_max = np.zeros((n, 3), np.float32)
    real = np.zeros(n, np.int64)
    for i, ids in enumerate(leaves):
        tri_idx[i, : len(ids)] = ids
        v = tris[ids].reshape(-1, 3)
        box_min[i], box_max[i] = v.min(axis=0), v.max(axis=0)
        real[i] = len(ids)
    return Clusters(tri_idx, box_min, box_max, real)
