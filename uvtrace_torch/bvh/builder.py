"""Binned-SAH split search (numpy copy of uvtrace/bvh/builder.py's
`BINS` and `_sah_best_split`, the part the cluster builder needs).

Same algorithm as the reference builder (bvh.cpp:13-179): 8-bin binned SAH
over the centroid extent of a node, split plane chosen to minimize
left_count*left_area + right_count*right_area.
"""

from __future__ import annotations

import numpy as np

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
