"""Triangle clustering for the TPU two-phase traversal.

Numpy copy of uvtrace/ops/cluster.py, kept equal to it by tests/test_torch_host.py.

The reference's per-ray BVH descent (cl/extend.cl:40-81) is pointer chasing —
the worst possible shape for a vector machine. The TPU-native formulation
(SURVEY.md §7 "hard parts" #1) replaces it with:

  phase 1 (cull):      dense ray-packet x cluster-AABB tests — regular
                       vectorized compute, no gathers;
  phase 2 (intersect): for each packet, intersect only the triangles of the
                       nearest overlapped clusters — contiguous block reads.

This module builds the clustered scene representation on the host: the SAH
builder's subdivision is reused, but splitting stops as soon as a node holds
<= cluster_size triangles, so leaves ("clusters") are spatially tight blocks
of ~cluster_size triangles, padded to exactly cluster_size with degenerate
triangles (zero normal => Möller–Trumbore rejects them, a = 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from uvtrace_torch.bvh.builder import BINS, _sah_best_split


@dataclasses.dataclass
class ClusteredScene:
    """Flat padded clusters.

    tris: float32[L, C, 3, 3] — cluster triangles, padded with degenerates.
    box_min/box_max: float32[L, 3] — cluster AABBs (over real tris only).
    tri_idx: int32[L, C] — original triangle id per slot, -1 for padding.
    """

    tris: np.ndarray
    box_min: np.ndarray
    box_max: np.ndarray
    tri_idx: np.ndarray

    @property
    def n_clusters(self) -> int:
        return int(self.tris.shape[0])

    @property
    def cluster_size(self) -> int:
        return int(self.tris.shape[1])

    def validate(self, tris: np.ndarray):
        ids = self.tri_idx[self.tri_idx >= 0]
        assert len(ids) == len(tris)
        assert len(np.unique(ids)) == len(tris), "triangle in two clusters"
        for l in range(self.n_clusters):
            real = self.tri_idx[l] >= 0
            if real.any():
                v = self.tris[l][real].reshape(-1, 3)
                assert (v.min(axis=0) >= self.box_min[l] - 1e-4).all()
                assert (v.max(axis=0) <= self.box_max[l] + 1e-4).all()


def build_clusters(tris: np.ndarray, cluster_size: int = 128) -> ClusteredScene:
    """Partition triangles into spatially tight clusters of <= cluster_size.

    Splitting uses the same binned SAH as the BVH builder but *always* splits
    while a node holds more than cluster_size triangles (median fallback when
    SAH cannot split), and *never* splits below it.
    """
    tris = np.ascontiguousarray(tris, dtype=np.float32)
    t_count = tris.shape[0]
    centroids = tris.mean(axis=1).astype(np.float64)
    verts_min = tris.min(axis=1).astype(np.float64)
    verts_max = tris.max(axis=1).astype(np.float64)

    clusters: list[np.ndarray] = []
    stack = [np.arange(t_count, dtype=np.int64)] if t_count else []
    while stack:
        ids = stack.pop()
        if len(ids) <= cluster_size:
            clusters.append(ids)
            continue
        c = centroids[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        axis, split_pos, _cost = _sah_best_split(cmin, cmax, c, verts_min[ids], verts_max[ids])
        go_left = None
        if axis >= 0:
            scale = BINS / (cmax[axis] - cmin[axis])
            bin_idx = np.minimum(BINS - 1, ((c[:, axis] - cmin[axis]) * scale).astype(np.int32))
            go_left = bin_idx < split_pos
            if not go_left.any() or go_left.all():
                go_left = None
        if go_left is None:
            # median fallback on the widest centroid axis
            axis = int(np.argmax(cmax - cmin))
            order = np.argsort(c[:, axis], kind="stable")
            go_left = np.zeros(len(ids), dtype=bool)
            go_left[order[: len(ids) // 2]] = True
        stack.append(ids[go_left])
        stack.append(ids[~go_left])

    l_count = max(1, len(clusters))
    out_tris = np.zeros((l_count, cluster_size, 3, 3), np.float32)
    out_idx = np.full((l_count, cluster_size), -1, np.int32)
    box_min = np.full((l_count, 3), np.float32(1e30))
    box_max = np.full((l_count, 3), np.float32(-1e30))
    for l, ids in enumerate(clusters):
        k = len(ids)
        out_tris[l, :k] = tris[ids]
        out_idx[l, :k] = ids
        v = tris[ids].reshape(-1, 3)
        box_min[l] = v.min(axis=0)
        box_max[l] = v.max(axis=0)
    return ClusteredScene(
        tris=out_tris, box_min=box_min, box_max=box_max, tri_idx=out_idx
    )
