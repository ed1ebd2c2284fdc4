"""Flat SoA BVH representation (numpy copy of uvtrace/bvh/types.py, kept
equal to it by tests/test_torch_host.py).

Same information content as the reference's 32-byte `BVHNode`
(bvh.h:11-21: aabbMin, leftFirst, aabbMax, triCount) plus the `triIdx`
permutation — but stored as separate flat arrays, the layout TPU gathers and
Pallas block DMA want. Internal nodes have tri_count == 0 and children at
(left_first, left_first+1); leaves have tri_count > 0 triangles starting at
tri_idx[left_first].

`sorted_tris` holds the triangle vertices permuted into leaf order so a leaf's
triangles are contiguous in memory — traversal intersects sorted triangle j
and maps back to the original id with `tri_idx[j]` (or accumulates in sorted
space and permutes the T-sized count vector once).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray  # float32[N,3]
    node_max: np.ndarray  # float32[N,3]
    left_first: np.ndarray  # int32[N]
    tri_count: np.ndarray  # int32[N]
    tri_idx: np.ndarray  # int32[T] — sorted position -> original triangle id
    sorted_tris: np.ndarray  # float32[T,3,3] — vertices permuted to leaf order

    @property
    def n_nodes(self) -> int:
        return int(self.node_min.shape[0])

    @property
    def n_tris(self) -> int:
        return int(self.tri_idx.shape[0])

    @property
    def max_leaf_size(self) -> int:
        return int(self.tri_count.max()) if self.tri_count.size else 0

    @property
    def max_depth(self) -> int:
        best = 0
        # iterative DFS from root
        stack = [(0, 1)]
        while stack:
            node, d = stack.pop()
            best = max(best, d)
            if self.tri_count[node] == 0:
                stack.append((int(self.left_first[node]), d + 1))
                stack.append((int(self.left_first[node]) + 1, d + 1))
        return best

    def validate(self, tris: np.ndarray | None = None):
        """Structural sanity checks: every triangle in exactly one leaf;
        children inside parent bounds; leaf ranges disjoint and complete."""
        seen = np.zeros(self.n_tris, dtype=bool)
        stack = [0]
        while stack:
            n = stack.pop()
            if self.tri_count[n] > 0:
                lo = int(self.left_first[n])
                hi = lo + int(self.tri_count[n])
                ids = self.tri_idx[lo:hi]
                assert not seen[ids].any(), "triangle in two leaves"
                seen[ids] = True
            else:
                c = int(self.left_first[n])
                assert 0 < c < self.n_nodes - 1
                for child in (c, c + 1):
                    assert (self.node_min[child] >= self.node_min[n] - 1e-4).all()
                    assert (self.node_max[child] <= self.node_max[n] + 1e-4).all()
                stack.extend((c, c + 1))
        assert seen.all(), "triangle not referenced by any leaf"
        if tris is not None:
            np.testing.assert_allclose(self.sorted_tris, tris[self.tri_idx])
