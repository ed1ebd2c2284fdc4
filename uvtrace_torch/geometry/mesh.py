"""Triangle scene representation as flat SoA arrays (numpy copy of
uvtrace/geometry/mesh.py).

Role of the reference's ``Mesh`` (mesh.h:15-34, mesh.cpp:5-136): flat
per-triangle vertex arrays + floor-height auto-detection. Here the scene is a
plain dataclass of numpy arrays laid out for TPU-friendly consumption
(``(T,3,3)`` float32 vertices; derived areas/centroids computed vectorized).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """A flat triangle soup.

    Attributes:
      tris: float32[T, 3, 3] — per-triangle vertices (v0, v1, v2), xyz.
      uvs: optional float32[T, 3, 2] — per-corner texture coordinates.
      floor_height: float — auto-detected floor y (see ``detect_floor_height``).
      name: scene identifier.
    """

    tris: np.ndarray
    uvs: Optional[np.ndarray] = None
    floor_height: float = 0.0
    name: str = "mesh"
    texture: Optional[np.ndarray] = None  # uint8[H,W,3] base-color scan photo

    def __post_init__(self):
        self.tris = np.ascontiguousarray(self.tris, dtype=np.float32)
        assert self.tris.ndim == 3 and self.tris.shape[1:] == (3, 3), self.tris.shape
        if self.uvs is not None:
            self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)

    @property
    def triangle_count(self) -> int:
        return int(self.tris.shape[0])

    @property
    def centroids(self) -> np.ndarray:
        """float32[T,3] triangle centroids ((v0+v1+v2) * 0.3333, bvh.cpp:23)."""
        # The reference multiplies by literal 0.3333f, not 1/3; the BVH only
        # uses centroids for partitioning so the small bias is irrelevant —
        # we use exact mean here.
        return self.tris.mean(axis=1, dtype=np.float32)

    @property
    def areas(self) -> np.ndarray:
        """float32[T] triangle areas: |cross(v0-v1, v0-v2)| / 2 (shade.cl:31-36)."""
        v0, v1, v2 = self.tris[:, 0], self.tris[:, 1], self.tris[:, 2]
        c = np.cross(v0 - v1, v0 - v2)
        return (0.5 * np.linalg.norm(c, axis=1)).astype(np.float32)

    def flat_texture_colors(self) -> np.ndarray:
        """float32[T,3] per-triangle base color sampled from the scan texture
        at the triangle's UV centroid — the headless stand-in for the
        reference's textured 'photo scan' view (simpleshader + mesh texture,
        myapp.cpp:186-194). White when the scene has no texture."""
        t = self.triangle_count
        if self.texture is None or self.uvs is None:
            return np.ones((t, 3), np.float32)
        h, w = self.texture.shape[:2]
        uv = self.uvs.mean(axis=1)  # [T,2]
        x = np.clip(np.floor((uv[:, 0] % 1.0) * w), 0, w - 1).astype(np.int64)
        y = np.clip(np.floor((uv[:, 1] % 1.0) * h), 0, h - 1).astype(np.int64)
        return self.texture[y, x].astype(np.float32) / 255.0

    @property
    def normals(self) -> np.ndarray:
        """float32[T,3] unit normals (cross(e1,e2), right-hand winding)."""
        v0, v1, v2 = self.tris[:, 0], self.tris[:, 1], self.tris[:, 2]
        n = np.cross(v1 - v0, v2 - v0)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        return (n / np.maximum(norm, 1e-20)).astype(np.float32)

    @property
    def aabb(self) -> tuple[np.ndarray, np.ndarray]:
        lo = self.tris.reshape(-1, 3).min(axis=0)
        hi = self.tris.reshape(-1, 3).max(axis=0)
        return lo, hi


def detect_floor_height(tris: np.ndarray, bins: int = 48) -> float:
    """Histogram-based floor-height detection.

    Reference semantics (mesh.cpp:100-136): histogram the y coordinate of every
    vertex into 48 bins over [min_y, 0] (the reference assumes the floor is at
    or below y=0: ``maxVal = 0``); the floor is the center of the densest bin.
    Vertices above y=0 and exactly on bin edges are not counted (the reference
    uses strict inequalities on both edges).
    """
    ys = tris.reshape(-1, 3)[:, 1].astype(np.float32)
    max_val = np.float32(0.0)
    min_val = np.minimum(np.float32(0.0), ys.min() if ys.size else np.float32(0.0))
    rng = max_val - min_val
    if rng <= 0:
        return 0.0
    edges = np.arange(bins + 1, dtype=np.float64) * (float(rng) / bins) + float(min_val)
    # strict inequalities: drop values equal to any edge
    hist = np.zeros(bins, dtype=np.int64)
    for j in range(bins):
        hist[j] = np.count_nonzero((ys > edges[j]) & (ys < edges[j + 1]))
    max_index = int(np.argmax(hist))
    return float((max_index + 0.5) * (float(rng) / bins) + float(min_val))
