"""Ray-triangle and ray-AABB intersection primitives and the brute-force
closest-hit oracle (uvtrace/ops/intersect.py).

Möller–Trumbore `IntersectTri` (cl/extend.cl:6-27: parallel reject
|det| < 1e-5, near clip t > 1e-4) and the slab test `IntersectAABB`
(:29-38), broadcast over leading batch dims. Each product and sum is its own
f32 tensor op, in the JAX package's order (cross products as jnp.cross takes
them, 3-term dot products left to right), so no step is contracted or
reassociated. `brute_force_closest_hit` is the oracle of the gen-1 kernel's
plain version (ops/traverse_pallas.py).
"""

from __future__ import annotations

import torch

BIG = 1e30  # miss distance (f32 rounding in tensors)
DET_EPS = 1e-5
T_MIN = 1e-4


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last dim, in jnp.cross's component formulas."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def intersect_tri(orig, direction, v0, v1, v2) -> torch.Tensor:
    """Möller–Trumbore (cl/extend.cl:6-27), broadcasting over leading dims.
    Returns the f32 hit distance, 1e30 on a miss: u in [0, 1], v >= 0,
    u + v <= 1, t > 1e-4."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    h = _cross(direction, edge2)
    a = _dot(edge1, h)
    f = torch.where(a == 0, 0.0, 1.0 / torch.where(a == 0, 1.0, a))
    s = orig - v0
    u = f * _dot(s, h)
    q = _cross(s, edge1)
    v = f * _dot(direction, q)
    t = f * _dot(edge2, q)
    valid = (a.abs() >= DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(valid, t, BIG)


def safe_inv_dir(direction: torch.Tensor) -> torch.Tensor:
    """1/direction with zero components replaced by 1/1e-30 = 1e30, which
    keeps the slab test free of 0 * inf = NaN."""
    return 1.0 / torch.where(direction == 0.0, 1e-30, direction)


def intersect_aabb(orig, inv_dir, box_min, box_max, t_best) -> torch.Tensor:
    """Slab test (cl/extend.cl:29-38). Returns the entry distance tmin, or
    1e30 when the box is missed or lies beyond t_best. torch.minimum and
    maximum propagate NaN, as jnp's do."""
    t1 = (box_min - orig) * inv_dir
    t2 = (box_max - orig) * inv_dir
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = (tmax >= tmin) & (tmin < t_best) & (tmax > 0)
    return torch.where(hit, tmin, BIG)


def brute_force_closest_hit(rays_orig, rays_dir, tris, chunk: int = 2048):
    """Closest hit over all triangles, no acceleration structure: the
    correctness oracle. tris: f32[T, 3, 3]. Returns (t f32[N], tri_id
    i32[N]), (1e30, -1) on a miss; on equal t the lowest triangle id."""
    v0, v1, v2 = tris[None, :, 0], tris[None, :, 1], tris[None, :, 2]
    ts, ids = [], []
    for r0 in range(0, rays_orig.shape[0], chunk):
        t = intersect_tri(rays_orig[r0:r0 + chunk, None], rays_dir[r0:r0 + chunk, None], v0, v1, v2)
        tmin, tid = t.min(1)
        ts.append(tmin)
        ids.append(torch.where(tmin >= BIG, -1, tid).to(torch.int32))
    return torch.cat(ts), torch.cat(ids)
