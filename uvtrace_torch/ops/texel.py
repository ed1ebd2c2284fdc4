"""Texel-resolution dose maps: sub-triangle accumulation (uvtrace/ops/texel.py).

Every triangle gets a k_t x k_t grid of barycentric cells, k_t chosen so a
cell's area is about (1/density)^2 m^2 and capped so the whole atlas fits the
slot budget. Barycentric cells are equal-area, so a cell's area is exactly
tri_area / k_t^2 and the count -> dose conversion stays exact. A hit (tri, u,
v) lands in slot base_t + iy * k_t + ix, where (ix, iy) is the cell of (u, v)
after folding u + v > 1 onto the lower triangle. The trace kernels return (t,
id) only, so barycentrics are recomputed from the hit point.

The atlas is built on the host (numpy); everything else runs on the tensors
of the atlas's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TexelAtlas(NamedTuple):
    base: torch.Tensor  # i32[T] first slot of each triangle
    k: torch.Tensor  # i32[T] grid side per triangle
    n_slots: int  # total texel count
    cell_area: torch.Tensor  # f32[T] = tri_area / k^2


def build_atlas(areas: np.ndarray, density: float = 16.0, max_slots: int = 1 << 22,
                device="cpu") -> TexelAtlas:
    """Allocate texel grids: k_t ~ sqrt(area) * density, at least 1, capped
    so sum(k^2) <= max_slots (scaled down uniformly, iterated: the k >= 1
    floor means a single pass can land above the cap when many triangles
    clamp). A budget below the triangle count raises ValueError."""
    areas = np.asarray(areas, np.float64)
    if areas.shape[0] > max_slots:
        raise ValueError(
            f"texel_max_slots={max_slots} is below the triangle count "
            f"({areas.shape[0]}): every triangle needs at least one texel — "
            "raise the budget or use per-triangle accumulation"
        )
    k = np.maximum(1, np.ceil(np.sqrt(np.maximum(areas, 0.0)) * density)).astype(np.int64)
    while int((k**2).sum()) > max_slots:
        scale = np.sqrt(max_slots / (k**2).sum())
        k_new = np.maximum(1, np.floor(k * scale)).astype(np.int64)
        if (k_new == k).all():  # all clamped at 1 or floor made no progress
            k_new = np.maximum(1, k - 1)
        k = k_new
    base = np.concatenate([[0], np.cumsum(k**2)[:-1]]).astype(np.int64)
    n_slots = int((k**2).sum())
    cell_area = (areas / (k**2)).astype(np.float32)
    return TexelAtlas(
        base=torch.from_numpy(base.astype(np.int32)).to(device),
        k=torch.from_numpy(k.astype(np.int32)).to(device),
        n_slots=n_slots,
        cell_area=torch.from_numpy(cell_area).to(device),
    )


def barycentrics(orig, direction, t_hit, v0, e1, e2):
    """(u, v) of the hit points p = o + t d with respect to the triangles
    (v0, e1, e2): the least-squares solve of p - v0 = u e1 + v e2 through
    the 2x2 Gram system, its determinant clamped at 1e-20."""
    p = orig + t_hit[..., None] * direction
    w = p - v0
    a = (e1 * e1).sum(-1)
    b = (e1 * e2).sum(-1)
    c = (e2 * e2).sum(-1)
    d1 = (w * e1).sum(-1)
    d2 = (w * e2).sum(-1)
    det = torch.clamp_min(a * c - b * b, 1e-20)
    u = (c * d1 - b * d2) / det
    v = (a * d2 - b * d1) / det
    return u, v


def texel_ids(atlas: TexelAtlas, hit_ids, u, v):
    """i32 atlas slot of each hit, -1 for a miss. hit_ids index atlas.base
    and atlas.k (triangle ids, or padded slots with an expanded atlas)."""
    safe = hit_ids.clamp_min(0).long()
    k_i = atlas.k[safe]
    k = k_i.to(torch.float32)
    uu = u.clamp(0.0, 1.0)
    vv = v.clamp(0.0, 1.0)
    # fold the upper half (u + v > 1) onto the lower triangle (equal-area pairing)
    over = uu + vv > 1.0
    uu = torch.where(over, 1.0 - uu, uu)
    vv = torch.where(over, 1.0 - vv, vv)
    ix = torch.minimum((uu * k).to(torch.int32), k_i - 1)
    iy = torch.minimum((vv * k).to(torch.int32), k_i - 1)
    slot = atlas.base[safe] + iy * k_i + ix
    return torch.where(hit_ids >= 0, slot, -1)


def texel_dose(atlas: TexelAtlas, texel_counts, photons_per_light, scaled_power):
    """Per-texel dose with the reference's unit rule (cl/shade.cl:39) and the
    exact cell area."""
    return (float(scaled_power) * texel_counts.to(torch.float32)) / (
        slot_areas(atlas) * float(photons_per_light))


def slot_areas(atlas: TexelAtlas) -> torch.Tensor:
    """f32[n_slots] cell areas (each triangle's value repeated k^2 times)."""
    return atlas.cell_area[slot_triangles(atlas).long()]


def slot_triangles(atlas: TexelAtlas) -> torch.Tensor:
    """i32[n_slots] owning triangle of every slot."""
    slots = torch.arange(atlas.n_slots, dtype=torch.int32, device=atlas.base.device)
    return (torch.searchsorted(atlas.base, slots, right=True) - 1).to(torch.int32)
