"""Texel-resolution dose in plain PyTorch: the atlas of barycentric cells,
each hit's cell, one iteration's texel histogram, and the top-down probe
grid read at texel resolution.

The atlas gives triangle i a k_i x k_i grid of cells, k_i = ceil(sqrt(area_i)
x density) (at least 1); while the grids hold more than `max_slots` cells
all of them shrink by the factor sqrt(max_slots / cells), floored (at least
1), or by one where flooring changes nothing. Its slots follow the triangle
order, row by row. The unit rule divides a cell's count by the triangle's
area over k^2, as the configuration states it. That is not a cell's own
area: the (u, v) cells of the unit square that lie below its diagonal
(ix + iy < k - 1) cover twice that, those on it (ix + iy = k - 1) that, and
those above it no surface at all (no hit inside its triangle has u + v > 1).

A hit's cell is taken from its own (t, triangle): the point o + t d, its
barycentrics (u, v) from the cross products with the triangle's normal,
each clamped to [0, 1], the upper half (u + v > 1) folded onto the lower one
(u, v) -> (1 - u, 1 - v), then the cell (min(floor(u k), k - 1), min(floor(v
k), k - 1)). An iteration's photons and keys are reference/dose.py's (the
split path's stratified sampler, drawn from threefry: the sampler of a
launch whose hits are binned into texels); they are traced by
reference/tracer.py.

The probe grid: res x res cell centres over the scene's xz bounds, cast
straight down from 0.1 above the scene top; a probe whose hit lies within
0.05 of the top is cast again from 1e-3 below that hit (its t still counted
from the first origin), unless the scene is no taller than 0.5. A probe's
value is its texel's dose: count x power x 0.1 / (cell area x photons a
lamp).

`dtype` is the precision of the triangle tests and of the barycentrics.
Every operation is elementwise or a reduction: no matrix product, so TF32
never applies on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmarks.reference import dose as ref_dose
from benchmarks.reference import threefry
from benchmarks.reference.tracer import trace

CEILING_MARGIN = 0.05
PROBE_LIFT = 0.1


class Atlas(NamedTuple):
    base: torch.Tensor  # int64[T] first slot of each triangle
    k: torch.Tensor  # int64[T] grid side
    n_slots: int
    cell_area: torch.Tensor  # f64[T] area / k^2
    v0: torch.Tensor  # f32[T, 3] the triangles, for the barycentrics
    e1: torch.Tensor  # f32[T, 3] v1 - v0
    e2: torch.Tensor  # f32[T, 3] v2 - v0


def grid_sides(areas: np.ndarray, density: float, max_slots: int) -> np.ndarray:
    """int64[T] grid side of each triangle."""
    a = np.maximum(np.asarray(areas, np.float64), 0.0)
    if a.shape[0] > max_slots:
        raise ValueError(f"{max_slots} slots cannot give each of {a.shape[0]} triangles a cell")
    k = np.maximum(1, np.ceil(np.sqrt(a) * density)).astype(np.int64)
    while int((k * k).sum()) > max_slots:
        shrunk = np.maximum(1, np.floor(k * np.sqrt(max_slots / (k * k).sum()))).astype(np.int64)
        k = shrunk if (shrunk != k).any() else np.maximum(1, k - 1)
    return k


def atlas(tris: np.ndarray, areas: np.ndarray, density: float, max_slots: int, device) -> Atlas:
    k = grid_sides(areas, density, max_slots)
    base = np.concatenate([[0], np.cumsum(k * k)[:-1]]).astype(np.int64)
    tris = np.asarray(tris, np.float32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return Atlas(to(base), to(k), int((k * k).sum()), to(np.asarray(areas, np.float64) / (k * k)), to(tris[:, 0]),
                 to(tris[:, 1] - tris[:, 0]), to(tris[:, 2] - tris[:, 0]))


def slot_triangles(at: Atlas) -> torch.Tensor:
    """int64[n_slots] the triangle of each slot."""
    return torch.repeat_interleave(torch.arange(at.k.shape[0], device=at.k.device), at.k * at.k)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def cells(at: Atlas, orig, dirs, t, tri, dtype=torch.float32, fold: bool = True, mirror: bool = False,
          shift: int = 0):
    """int64 slot of each hit (-1 for a miss). `fold`, `mirror` and `shift`
    plant the controls' faults: the upper half left unfolded, every hit's
    (u, v) mirrored to (1 - u, 1 - v) after the fold, every slot moved on by
    `shift`."""
    hit = tri >= 0
    safe = tri.clamp_min(0)
    v0, e1, e2 = (x[safe].to(dtype) for x in (at.v0, at.e1, at.e2))
    tt = torch.where(hit, t, 0.0).to(dtype)
    w = orig.to(dtype) + tt[:, None] * dirs.to(dtype) - v0
    n = _cross(e1, e2)
    nn = _dot(n, n).clamp_min(torch.finfo(dtype).tiny)
    u = (_dot(_cross(w, e2), n) / nn).clamp(0.0, 1.0)
    v = (_dot(_cross(e1, w), n) / nn).clamp(0.0, 1.0)
    if fold:
        over = u + v > 1.0
        u, v = torch.where(over, 1.0 - u, u), torch.where(over, 1.0 - v, v)
    if mirror:
        u, v = 1.0 - u, 1.0 - v
    k = at.k[safe]
    kf = k.to(dtype)
    ix = torch.minimum(torch.floor(u * kf).long(), k - 1)
    iy = torch.minimum(torch.floor(v * kf).long(), k - 1)
    slot = (at.base[safe] + iy * k + ix + shift).clamp_max(at.n_slots - 1)
    return torch.where(hit, slot, -1)


def iteration_texels(scene, at: Atlas, lamps, floor_height: float, light_height: float, light_length: float,
                     photon_count: int, seed: int, iteration: int, device, dtype=torch.float32,
                     variants: dict | None = None, sample_every: int = 0):
    """One iteration of a session over `lamps` [(x, z, seconds)], traced
    again. Returns ({variant: f64[n_slots] dwell-weighted texel hits},
    f64[T] dwell-weighted triangle hits, K6's work {lanes, hits, triangles,
    texels}: each summed over the launches, a triangle or texel counted once
    a launch it is hit in, B2's work sample (live segments, their work scaled
    to the batch)). variants: {name: keyword arguments of `cells`}, the
    sound cells by default."""
    variants = variants or {"sound": {}}
    n, chunk = ref_dose.launch_size(photon_count, len(lamps))
    hists = {name: torch.zeros(at.n_slots, dtype=torch.float64, device=device) for name in variants}
    tri_hits = torch.zeros(at.k.shape[0], dtype=torch.float64, device=device)
    k6 = dict(lanes=0, hits=0, triangles=0, texels=0)
    b2 = [0, 0.0]
    for w, (x, z, seconds) in enumerate(lamps):
        lamp = (x, float(np.float32(floor_height + light_height)), z)
        key = ref_dose.launch_key(seed, iteration * len(lamps) + w)
        for g in range(n // chunk):
            o, d = ref_dose.stratified_rays(threefry.fold_in(key, g), lamp, light_length, chunk, device)
            t, tri = trace(scene, o, d, dtype=dtype)
            hit = tri >= 0
            tri_hits += torch.bincount(tri[hit], minlength=tri_hits.shape[0]).double() * float(seconds)
            for name, kw in variants.items():
                slots = cells(at, o, d, t, tri, dtype=dtype, **kw)
                hists[name] += torch.bincount(slots[hit], minlength=at.n_slots).double() * float(seconds)
            if sample_every:
                slots = cells(at, o, d, t, tri)
                k6["lanes"] += chunk
                k6["hits"] += int(hit.sum())
                k6["triangles"] += int(torch.unique(tri[hit]).numel())
                k6["texels"] += int(torch.unique(slots[hit]).numel())
                _, _, work = trace(scene, o[::sample_every], d[::sample_every], work=True)
                b2[0] += chunk
                b2[1] += float(work.sum()) * chunk / work.shape[0]
    return hists, tri_hits, k6, tuple(b2)


def probe_band(scene, tris: np.ndarray, res: int, row0: int, rows: int, device, dtype=torch.float32,
               sample_every: int = 0):
    """(orig, dir, t from the first origin, triangle, B2's work sample) of
    the probes of rows row0 .. row0 + rows - 1 of the res x res grid (row:
    z, column: x), with the ceiling re-cast. The work sample: (live probe
    segments, re-casts included, their work scaled to the band)."""
    verts = np.asarray(tris, np.float32).reshape(-1, 3)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    f32 = dict(dtype=torch.float32, device=device)
    centre = torch.arange(res, **f32) + 0.5
    xs = float(lo[0]) + centre * float((hi[0] - lo[0]) / np.float32(res))
    zs = (float(lo[2]) + centre * float((hi[2] - lo[2]) / np.float32(res)))[row0:row0 + rows]
    top = float(hi[1] + np.float32(PROBE_LIFT))
    m = rows * res
    orig = torch.stack([xs.repeat(rows), torch.full((m,), top, **f32), zs.repeat_interleave(res)], -1)
    dirs = torch.tensor([0.0, -1.0, 0.0], **f32).expand(m, 3).contiguous()
    t, tri = trace(scene, orig, dirs, dtype=dtype)
    work = [m, 0.0]
    if sample_every:
        _, _, w = trace(scene, orig[::sample_every], dirs[::sample_every], work=True)
        work[1] += float(w.sum()) * m / w.shape[0]
    if float(hi[1]) - float(lo[1]) > 10 * CEILING_MARGIN:
        y_hit = orig[:, 1] - t
        near = ((tri >= 0) & (y_hit > float(hi[1]) - CEILING_MARGIN)).nonzero()[:, 0]
        if near.numel() == 0:
            return orig, dirs, t, tri, tuple(work)
        o2 = orig[near].clone()
        o2[:, 1] = y_hit[near] - 1e-3
        t2, tri2 = trace(scene, o2, dirs[near], dtype=dtype)
        t[near] = torch.where(tri2 >= 0, (orig[near, 1] - o2[:, 1]) + t2, float("inf"))
        tri[near] = tri2
        if sample_every:
            _, _, w = trace(scene, o2[::sample_every], dirs[near][::sample_every], work=True)
            work[0] += near.numel()
            work[1] += float(w.sum()) * near.numel() / w.shape[0]
    return orig, dirs, t, tri, tuple(work)


def texel_values(at: Atlas, slots, counts, scale: float, photons_per_lamp: int):
    """f64 dose of each probe's texel (0 without one): counts (f64[n_slots],
    dwell-weighted) x scale / (cell area x photons a lamp)."""
    tri = slot_triangles(at)[slots.clamp_min(0)]
    value = counts.double()[slots.clamp_min(0)] * scale / (at.cell_area[tri] * float(photons_per_lamp))
    return torch.where(slots >= 0, value, 0.0)


def triangle_values(at: Atlas, tri, counts, scale: float, photons_per_lamp: int):
    """f64 dose of each probe's triangle (0 on a miss): the sum of its slots'
    counts over its area (the texel grid read at triangle resolution)."""
    per_tri = torch.bincount(slot_triangles(at), weights=counts.double(), minlength=at.k.shape[0])
    area = at.cell_area * (at.k * at.k)
    value = per_tri[tri.clamp_min(0)] * scale / (area[tri.clamp_min(0)] * float(photons_per_lamp))
    return torch.where(tri >= 0, value, 0.0)
