"""Closest hits of rays against a triangle soup, in plain PyTorch.

Each ray is tested against the triangles of the clusters whose box its line
crosses, nearest box first, until the next box starts beyond its best hit
(or beyond its limit). A triangle test is Möller–Trumbore with the
semantics of the upstream tracer (cl/extend.cl): a parallel ray (|det| <
1e-5) misses, and a hit needs t > 1e-4. The boxes are only a culling
structure (rooflines/clusters.py, grown a little so that rounding never
culls a hit): the result is the closest hit over every triangle, whatever
the clusters.

`dtype` is the precision of the triangle tests (the rays and triangles are
cast to it, every product and sum is rounded to it); the culling stays f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from benchmarks.rooflines.clusters import build_clusters

DET_EPS = 1e-5
T_MIN = 1e-4
INF = float("inf")
TEST_ELEMS = 1 << 24  # ray x triangle tests held at once
BOX_ELEMS = 1 << 27  # ray x box entries held at once


class TraceScene(NamedTuple):
    v0: torch.Tensor  # f32[S, 3] per cluster slot; padding slots are all zeros (det 0: never hit)
    e1: torch.Tensor  # f32[S, 3]
    e2: torch.Tensor  # f32[S, 3]
    tri: torch.Tensor  # int64[S] triangle id of a slot, -1 for padding
    box: torch.Tensor  # f32[L, 6] min.xyz, max.xyz, grown
    real: torch.Tensor  # f32[L] real triangles a cluster
    cluster_size: int


def scene_of(tris: np.ndarray, device) -> TraceScene:
    tris = np.ascontiguousarray(tris, np.float32)
    cl = build_clusters(tris)
    idx = cl.tri_idx.reshape(-1)
    slot_tris = np.zeros((idx.shape[0], 3, 3), np.float32)
    slot_tris[idx >= 0] = tris[idx[idx >= 0]]
    v0 = slot_tris[:, 0]
    grow = 1e-4 + 1e-6 * float(np.abs(tris).max(initial=1.0))
    box = np.concatenate([cl.box_min - grow, cl.box_max + grow], 1).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return TraceScene(to(v0), to(slot_tris[:, 1] - v0), to(slot_tris[:, 2] - v0), to(idx), to(box),
                      to(cl.real.astype(np.float32)), int(cl.tri_idx.shape[1]))


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def entries(scene: TraceScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """f32[B, L]: where each ray's line enters each box (0 if it starts
    inside), inf where it misses the box or leaves it behind its origin."""
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t_in = t_out = None
    for a in range(3):
        lo = (scene.box[None, :, a] - o[:, a, None]) * inv[:, a, None]
        hi = (scene.box[None, :, 3 + a] - o[:, a, None]) * inv[:, a, None]
        near, far = torch.minimum(lo, hi), torch.maximum(lo, hi)
        t_in = near if t_in is None else torch.maximum(t_in, near)
        t_out = far if t_out is None else torch.minimum(t_out, far)
    return torch.where((t_in <= t_out) & (t_out >= 0.0), t_in.clamp_min(0.0), INF)


def _tests(scene: TraceScene, o, d, slots, dtype):
    """f32[A, K]: t of each ray against the triangles in its row of slots
    (int64[A, K]), inf on a miss."""
    v0, e1, e2 = (x[slots].to(dtype) for x in (scene.v0, scene.e1, scene.e2))
    o = o[:, None].to(dtype)
    d = d[:, None].to(dtype)
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv = torch.where(det == 0, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    ok = (det.abs() >= DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(ok, t.float(), INF)


def _block(scene: TraceScene, o, d, limit, dtype, work: bool, any_hit: bool):
    ent = entries(scene, o, d)
    ent = torch.where(ent < limit[:, None], ent, INF)
    ent_s, order = torch.sort(ent, dim=1)
    n_cand = (ent_s < INF).sum(1)
    rows, l_count = o.shape[0], ent.shape[1]
    c_sz = scene.cluster_size
    lane = torch.arange(c_sz, device=o.device)
    best_t = limit.clone()
    best_tri = torch.full((rows,), -1, dtype=torch.int64, device=o.device)
    pos = torch.zeros(rows, dtype=torch.int64, device=o.device)
    width = 1
    while True:
        nxt = ent_s.gather(1, pos.clamp_max(l_count - 1)[:, None])[:, 0]
        act = ((pos < n_cand) & (nxt < best_t)).nonzero()[:, 0]
        if act.numel() == 0:
            break
        step = max(1, TEST_ELEMS // (width * c_sz))
        for a0 in range(0, act.numel(), step):
            ids = act[a0:a0 + step]
            cols = pos[ids, None] + torch.arange(width, device=o.device)
            cols_c = cols.clamp_max(l_count - 1)
            live = (cols < n_cand[ids, None]) & (ent_s[ids[:, None], cols_c] < best_t[ids, None])
            slots = (order[ids[:, None], cols_c] * c_sz)[..., None] + lane  # [A, w, C]
            t = _tests(scene, o[ids], d[ids], slots.reshape(ids.numel(), -1), dtype)
            t = torch.where(live.repeat_interleave(c_sz, dim=1), t, INF)
            t_min, arg = t.min(1)
            better = t_min < best_t[ids]
            best_t[ids] = torch.where(better, t_min, best_t[ids])
            hit_tri = scene.tri[slots.reshape(ids.numel(), -1).gather(1, arg[:, None])[:, 0]]
            best_tri[ids] = torch.where(better, hit_tri, best_tri[ids])
            pos[ids] += width
            if any_hit:  # a hit before the limit ends the ray
                pos[ids] = torch.where(better, l_count, pos[ids])
        width = min(2 * width, 16)
    hit = best_tri >= 0
    t_out = torch.where(hit, best_t, INF)
    if not work:
        return t_out, best_tri, None
    # real triangles of the boxes each ray's segment enters before its hit
    return t_out, best_tri, ((ent < best_t[:, None]).float() * scene.real[None]).sum(1)


def trace(scene: TraceScene, orig: torch.Tensor, dirs: torch.Tensor, limit: Optional[torch.Tensor] = None,
          dtype=torch.float32, work: bool = False, any_hit: bool = False):
    """(t f32[N] inf on a miss, triangle int64[N] -1 on a miss[, work
    f32[N]]) of the closest hit of each ray (orig, unit dirs f32[N, 3]).
    With `limit` f32[N], only hits before it count: a ray with none reads
    (inf, -1). `work`: the real triangles of the boxes each ray enters
    before its hit (rooflines/work.py). `any_hit`: a ray stops at its first
    hit before its limit, which need not be its closest."""
    n = orig.shape[0]
    if limit is None:
        limit = torch.full((n,), INF, device=orig.device)
    block = max(1, BOX_ELEMS // scene.box.shape[0])
    ts, tris, works = [], [], []
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        t, tri, w = _block(scene, orig[r0:r1].float(), dirs[r0:r1].float(), limit[r0:r1].float(), dtype, work,
                          any_hit)
        ts.append(t)
        tris.append(tri)
        works.append(w)
    out = (torch.cat(ts), torch.cat(tris))
    return out + (torch.cat(works),) if work else out
