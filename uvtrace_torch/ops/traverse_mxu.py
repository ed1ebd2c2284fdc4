"""The trace kernels over Plücker cluster tiles: fused generate + trace +
histogram (TPU kernel B1) and the split trace of rays in memory (B2).

Port of uvtrace/ops/traverse_mxu.py's `fused_trace_counts` (the TPU kernel
`_fused_kernel` + `_trace`) and `_traverse_mxu_padded` (`_kernel` + `_trace`,
behind `traverse_mxu_slots`, `traverse_mxu_counts` and `traverse_mxu`). Both
find closest hits with Plücker edge tests over clusters of C triangles:

    side_i = d . (a_i x b_i)  +  m . (b_i - a_i)     (edge a_i -> b_i, m = o x d)
    t_num  = n . v0  -  n . o                         (n = geometric normal)
    t_den  = side_0 + side_1 + side_2 = n . d

A hit needs min(side) * max(side) >= 0, |t_den| >= 1e-5 and t > 1e-4, as in
the reference's Möller–Trumbore (cl/extend.cl:6-27). Winners are histogrammed
per padded cluster slot (cid * C + lane). The fused kernel samples its rays
from one cell of the stratified sphere grid (ops/generate._stratum_grid) with
a counter-based WangHash, culls every cluster AABB against the cell's
analytic packet frustum and visits the survivors near-first. The split
kernel reads rays from memory and walks each ray on its own over a top tree
of the clusters (the gen-1 kernel's, `cluster_top_tree`), near child first,
while a node's box may hold a hit at or before the ray's best t
(`may_visit`).

Two versions of each function:
  - `fused_trace_counts` and `traverse_mxu_padded` launch the CUDA kernels
    csrc/fused_trace.cu and csrc/traverse_mxu.cu (one leaf arithmetic,
    csrc/trace_common.cuh) for CUDA tensors and run the plain versions for
    CPU tensors;
  - `fused_trace_counts_reference` and `traverse_mxu_padded_reference` are
    the plain PyTorch versions: the same rays, then a brute-force closest hit
    over all L*C slots; their statistics replay the kernels' walks.

Both compute in f32 whatever `SimParams.precision` says (the TPU's bf16x3
"high" tier has no counterpart here). Ties in t between clusters break by the
lowest slot (a lexicographic (t, slot) minimum); the TPU kernel keeps the
first cluster it visited.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from uvtrace_torch.device import resolve
from uvtrace_torch.ops.accumulate import hit_histogram_reference
from uvtrace_torch.ops.cluster import ClusteredScene
from uvtrace_torch.ops.generate import TWO_PI, _F, _stratum_grid
from uvtrace_torch.ops.intersect import safe_inv_dir
from uvtrace_torch.ops.rng import wang_hash
from uvtrace_torch.ops.traverse_pallas import cluster_top_tree, used_slots

BIG = 1e30  # miss distance; tensors hold its f32 rounding, _BIG32
PACKET = 1024
NFEAT = 16  # d(3), m=o x d(3), o(3), 1; padded (JAX layout)
KROWS = 10  # feature rows in use
FUSED_MAX_PACKET = 4096  # the fused kernel's block: at most 1024 threads of 4 rays (csrc/fused_trace.cu)
STACK_DEPTH = 64  # node stack of the split kernel's per-ray walk (csrc/traverse_mxu.cu)
MARGIN = 2.0 ** -16  # the split walk's visit rule (`may_visit`) grows boxes by MARGIN (1 + |o|_inf)
GROW_MARGIN = 2.0 ** -4  # ... and the ray's best t by this fraction
_M32 = 0xFFFFFFFF
_SBIG = 1e18  # half-line sentinel of the slab test; |g| * 1e18 stays finite
_PI, _HALF_PI, _THREE_HALF_PI = _F(np.pi), _F(np.pi / 2), _F(3 * np.pi / 2)
_BIG32 = _F(BIG)
_GROW = _F(1.0 + GROW_MARGIN)  # exact in f32
_WALK_ELEMS = 1 << 25  # rays x clusters of per-cluster t held by one lockstep walk of the plain version


class MxuScene(NamedTuple):
    """Scene arrays on one device.

    boxes, feat and tri_idx_flat have the JAX MxuScene's layout at group=1;
    box6 and tri_used (the fused kernel's), feat10 (the plain versions') and
    tri_feat (both kernels') are repacked copies, made once at build;
    node_box, node_meta and depth are the top tree over the clusters, the
    same arrays as PallasScene's."""

    boxes: torch.Tensor  # f32[6, 8, L8] AABB rows min.xyz, max.xyz; cluster c at (c % 8, c // 8)
    feat: torch.Tensor  # f32[L, 16, 4C] Plücker coefficients, quantity q at columns q*C..q*C+C
    tri_idx_flat: torch.Tensor  # i32[L*C] slot -> original triangle (-1 for padding)
    box6: torch.Tensor  # f32[L, 6] min.xyz, max.xyz per cluster
    feat10: torch.Tensor  # f32[L, 10, 4C] the used rows of feat, contiguous per cluster (`closest_hits`)
    tri_feat: torch.Tensor  # f32[L, C, 10, 4] triangle-major: row k of triangle j is its 4 quantities
    tri_used: torch.Tensor  # i32[L] slots in use: one past the cluster's last triangle that is not all zeros
    node_box: torch.Tensor  # f32[Nn*8] minx, miny, minz, maxx, maxy, maxz, pad, pad
    node_meta: torch.Tensor  # i32[Nn*2] (left child | cluster id, is_leaf)
    depth: int  # levels of the top tree; the split kernel's stack holds STACK_DEPTH

    @property
    def n_clusters(self) -> int:
        return int(self.feat.shape[0])

    @property
    def cluster_size(self) -> int:
        return int(self.feat.shape[2]) // 4


def scene_from_numpy(boxes, feat, tri_idx_flat, device="cuda") -> MxuScene:
    """MxuScene from the numpy arrays of a JAX `MxuScene` (group=1 layout);
    the top tree is built from the cluster boxes. device="cuda" raises when
    torch sees no card; "cpu" gives the plain versions' scene."""
    device = resolve(device)
    boxes = np.asarray(boxes, np.float32)
    feat = np.asarray(feat, np.float32)
    l_count, c_sz = feat.shape[0], feat.shape[2] // 4
    box6 = boxes.swapaxes(1, 2).reshape(6, -1)[:, :l_count].T
    node_box, node_meta, depth = cluster_top_tree(box6[:, :3], box6[:, 3:])
    tri_feat = feat[:, :KROWS].reshape(l_count, KROWS, 4, c_sz).transpose(0, 3, 1, 2)
    to = lambda a: torch.from_numpy(np.array(a, order="C")).to(device)  # noqa: E731  (a writable copy)
    return MxuScene(
        boxes=to(boxes),
        feat=to(feat),
        tri_idx_flat=to(np.asarray(tri_idx_flat, np.int32)),
        box6=to(box6),
        feat10=to(feat[:, :KROWS]),
        tri_feat=to(tri_feat),
        tri_used=to(used_slots((tri_feat != 0).any((2, 3)))),
        node_box=to(node_box.reshape(-1)),
        node_meta=to(node_meta.reshape(-1)),
        depth=depth,
    )


def build_mxu_scene(cs: ClusteredScene, device="cuda") -> MxuScene:
    """Host-side AABB planes and Plücker feature tiles, in the layout of
    uvtrace/ops/traverse_mxu.py:build_mxu_scene at group=1.

    feat[l, :, q*C + j] is the 16-coefficient vector of quantity q for
    triangle j of cluster l; rows are the ray-feature basis
    [dx,dy,dz, mx,my,mz, ox,oy,oz, 1, 0...]. q=0,1,2 are the edge side tests,
    q=3 the t numerator. Padded triangles are all zeros and fail
    |den| >= 1e-5. On `device` (`scene_from_numpy`)."""
    c_sz = cs.cluster_size
    if c_sz % 8 or c_sz > 512:
        raise ValueError(f"cluster_size must be a multiple of 8 up to 512, got {c_sz}")
    l_count = cs.n_clusters
    l8 = max(1, -(-l_count // 8))
    boxes = np.full((6, 8 * l8), np.float32(BIG), np.float32)
    boxes[0:3, :l_count] = cs.box_min.T
    boxes[3:6, :l_count] = cs.box_max.T
    boxes = boxes.reshape(6, l8, 8).swapaxes(1, 2).copy()

    a = cs.tris[:, :, 0].astype(np.float64)  # [L,C,3] f64 for feature prep
    b = cs.tris[:, :, 1].astype(np.float64)
    c = cs.tris[:, :, 2].astype(np.float64)
    n = np.cross(b - a, c - a)
    feat = np.zeros((l_count, NFEAT, 4, c_sz), np.float32)
    for q, (edge_a, edge_b) in enumerate(((a, b), (b, c), (c, a))):
        feat[:, 0:3, q] = np.moveaxis(np.cross(edge_a, edge_b), 2, 1)  # . d
        feat[:, 3:6, q] = np.moveaxis(edge_b - edge_a, 2, 1)  # . m
    feat[:, 6:9, 3] = np.moveaxis(-n, 2, 1)  # . o
    feat[:, 9, 3] = np.einsum("ljk,ljk->lj", n, a)  # n . v0
    feat = feat.reshape(l_count, NFEAT, 4 * c_sz)
    return scene_from_numpy(boxes, feat, cs.tri_idx.reshape(-1), device=device)


def _packets(n: int, packet: int) -> tuple[int, int]:
    """(packet, packets) of a launch of n rays, with the TPU wrappers' packet
    fallback (uvtrace/ops/traverse_mxu.py:580-587, :837-846): a small launch
    is one whole packet, and the packet halves while it does not divide n."""
    packet = min(packet, n)
    while n % packet and packet > PACKET:
        packet //= 2
    if packet % 128 or n % packet:
        raise ValueError(f"n={n} must be a whole number of packets of a multiple of 128 rays (packet={packet})")
    return packet, n // packet


def _launch_shape(n: int, packet: int, height_bands: int):
    """(packet, packets, stratum grid) of a fused launch of n rays."""
    packet, g = _packets(n, packet)
    return packet, g, _stratum_grid(g, height_bands=height_bands)


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def hash_uniforms(key_words, g: int, packet: int, device) -> torch.Tensor:
    """f32[3, g, packet] uniforms (uh, uy, up) of the fused generator: the
    counter of row k, packet pid, lane i is k*P + i + pid*3P (mod 2^32)."""
    k0, k1 = (int(w) & _M32 for w in key_words)
    i64 = dict(dtype=torch.int64, device=device)
    ctr = (
        torch.arange(3, **i64)[:, None, None] * packet
        + torch.arange(packet, **i64)[None, None, :]
        + torch.arange(g, **i64)[None, :, None] * (3 * packet)
    ) & _M32
    h = wang_hash(wang_hash(ctr ^ k0) ^ k1)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _cell_bounds(g: int, grid, lamp, llen: float, device):
    """Per-packet stratum-cell bounds, in the f32 operation order of
    uvtrace/ops/traverse_mxu.py:716-795. Returns the clip bounds of cos/sin
    and the 12 frustum values (o_lo.xyz, o_hi.xyz, d_lo.xyz, d_hi.xyz), each
    f32[g, 1]."""
    gh, gy, gphi = grid
    lx, ly, lz = lamp
    pid = torch.arange(g, dtype=torch.int64, device=device)[:, None]
    ihf = (pid // (gy * gphi)).to(torch.float32)
    iyf = ((pid // gphi) % gy).to(torch.float32)
    ipf = (pid % gphi).to(torch.float32)
    ylo = -1.0 + 2.0 * iyf / gy
    yhi = -1.0 + 2.0 * (iyf + 1.0) / gy
    y2a, y2b = ylo * ylo, yhi * yhi
    zero = torch.zeros_like(ylo)
    y2min = torch.where((ylo <= 0.0) & (yhi >= 0.0), zero, torch.minimum(y2a, y2b))
    y2max = torch.maximum(y2a, y2b)
    rmin = torch.sqrt(torch.maximum(zero, 1.0 - y2max))
    rmax = torch.sqrt(torch.maximum(zero, 1.0 - y2min))
    plo = TWO_PI * ipf / gphi
    phh = TWO_PI * (ipf + 1.0) / gphi
    one = torch.ones_like(ylo)
    ca, cb = torch.cos(plo), torch.cos(phh)
    c_hi = torch.where((plo <= 0.0) | (phh >= TWO_PI), one, torch.maximum(ca, cb))
    c_lo = torch.where((plo <= _PI) & (phh >= _PI), -one, torch.minimum(ca, cb))
    sa, sb = torch.sin(plo), torch.sin(phh)
    s_hi = torch.where((plo <= _HALF_PI) & (phh >= _HALF_PI), one, torch.maximum(sa, sb))
    s_lo = torch.where((plo <= _THREE_HALF_PI) & (phh >= _THREE_HALF_PI), -one, torch.minimum(sa, sb))
    # quadrant-boundary trig noise -> exact 0, which keeps an interval one-sided
    snap = lambda v: torch.where(v.abs() < 1e-6, zero, v)  # noqa: E731
    c_lo, c_hi, s_lo, s_hi = snap(c_lo), snap(c_hi), snap(s_lo), snap(s_hi)

    def prod_hull(lo, hi):
        p = torch.stack([rmin * lo, rmin * hi, rmax * lo, rmax * hi])
        return p.amin(0), p.amax(0)

    dxlo, dxhi = prod_hull(c_lo, c_hi)
    dzlo, dzhi = prod_hull(s_lo, s_hi)
    oylo = ly + ihf / gh * llen
    oyhi = ly + (ihf + 1.0) / gh * llen
    full = lambda v: torch.full_like(ylo, v)  # noqa: E731
    pb = [full(lx), oylo, full(lz), full(lx), oyhi, full(lz), dxlo, ylo, dzlo, dxhi, yhi, dzhi]
    return (ihf, iyf, ipf), (c_lo, c_hi, s_lo, s_hi), pb


def generate_fused_rays(key_words, lamp_xyz, light_length, n: int, *, packet: int = PACKET,
                        height_bands: int = 4, device="cpu"):
    """The fused kernel's rays in plain torch: (orig f32[n,3], dir f32[n,3],
    frustum list of 12 f32[g,1]). Same operation order as
    uvtrace/ops/traverse_mxu.py:679-752."""
    packet, g, grid = _launch_shape(n, packet, height_bands)
    gh, gy, gphi = grid
    lx, ly, lz = (_F(v) for v in lamp_xyz)
    llen = _F(light_length)
    (ihf, iyf, ipf), (c_lo, c_hi, s_lo, s_hi), pb = _cell_bounds(g, grid, (lx, ly, lz), llen, device)
    uh, uy, up = hash_uniforms(key_words, g, packet, device)
    dy = -1.0 + 2.0 * (iyf + uy) / gy
    phi = TWO_PI * (ipf + up) / gphi
    r = torch.sqrt(torch.clamp_min(1.0 - dy * dy, 0.0))
    dx = r * torch.clamp(torch.cos(phi), c_lo, c_hi)
    dz = r * torch.clamp(torch.sin(phi), s_lo, s_hi)
    oy = ly + (ihf + uh) / gh * llen
    orig = torch.stack([torch.full_like(oy, lx), oy, torch.full_like(oy, lz)], -1).reshape(n, 3)
    direction = torch.stack([dx, dy, dz], -1).reshape(n, 3)
    return orig, direction, pb


def ray_features(orig: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """f32[R, 10] Plücker ray features (d, m = o x d, o, 1), with the cross
    product in the operation order of uvtrace/ops/traverse_mxu.py:754-760."""
    ox, oy, oz = orig.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    m = [oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx]
    return torch.stack([dx, dy, dz, *m, ox, oy, oz, torch.ones_like(ox)], -1)


def frustum_entries(box6: torch.Tensor, pb) -> torch.Tensor:
    """f32[g, L] conservative entry distance of each packet frustum into each
    cluster AABB, BIG where the slab test culls the cluster
    (uvtrace/ops/traverse_mxu.py:217-254, with the one-sided half-line rule
    for direction intervals that touch 0)."""
    big = torch.tensor(_BIG32, device=box6.device)
    entry = torch.full((pb[0].shape[0], box6.shape[0]), -_BIG32, device=box6.device)
    exit_ = torch.full_like(entry, _BIG32)
    for ax in range(3):
        o_lo, o_hi, d_lo, d_hi = pb[ax], pb[3 + ax], pb[6 + ax], pb[9 + ax]
        spans = ((d_lo < 0.0) & (d_hi > 0.0)) | ((d_lo == 0.0) & (d_hi == 0.0))
        i_lo = torch.where(d_hi == 0.0, -_SBIG, 1.0 / torch.where(d_hi == 0.0, 1.0, d_hi))
        i_hi = torch.where(d_lo == 0.0, _SBIG, 1.0 / torch.where(d_lo == 0.0, 1.0, d_lo))
        g_lo = box6[None, :, ax] - o_hi
        g_hi = box6[None, :, 3 + ax] - o_lo
        p = torch.stack([g_lo * i_lo, g_lo * i_hi, g_hi * i_lo, g_hi * i_hi])
        entry = torch.maximum(entry, torch.where(spans, -big, p.amin(0)))
        exit_ = torch.minimum(exit_, torch.where(spans, big, p.amax(0)))
    may_hit = (entry <= exit_) & (exit_ > 0.0)
    return torch.where(may_hit, torch.where(entry > 0.0, entry, 0.0), big)


def closest_hits(scene: MxuScene, rf: torch.Tensor, *, per_cluster: bool = False):
    """Brute-force closest hit of every ray over all L*C slots.

    rf: f32[R, 10] ray features. Returns (t f32[R], slot i32[R]) with
    (1e30, -1) on a miss and the lowest slot among equal t; with
    per_cluster also f32[R, L], each cluster's own nearest t."""
    r_count = rf.shape[0]
    l_count, c_sz = scene.n_clusters, scene.cluster_size
    feat = scene.feat10.permute(1, 0, 2)  # [10, L, 4C]
    t_best = torch.full((r_count,), _BIG32, device=rf.device)
    s_best = torch.full((r_count,), -1, dtype=torch.int64, device=rf.device)
    t_cl = []
    lb = max(1, (1 << 24) // max(1, r_count * 4 * c_sz))  # clusters per product
    for c0 in range(0, l_count, lb):
        c1 = min(l_count, c0 + lb)
        q = (rf @ feat[:, c0:c1].reshape(KROWS, -1)).view(r_count, c1 - c0, 4, c_sz)
        s0, s1, s2, tn = q.unbind(2)
        den = s0 + s1 + s2
        mn = torch.minimum(torch.minimum(s0, s1), s2)
        mx = torch.maximum(torch.maximum(s0, s1), s2)
        ok = (mn * mx >= 0.0) & (den.abs() >= 1e-5)
        t = tn / torch.where(den == 0.0, 1.0, den)
        t = torch.where(ok & (t > 1e-4), t, _BIG32)
        if per_cluster:
            t_cl.append(t.amin(2))
        t = t.reshape(r_count, -1)
        tmin = t.amin(1)
        iota = torch.arange(t.shape[1], device=rf.device)
        arg = torch.where(t <= tmin[:, None], iota, t.shape[1]).amin(1)
        better = tmin < t_best
        s_best = torch.where(better, c0 * c_sz + arg, s_best)
        t_best = torch.where(better, tmin, t_best)
    slot = torch.where(t_best >= _BIG32, -1, s_best).to(torch.int32)
    if per_cluster:
        return t_best, slot, torch.cat(t_cl, 1)
    return t_best, slot


def _visits(entries: torch.Tensor, t_cl: torch.Tensor) -> torch.Tensor:
    """i32[g] clusters the fused kernel's near-first walk visits per packet:
    in (entry, cid) order, while the entry is <= the packet bound (the max
    over its rays of their best t so far). entries: f32[g, L]; t_cl: f32[g,
    P, L]."""
    e_s, order = torch.sort(entries, dim=1, stable=True)
    t_s = t_cl.gather(2, order[:, None, :].expand_as(t_cl))
    t_ub = torch.cummin(t_s, dim=2).values.amax(1)  # bound after each visit
    before = torch.cat([torch.full_like(t_ub[:, :1], _BIG32), t_ub[:, :-1]], 1)
    go = (e_s < _BIG32) & (e_s <= before)
    return torch.cumprod(go.to(torch.int32), dim=1).sum(1).to(torch.int32)


def _slab(box: torch.Tensor, orig: torch.Tensor, direction: torch.Tensor, inv: torch.Tensor,
          grow: torch.Tensor):
    """(lo = max(entry, 0), exit) of the f32 slab test of boxes (min.xyz,
    max.xyz in the first 6 entries of the last axis), each grown by `grow`
    on every side, against rays, broadcast, in the split kernel's operation
    order; inv = safe_inv_dir(direction). On an axis where d is 0 the ray is
    in the slab for every t when min <= o <= max (faces included) and for
    none otherwise: (max - o) * 1e30 would put a ray that lies in a box's
    face at exit 0. NaN propagates into both, so a NaN ray visits nothing."""
    entry = exit_ = None
    for ax in range(3):
        mn, mx = box[..., ax] - grow, box[..., 3 + ax] + grow
        t1 = (mn - orig[..., ax]) * inv[..., ax]
        t2 = (mx - orig[..., ax]) * inv[..., ax]
        inside = (mn <= orig[..., ax]) & (orig[..., ax] <= mx)
        flat = direction[..., ax] == 0.0
        near = torch.where(flat, torch.where(inside, -_BIG32, _BIG32), torch.minimum(t1, t2))
        far = torch.where(flat, torch.where(inside, _BIG32, -_BIG32), torch.maximum(t1, t2))
        entry = near if entry is None else torch.maximum(entry, near)
        exit_ = far if exit_ is None else torch.minimum(exit_, far)
    return torch.maximum(entry, torch.zeros_like(entry)), exit_


def _grow(orig: torch.Tensor) -> torch.Tensor:
    """How far the visit rule grows a box for a ray: 2^-16 (1 + |o|_inf)."""
    return MARGIN * (1.0 + orig.abs().amax(-1))


def _visit(lo, exit_, best):
    return lo <= torch.minimum(exit_, best * _GROW)


def may_visit(box: torch.Tensor, orig: torch.Tensor, direction: torch.Tensor, t_max: torch.Tensor):
    """The split kernel's conservative visit rule, broadcast: may a ray hit
    the box at or before t_max? With lo = max(entry, 0) and exit of the f32
    slab test (inv = 1 / d, 1e-30 for a zero axis) of the box grown by 2^-16
    (1 + |o|_inf) on every side, a box is visited while
    lo <= min(exit, t_max * (1 + 2^-4)). The slack covers the different
    roundings of the slab test and of the Plücker t: a triangle in its box's
    face can get a t a few ulps below the entry; a small triangle far from
    the origin can lose 1e-4 of its t to cancellation; a ray grazing a wall
    (|n . d| near the hit rule's 1e-5) can get a t a few percent short, which
    puts its hit point off the wall's flat box. Only t is that far off (the
    edge tests place the ray to about 1e-6 m), so the exit takes no relative
    slack: the grown box covers the slab's own rounding. A looser rule only
    costs work. The slack was sized on adversarial ray families
    (tests/test_torch_split_walk.py), not proved: no fixed slack covers a ray
    at |n . d| near 1e-5 on a triangle metres wide, whose t is off by tens of
    percent.

    box: f32[..., 6+] (min.xyz, max.xyz first); orig, direction: f32[..., 3];
    t_max: f32[...]. Returns bool[...]."""
    lo, exit_ = _slab(box, orig, direction, safe_inv_dir(direction), _grow(orig))
    return _visit(lo, exit_, t_max)


def clusters_within(scene: MxuScene, orig: torch.Tensor, direction: torch.Tensor,
                    t_max: torch.Tensor, *, triangles: bool = False) -> torch.Tensor:
    """i32[R] clusters whose box each ray may hit at or before t_max f32[R]
    (`may_visit`). At the ray's closest hit these are the clusters it needs:
    any walk with this rule tests at least them; at t_max = BIG, every
    cluster whose box it enters. With triangles, the real (unpadded)
    triangles of those clusters instead: the ray-triangle tests the ray
    needs."""
    rb = max(1, (1 << 24) // scene.n_clusters)
    box = scene.box6[None]
    weight = (scene.tri_idx_flat.view(scene.n_clusters, -1) >= 0).sum(1, dtype=torch.int32) if triangles else 1
    return torch.cat([
        (may_visit(box, orig[r0:r0 + rb, None], direction[r0:r0 + rb, None], t_max[r0:r0 + rb, None])
         * weight).sum(1, dtype=torch.int32)
        for r0 in range(0, orig.shape[0], rb)])


def walk_tests(scene: MxuScene, orig: torch.Tensor, direction: torch.Tensor, t_cl: torch.Tensor):
    """(i32[R] (ray, leaf) tests, f32[R] best t) of the split kernel's walk,
    replayed in lockstep: every step, each ray with a non-empty stack pops
    one node; a popped node that the ray's best t now prunes is dropped; a
    leaf lowers the best t to min(best, t_cl[ray, cluster]); an inner node
    pushes the children the ray may visit, the far one first (ties: the left
    child is near). t_cl: f32[R, L] each cluster's nearest t for each ray
    (`closest_hits(per_cluster=True)`), so each step moves the best t as the
    kernel's leaf test does."""
    r_count, dev = orig.shape[0], orig.device
    box = scene.node_box.view(-1, 8)
    meta = scene.node_meta.view(-1, 2).long()
    inv = safe_inv_dir(direction)
    grow = _grow(orig)
    best = torch.full((r_count,), _BIG32, device=dev)
    # one spare column takes the unconditional write above the top
    stack = torch.zeros((r_count, scene.depth + 1), dtype=torch.int64, device=dev)
    stack_lo = torch.zeros((r_count, scene.depth + 1), device=dev)
    lo, exit_ = _slab(box[0], orig, direction, inv, grow)
    stack_lo[:, 0] = lo
    sp = _visit(lo, exit_, best).long()
    tests = torch.zeros(r_count, dtype=torch.int32, device=dev)
    while True:
        rows = torch.nonzero(sp > 0).flatten()
        if not rows.numel():
            return tests, best
        s = sp[rows] - 1
        sp[rows] = s
        node, bt = stack[rows, s], best[rows]
        go = stack_lo[rows, s] <= bt * _GROW
        leaf = meta[node, 1] == 1
        at_leaf = go & leaf
        r = rows[at_leaf]
        best[r] = torch.minimum(bt[at_leaf], t_cl[r, meta[node[at_leaf], 0]])
        tests[r] += 1
        inner = go & ~leaf
        r = rows[inner]
        c1 = meta[node[inner], 0]
        c2 = c1 + 1
        o, d, iv, b, gr = orig[r], direction[r], inv[r], bt[inner], grow[r]
        lo1, ex1 = _slab(box[c1], o, d, iv, gr)
        lo2, ex2 = _slab(box[c2], o, d, iv, gr)
        v1, v2 = _visit(lo1, ex1, b), _visit(lo2, ex2, b)
        near1 = lo1 <= lo2
        s = sp[r]
        stack[r, s] = torch.where(near1, c2, c1)  # the far child first
        stack_lo[r, s] = torch.where(near1, lo2, lo1)
        s = s + torch.where(near1, v2, v1).long()
        stack[r, s] = torch.where(near1, c1, c2)
        stack_lo[r, s] = torch.where(near1, lo1, lo2)
        sp[r] = s + torch.where(near1, v1, v2).long()


@contextlib.contextmanager
def _f32_products():
    """Matrix products in f32, never TF32, on the card."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _trace_reference(scene: MxuScene, orig: torch.Tensor, direction: torch.Tensor, packet: int, *,
                     pb=None, walk: bool = False):
    """Brute-force closest hits (t, slot) of whole packets of rays, in blocks
    of whole packets that bound the memory of the search, and a statistic per
    packet: with a frustum pb (12 f32[g, 1]), the clusters the fused kernel's
    near-first walk visits; with walk, the (ray, leaf) tests of the split
    kernel's walk (a block then holds up to 2^25 rays x clusters of
    per-cluster t)."""
    n = orig.shape[0]
    stat = pb is not None or walk
    rb = packet * max(1, (_WALK_ELEMS // scene.n_clusters if walk else 4096) // packet)
    ts, slots, stats = [], [], []
    with _f32_products():
        for r0 in range(0, n, rb):
            r1 = min(n, r0 + rb)
            o, d = orig[r0:r1], direction[r0:r1]
            res = closest_hits(scene, ray_features(o, d), per_cluster=stat)
            ts.append(res[0])
            slots.append(res[1])
            if pb is not None:
                p0, p1 = r0 // packet, r1 // packet
                ent = frustum_entries(scene.box6, [v[p0:p1] for v in pb])
                stats.append(_visits(ent, res[2].view(p1 - p0, packet, -1)))
            elif walk:
                stats.append(walk_tests(scene, o, d, res[2])[0].view(-1, packet).sum(1, dtype=torch.int32))
    out = (torch.cat(ts), torch.cat(slots))
    return out + (torch.cat(stats),) if stat else out


def fused_trace_counts_reference(scene: MxuScene, key_words, lamp_xyz, light_length, n: int, *,
                                 packet: int = PACKET, height_bands: int = 4,
                                 with_rays: bool = False, with_visits: bool = False):
    """Plain PyTorch version of `fused_trace_counts` on the scene's device."""
    dev = scene.feat.device
    packet, g, _ = _launch_shape(n, packet, height_bands)
    orig, direction, pb = generate_fused_rays(key_words, lamp_xyz, light_length, n, packet=packet,
                                              height_bands=height_bands, device=dev)
    res = _trace_reference(scene, orig, direction, packet, pb=pb if with_visits else None)
    t, slot = res[0], res[1]
    counts = torch.bincount(slot[slot >= 0].long(), minlength=scene.tri_idx_flat.shape[0])
    out = (t, slot, counts.to(torch.int32))
    if with_rays:
        out += (orig, direction)
    if with_visits:
        out += (res[2],)
    return out


def traverse_mxu_padded_reference(scene: MxuScene, orig: torch.Tensor, direction: torch.Tensor, *,
                                  packet: int = PACKET, with_counts: bool = False,
                                  with_visits: bool = False):
    """Plain PyTorch version of `traverse_mxu_padded` on the rays' device:
    t, slot and counts from the brute-force `closest_hits`; visits from the
    kernel's walk replayed in lockstep (`walk_tests`)."""
    packet, _ = _packets(orig.shape[0], packet)
    res = _trace_reference(scene, orig, direction, packet, walk=with_visits)
    out = res[:2]
    if with_counts:
        out += (hit_histogram_reference(res[1], torch.zeros(scene.tri_idx_flat.shape[0], dtype=torch.int32,
                                                           device=orig.device)),)
    return out + res[2:]


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------


def fused_trace_counts(scene: MxuScene, key_words, lamp_xyz, light_length, n: int, *,
                       packet: int = PACKET, height_bands: int = 4,
                       with_rays: bool = False, with_visits: bool = False):
    """Generate n stratified rays from the key, trace them and histogram the
    hits per slot, in one kernel launch (replaces the TPU kernel of
    uvtrace/ops/traverse_mxu.py:807).

    key_words: the key's two uint32 words; lamp_xyz: host floats (x, y, z);
    light_length: rod length. Returns (t f32[n], slot i32[n], counts
    i32[L*C][, orig f32[n,3], dir f32[n,3]][, visits i32[n/packet]]), with
    (1e30, -1) on a miss. visits is the number of clusters each packet
    traced. A scene on the CPU runs the plain version; a CUDA scene runs the
    kernel (csrc/fused_trace.cu: a packet is one block of packet / 2 threads,
    or packet / 4 above 2048 rays, so packet is at most 4096; launches of up
    to 1024 packets trace their packets heaviest first) or raises."""
    dev = scene.feat.device
    if dev.type == "cpu":
        return fused_trace_counts_reference(
            scene, key_words, lamp_xyz, light_length, n, packet=packet,
            height_bands=height_bands, with_rays=with_rays, with_visits=with_visits)
    if dev.type != "cuda":
        raise ValueError(f"fused_trace_counts runs on cpu or cuda tensors, not {dev}")
    from uvtrace_torch import _build

    packet, g, (gh, gy, gphi) = _launch_shape(n, packet, height_bands)
    l_count, c_sz = scene.n_clusters, scene.cluster_size
    _build.check_tensor("scene.box6", scene.box6, torch.float32, (l_count, 6), dev)
    _build.check_tensor("scene.tri_feat", scene.tri_feat, torch.float32, (l_count, c_sz, KROWS, 4), dev)
    _build.check_tensor("scene.tri_used", scene.tri_used, torch.int32, (l_count,), dev)
    if packet > FUSED_MAX_PACKET:
        raise ValueError(f"packet={packet}: the kernel holds at most {FUSED_MAX_PACKET} rays a packet")
    lib = _build.load()
    smem = lib.fused_trace_smem_bytes(l_count, c_sz)
    if smem > _build.MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"scene of {l_count} clusters of {c_sz} needs {smem} bytes of shared memory; "
            f"the kernel holds at most {_build.MAX_DYNAMIC_SMEM}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(l_count * c_sz, dtype=torch.int32, device=dev)
    visits = torch.empty(g, dtype=torch.int32, device=dev)
    # scratch for the launch's heavy-first packet order (the kernel's helper kernels fill it)
    order = torch.empty(2 * g, dtype=torch.int32, device=dev)
    orig = torch.empty((n, 3), dtype=torch.float32, device=dev) if with_rays else None
    direction = torch.empty((n, 3), dtype=torch.float32, device=dev) if with_rays else None
    k0, k1 = (int(w) & _M32 for w in key_words)
    lx, ly, lz = (_F(v) for v in lamp_xyz)
    ptr = _build.ptr
    _build.launch("fused_trace_launch", dev, k0, k1, lx, ly, lz, _F(light_length), g, packet, gh, gy, gphi, l_count,
                  c_sz, ptr(scene.box6), ptr(scene.tri_feat), ptr(scene.tri_used), ptr(t), ptr(slot), ptr(counts),
                  ptr(orig), ptr(direction), ptr(visits), ptr(order), rays=n)
    out = (t, slot, counts)
    if with_rays:
        out += (orig, direction)
    if with_visits:
        out += (visits,)
    return out


def traverse_mxu_padded(scene: MxuScene, orig: torch.Tensor, direction: torch.Tensor, *,
                        packet: int = PACKET, with_counts: bool = False, with_visits: bool = False):
    """Closest hits of rays already in memory, each ray walking the scene's
    top tree on its own (replaces the TPU kernel of
    uvtrace/ops/traverse_mxu.py:445). Packets of `packet` rays (with the TPU
    wrapper's fallback) remain the unit of the statistic.

    orig, direction: f32[n, 3] on the scene's device. Returns (t f32[n], slot
    i32[n][, counts i32[L*C]][, visits i32[n/packet]]), with (1e30, -1) on a
    miss; counts histogram every ray's slot, visits count the (ray, leaf)
    tests of each packet's rays. Rays on the CPU run the plain version; CUDA
    rays run the kernel (csrc/traverse_mxu.cu) or raise."""
    dev = scene.feat.device
    n = orig.shape[0]
    packet, g = _packets(n, packet)
    if orig.device != dev or direction.device != dev:
        raise ValueError(f"rays on {orig.device}/{direction.device}, scene on {dev}")
    if dev.type == "cpu":
        return traverse_mxu_padded_reference(scene, orig, direction, packet=packet,
                                             with_counts=with_counts, with_visits=with_visits)
    if dev.type != "cuda":
        raise ValueError(f"traverse_mxu_padded runs on cpu or cuda tensors, not {dev}")
    if scene.depth > STACK_DEPTH:
        raise ValueError(f"top tree of depth {scene.depth} exceeds the kernel's stack of {STACK_DEPTH}")
    from uvtrace_torch import _build

    l_count, c_sz = scene.n_clusters, scene.cluster_size
    n_nodes = scene.node_meta.shape[0] // 2
    _build.check_tensor("scene.node_box", scene.node_box, torch.float32, (8 * n_nodes,), dev)
    _build.check_tensor("scene.node_meta", scene.node_meta, torch.int32, (2 * n_nodes,), dev)
    _build.check_tensor("scene.tri_feat", scene.tri_feat, torch.float32, (l_count, c_sz, KROWS, 4), dev)
    _build.check_tensor("orig", orig, torch.float32, (n, 3), dev)
    _build.check_tensor("direction", direction, torch.float32, (n, 3), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(l_count * c_sz, dtype=torch.int32, device=dev) if with_counts else None
    visits = torch.zeros(g, dtype=torch.int32, device=dev)
    ptr = _build.ptr
    _build.launch("traverse_mxu_launch", dev, ptr(orig), ptr(direction), n, packet, c_sz, ptr(scene.node_box),
                  ptr(scene.node_meta), ptr(scene.tri_feat), ptr(t), ptr(slot), ptr(counts), ptr(visits), rays=n)
    out = (t, slot)
    if with_counts:
        out += (counts,)
    if with_visits:
        out += (visits,)
    return out


def traverse_mxu_slots(scene: MxuScene, orig, direction, *, packet: int = PACKET):
    """(t, slot) of rays in memory: padded cluster slots cid * C + lane, -1
    on a miss (uvtrace/ops/traverse_mxu.py:596). Bounce segments take
    packet=4096, coherent rays 1024."""
    return traverse_mxu_padded(scene, orig, direction, packet=packet)


def traverse_mxu_counts(scene: MxuScene, orig, direction, *, packet: int = PACKET):
    """(t, slot, counts i32[L*C]) with every ray's slot histogrammed in the
    kernel (uvtrace/ops/traverse_mxu.py:562)."""
    return traverse_mxu_padded(scene, orig, direction, packet=packet, with_counts=True)


def traverse_mxu(scene: MxuScene, orig, direction, *, packet: int = PACKET):
    """(t, original triangle id) of rays in memory, -1 on a miss
    (uvtrace/ops/traverse_mxu.py:541): the slots remapped through
    tri_idx_flat."""
    t, slot = traverse_mxu_slots(scene, orig, direction, packet=packet)
    hit = torch.where(slot >= 0, scene.tri_idx_flat[slot.clamp_min(0).long()], -1)
    return t, hit
