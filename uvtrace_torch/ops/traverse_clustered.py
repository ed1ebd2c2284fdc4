"""Two-phase clustered traversal (uvtrace/ops/traverse_clustered.py) in plain
torch, on the scene's device.

  phase 1: every 1024-ray packet is tested against every cluster box (a
           dense [packet, L] slab test); the nearest `max_clusters` clusters
           that any ray of the packet enters are kept, ordered by the
           packet's entry distance;
  phase 2: every ray of the packet is intersected with every (padded)
           triangle of those clusters, dense Möller–Trumbore over
           [packet, max_clusters * C], and the closest hit is the min/argmin.

Exact whenever a packet enters at most `max_clusters` clusters; otherwise the
clusters past the budget are dropped and counted in the overflow, which the
Simulator audits after every launch (sim/simulator.py). The JAX module is
plain jnp and so is this one: no kernel of its own, the dense formulation
runs as it is on the card.

Values follow the JAX module step for step: the same padding (whole packets
and whole groups of packets, dummy rays o = 0, d = (1, 0, 0), which count in
their packet's overflow), the same slab test and f32 Möller–Trumbore (ops/intersect.py),
the selection in lax.top_k's order (entry distances in IEEE total order, so
an entry of -0 before one of +0, and equal ones lower cluster index first: a
stable integer sort, since torch.topk leaves the order of ties open) and the
first minimum of the candidates (torch.min returns the first index of a tie,
as jnp.argmin does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uvtrace_torch.device import resolve
from uvtrace_torch.ops.cluster import ClusteredScene
from uvtrace_torch.ops.intersect import BIG, DET_EPS, T_MIN, safe_inv_dir

# the largest f32 [packets, packet, candidates] plane (and [packets, packet,
# 3 x clusters] of phase 1) one batch of packets makes; Möller–Trumbore holds
# about a dozen such planes at once, so a batch peaks near 3 GiB on the card
PLANE_BYTES = 1 << 28


class ClusterArrays(NamedTuple):
    """A clustered scene on one device."""

    v0: torch.Tensor  # f32[L, C, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    box_min: torch.Tensor  # f32[L, 3]
    box_max: torch.Tensor  # f32[L, 3]
    tri_idx: torch.Tensor  # i32[L, C] original triangle ids, -1 = padding

    @property
    def n_clusters(self) -> int:
        return int(self.tri_idx.shape[0])


def cluster_arrays(cs: ClusteredScene, device="cuda") -> ClusterArrays:
    """The arrays of a host `ClusteredScene` (ops/cluster.py, or JAX's
    numpy one: the same fields) on `device`; "cuda" raises without a card."""
    device = resolve(device)
    # writable copies: torch refuses to share a read-only numpy array
    to = lambda a, dtype: torch.from_numpy(np.array(a, dtype, order="C")).to(device)  # noqa: E731
    t = to(cs.tris, np.float32)
    return ClusterArrays(v0=t[:, :, 0].contiguous(), v1=t[:, :, 1].contiguous(), v2=t[:, :, 2].contiguous(),
                         box_min=to(cs.box_min, np.float32), box_max=to(cs.box_max, np.float32),
                         tri_idx=to(cs.tri_idx, np.int32))


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's f32 minimum: torch.minimum, but -0 below +0."""
    return torch.where(a == b, torch.where(torch.signbit(a), a, b), torch.minimum(a, b))


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's f32 maximum: torch.maximum, but +0 above -0."""
    return torch.where(a == b, torch.where(torch.signbit(a), b, a), torch.maximum(a, b))


def _packet_entries(o: torch.Tensor, inv: torch.Tensor, ca: ClusterArrays) -> torch.Tensor:
    """f32[G, L] the least entry distance of a packet's rays into each
    cluster box, 1e30 where none enters: ops/intersect.intersect_aabb with
    XLA's signed zeros, since the sign of a zero entry (a ray that starts on
    a box face) orders the clusters. XLA's min and max, elementwise and
    reduced, put -0 below +0; torch's keep whichever operand comes first."""
    t1 = (ca.box_min - o[:, :, None]) * inv[:, :, None]  # [G, P, L, 3]
    t2 = (ca.box_max - o[:, :, None]) * inv[:, :, None]
    lo, hi = _minimum(t1, t2), torch.maximum(t1, t2)
    tmin = _maximum(_maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = hi.amin(-1)
    tmin = torch.where((tmax >= tmin) & (tmin < BIG) & (tmax > 0), tmin, BIG)  # [G, P, L]
    entry = tmin.amin(1)
    neg_zero = ((tmin == 0) & torch.signbit(tmin)).any(1)
    return torch.where((entry == 0) & neg_zero, -0.0, entry)


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """i32 keys of f32 x in IEEE total order (-0 before +0), the order in
    which XLA's top_k ranks -x: an integer sort of them puts x ascending."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _select(ca: ClusterArrays, o: torch.Tensor, d: torch.Tensor, k: int):
    """Phase 1 of a batch of packets, o and d f32[G, P, 3]: (the k clusters
    of each packet in lax.top_k's order i64[G, k], whether a ray of the
    packet enters each bool[G, k], the clusters dropped i64[G])."""
    entry = _packet_entries(o, safe_inv_dir(d), ca)  # [G, L]
    idx = torch.sort(_total_order(entry), dim=1, stable=True).indices[:, :k]
    overflow = ((entry < BIG).sum(1) - k).clamp_min(0)
    return idx, entry.gather(1, idx) < BIG, overflow


def _moller_trumbore(o, d, v0, v1, v2) -> torch.Tensor:
    """ops/intersect.intersect_tri, component by component: the same f32
    products, sums (left to right) and tests, bit for bit, without the
    stacked [..., 3] temporaries."""
    o0, o1, o2 = o.unbind(-1)
    d0, d1, d2 = d.unbind(-1)
    a0, a1, a2 = v0.unbind(-1)
    e10, e11, e12 = (v1 - v0).unbind(-1)
    e20, e21, e22 = (v2 - v0).unbind(-1)
    h0, h1, h2 = d1 * e22 - d2 * e21, d2 * e20 - d0 * e22, d0 * e21 - d1 * e20
    a = e10 * h0 + e11 * h1 + e12 * h2
    zero = a == 0
    f = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, a))
    s0, s1, s2 = o0 - a0, o1 - a1, o2 - a2
    u = f * (s0 * h0 + s1 * h1 + s2 * h2)
    del h0, h1, h2
    q0, q1, q2 = s1 * e12 - s2 * e11, s2 * e10 - s0 * e12, s0 * e11 - s1 * e10
    del s0, s1, s2
    v = f * (d0 * q0 + d1 * q1 + d2 * q2)
    t = f * (e20 * q0 + e21 * q1 + e22 * q2)
    valid = (a.abs() >= DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(valid, t, BIG)


def _closest(ca: ClusterArrays, o, d, idx, valid, cut: bool):
    """Phase 2 of a batch of packets, o and d f32[G, P, 3], against the
    triangles of their candidate clusters idx i64[G, K] (valid bool[G, K]):
    (t f32[G, P], hit i32[G, P]). cut: candidates past these K were left out
    because they are all masked; JAX's min would see their 1e30."""
    c_size = ca.tri_idx.shape[1]
    g, k = idx.shape
    cand = [v[idx].reshape(g, 1, k * c_size, 3) for v in (ca.v0, ca.v1, ca.v2)]
    t = _moller_trumbore(o[:, :, None], d[:, :, None], *cand)  # [G, P, K*C]
    t = torch.where(valid.repeat_interleave(c_size, dim=1)[:, None, :], t, BIG)
    best, slot = t.min(2)
    if cut:
        best = best.clamp_max(BIG)
    hit = ca.tri_idx[idx.gather(1, slot // c_size), slot % c_size]
    return best, torch.where(best >= BIG, -1, hit)


def traverse_clustered(ca: ClusterArrays, orig: torch.Tensor, direction: torch.Tensor, *, packet: int = 1024,
                       max_clusters: int = 32, group: int = 16, return_overflow: bool = False, **_):
    """Closest hits of R rays over a clustered scene.

    orig, direction: f32[R, 3] on the scene's device; rays should be
    packet-coherent (stratified generation, or sorted) for a small budget to
    hold. max_clusters: the phase-2 cluster budget of a packet. group: as in
    JAX, R is padded to whole groups of `group` packets when it holds more
    than one group; it decides the padding, and so the overflow, but no t
    or hit.

    Phase 2 tests a packet's candidates only up to its last valid one: the
    ones past it are masked to 1e30 in JAX's [packet, k * C] plane and can
    neither be the minimum nor its first index. The packets run in batches
    of like candidate counts (sorted by it, one read of the counts from the
    device a call), each batch's [packets, packet, candidates] f32 plane under
    PLANE_BYTES (256 MiB). Neither changes a value.

    Returns (t f32[R], hit i32[R]) with (1e30, -1) on a miss, and with
    return_overflow the int32 count of clusters the budget dropped, summed
    over the packets (padding packets included): 0 means exact."""
    r, dev = orig.shape[0], orig.device
    l_count, c_size = ca.tri_idx.shape
    k = min(max_clusters, l_count)
    packet = min(packet, r)
    r_round = packet * -(-r // packet)
    if r_round // packet > group:
        r_round = packet * group * -(-r_round // (packet * group))
    pad = r_round - r
    if pad:
        orig = torch.cat([orig, orig.new_zeros(pad, 3)])
        direction = torch.cat([direction, direction.new_tensor([1.0, 0.0, 0.0]).expand(pad, 3)])
    g_total = r_round // packet
    o, d = orig.reshape(g_total, packet, 3), direction.reshape(g_total, packet, 3)
    step = max(1, PLANE_BYTES // (4 * packet * 3 * l_count))
    sel = [_select(ca, o[g:g + step], d[g:g + step], k) for g in range(0, g_total, step)]
    idx, valid, overflow = (torch.cat(parts) for parts in zip(*sel))
    # candidates a packet needs: up to its last valid one
    need = (valid * torch.arange(1, k + 1, device=dev)).amax(1).tolist()
    order = sorted(range(g_total), key=need.__getitem__)
    order_dev = torch.tensor(order, device=dev)
    t = torch.full((g_total, packet), BIG, device=dev)
    hit = torch.full((g_total, packet), -1, dtype=torch.int32, device=dev)
    i = next((i for i, g in enumerate(order) if need[g]), g_total)  # packets that enter no cluster miss
    while i < g_total:
        j = i + 1
        while j < g_total and (j + 1 - i) * packet * need[order[j]] * c_size * 4 <= PLANE_BYTES:
            j += 1
        kk, pk = need[order[j - 1]], order_dev[i:j]
        t[pk], hit[pk] = _closest(ca, o[pk], d[pk], idx[pk, :kk], valid[pk, :kk], kk < k)
        i = j
    t, hit = t.reshape(r_round)[:r], hit.reshape(r_round)[:r]
    if return_overflow:
        return t, hit, overflow.sum().to(torch.int32)
    return t, hit
