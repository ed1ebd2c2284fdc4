"""Differentiable dose estimator (uvtrace/diff/estimator.py) in torch
autograd.

The count-based estimator (photon hits per triangle) is piecewise constant
in the lamp parameters, so the differentiable layer uses the next-event
factorization E_t = G_t(theta) * V_t:

    E_t(theta) = P * mean_{r on rod, q on tri} [ V(r,q) * |cos theta_q| / (4 pi |q-r|^2) ]

  - G (geometry term): closed form in lamp x/z, rod base height, rod length
    and the triangle geometry;
  - V (visibility): binary occlusion from shadow rays traced by the split
    kernel (B2, csrc/traverse_mxu.cu; its plain version on the CPU), held
    piecewise constant, so no traversal is ever differentiated. Gradients
    are exact wherever visibility is locally constant; silhouette terms are
    ignored. With common random numbers (a fixed key) this matches finite
    differences of the same estimator away from silhouettes.

The direct estimator (`irradiance`, `_points_direct`) is one
`torch.autograd.Function`, diff/direct.py's `DirectIrradiance`: on the card
the kernels K7-K10 of csrc/diff_ops.cu around B2, forward and backward
(closed-form gradients with respect to the lamp, the rod and the power), on
the CPU their plain versions. The interreflection term's sources, its
source-to-source matrix and its receiver pass are diff/bounce.py's kernels
K11-K14 of csrc/bounce_ops.cu around B2 (`ReceiverTransfer`, one
`torch.autograd.Function`, differentiable in the sources' strengths); the
Neumann iteration on the matrix and the reflectances' gather stay torch
autograd. `_visibility` (no gradient at its inputs, the trace under
`torch.no_grad()`) is the visibility of any batch of shadow rays. A route's
transfer plan (diff/transfer.py) holds what the interreflection term
computes from the geometry and the keys alone, traced once a route:
`route_dose(transfer=...)` then traces only the rays that see the lamp.

Random numbers are the JAX package's: the keys of `split`, `fold_in` and
PRNGKey come from the host threefry (ops/rng.py), the uniforms are
bit-equal to jax.random.uniform, and the bounce estimator's area-weighted
source triangles are `jax.random.choice` with the cumulative sum in XLA:CPU's
order and the area total rounded once (`area_cdf`).

Units follow RayTracer::Shade (raytracer.cpp:96-116): irradiance (W/m^2)
times 100 is µW/cm^2; time-integrated and times 0.1, mJ/cm^2.
"""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from uvtrace_torch.bvh import native
from uvtrace_torch.device import resolve
from uvtrace_torch.diff.bounce import receiver_transfer, source_sample, transfer_matrix
from uvtrace_torch.diff.direct import PARK, SHADOW_PACKET, direct_irradiance, pack_sorted
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import coherence_key
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.traverse_clustered import ClusterArrays, cluster_arrays, traverse_clustered
from uvtrace_torch.ops.traverse_mxu import MxuScene, build_mxu_scene, traverse_mxu_slots
from uvtrace_torch.parallel.sharded import RAY_AXIS, Collectives, mesh_shape
from uvtrace_torch.utils.timing import count, setup_span, span


class DiffScene(NamedTuple):
    """Static geometry of the differentiable estimator on one device."""

    v0: torch.Tensor  # f32[T,3]
    e1: torch.Tensor  # f32[T,3] v1 - v0
    e2: torch.Tensor  # f32[T,3] v2 - v0
    normal: torch.Tensor  # f32[T,3] unit normals
    trav_scene: MxuScene | ClusterArrays  # the occluders of the shadow rays
    extend_fn: Callable  # (trav_scene, orig f32[R,3], dir f32[R,3]) -> (t f32[R], hit i32[R])
    # the direct estimator's trace: (trav_scene, origins f32[S,3], dir
    # f32[S*M,3], sort key i32[S*M]) -> (t f32[N] of the traced batch, i32[S*M]
    # each ray's position in it); `trace_sorted` or `trace_in_order`
    trace_fn: Callable
    # B2's padded slot -> triangle id (-1 for padding), None where hits are
    # triangle ids (the clustered traversal); visibility never needs it, the
    # dose-image planner (diff/image.py) does
    slot_to_tri: torch.Tensor | None
    # the bounce estimator's source cumulative sums, by the digest of the areas (`_source_cdf`)
    source_cdfs: dict


def make_diff_scene(mesh, max_clusters=None, backend: str = "auto", precision: str = "high",
                    device_mesh=None, device="cuda") -> DiffScene:
    """The differentiable scene of `mesh` on `device`. Shadow rays go through
    the split kernel B2 (`backend` "auto" or "mxu": 128-triangle clusters,
    from the native builder where it compiles, `build_mxu_scene`), or with
    backend="clustered" through the clustered traversal
    (ops/traverse_clustered.py) over the same clusters, at `max_clusters`
    clusters a packet (None: all of them, budget-free; shadow-ray packets
    span the room, and a budget would drop occluders silently, as in
    uvtrace/diff/estimator.py:147-157). Every `precision` computes in f32, as
    the Simulator does. device="cuda" raises when torch sees no card; "cpu"
    runs B2's plain version.

    device_mesh: a 1-D ('rays',) torch.distributed DeviceMesh. Every rank
    builds the scene and runs the same objective on its own device; each
    shadow-ray batch is padded to 1024 x ranks, every rank traces its slice
    and the (t, hit) slices are all_gathered (uvtrace/diff/estimator.py:
    161-214), so every rank sees the whole batch. Visibility is per ray, so
    losses and gradients are bit-identical to the one-device scene."""
    if backend not in ("auto", "mxu", "clustered"):
        raise ValueError(f"backend must be 'auto', 'mxu' or 'clustered', got {backend!r}")
    if precision not in ("highest", "high", "fast"):
        raise ValueError(f"precision must be 'highest', 'high' or 'fast', got {precision!r}")
    collectives = None
    if device_mesh is not None:
        if mesh_shape(device_mesh)[1] != 1:
            raise ValueError("make_diff_scene shards shadow rays over a 1-D ('rays',) mesh; build one with "
                             "uvtrace_torch.parallel.make_ray_mesh")
        collectives = Collectives(device_mesh)
    device = resolve(device)
    tris = torch.from_numpy(np.asarray(mesh.tris, np.float32)).to(device)
    v0, v1, v2 = (tris[:, k].contiguous() for k in range(3))  # rows the kernels read
    e1, e2 = v1 - v0, v2 - v0
    n = torch.cross(e1, e2, dim=-1)
    n = n / torch.clamp_min(torch.sqrt((n * n).sum(-1, keepdim=True)), 1e-20)
    build = native.build_clusters_native if native.available() else build_clusters
    with setup_span("setup.clusters", triangles=len(mesh.tris)):
        clusters = build(mesh.tris, cluster_size=128)
    if backend == "clustered":
        trav = cluster_arrays(clusters, device=device)
        budget = clusters.n_clusters if max_clusters is None else max_clusters
        extend = functools.partial(extend_clustered, max_clusters=budget, collectives=collectives)
        trace = functools.partial(trace_in_order, extend=extend)
        slot_to_tri = None
    else:
        with setup_span("setup.scene_tables"):
            trav = build_mxu_scene(clusters, device=device)
        extend = functools.partial(extend_shadow_rays, collectives=collectives)
        trace = functools.partial(trace_sorted, collectives=collectives)
        slot_to_tri = trav.tri_idx_flat
    return DiffScene(v0=v0, e1=e1, e2=e2, normal=n, trav_scene=trav, extend_fn=extend, trace_fn=trace,
                     slot_to_tri=slot_to_tri, source_cdfs={})


def pack_shadow_rays(orig: torch.Tensor, dirs: torch.Tensor, multiple: int = SHADOW_PACKET):
    """The batch B2 traces for R rays: (orig, dir) f32[R + pad, 3]
    coherence-sorted (direction octant, origin cell) so that a packet's rays
    start near each other, padded to a multiple of `multiple` (whole
    1024-ray packets, on every rank of a sharded scene) with parked rays
    (origin 1e6, direction (0, 1, 0)), and i32[R] the batch position of
    each input ray: `coherence_key`, a stable sort (the span `diff.sort`),
    and K7 (`pack_sorted`)."""
    key = coherence_key(orig, dirs, torch.ones(orig.shape[0], dtype=torch.bool, device=orig.device))
    with span("diff.sort"):
        perm = torch.sort(key, stable=True).indices
    return pack_sorted(perm, orig, dirs, multiple)


def _shards(collectives: Collectives) -> int:
    return 1 if collectives is None else collectives.mesh.size(0)


def _trace_batch(trav: MxuScene, o: torch.Tensor, d: torch.Tensor, collectives: Collectives = None):
    """(t f32[N], slot i32[N]) of a packed batch through B2; with the
    `Collectives` of a 1-D ray mesh this rank traces its slice and the
    slices are all_gathered."""
    if collectives is None:
        return traverse_mxu_slots(trav, o, d, packet=SHADOW_PACKET)
    k = o.shape[0] // _shards(collectives)
    i = collectives.mesh.get_local_rank(RAY_AXIS)
    t_s, slot_s = traverse_mxu_slots(trav, o[i * k:(i + 1) * k], d[i * k:(i + 1) * k], packet=SHADOW_PACKET)
    return collectives.all_gather(t_s, RAY_AXIS), collectives.all_gather(slot_s, RAY_AXIS)


def extend_shadow_rays(trav: MxuScene, orig: torch.Tensor, dirs: torch.Tensor, collectives: Collectives = None):
    """Closest hits (t f32[R], padded slot i32[R]) of R rays in their input
    order, through B2: the batch of `pack_shadow_rays`, traced, and read
    back at each ray's batch position. Slots are never remapped:
    visibility reads only t. With the `Collectives` of a 1-D ray mesh, this
    rank traces its slice of the batch and the slices are all_gathered."""
    o, d, inverse = pack_shadow_rays(orig, dirs, SHADOW_PACKET * _shards(collectives))
    t, slot = _trace_batch(trav, o, d, collectives)
    return t.index_select(0, inverse), slot.index_select(0, inverse)


def trace_sorted(trav: MxuScene, orig: torch.Tensor, dirs: torch.Tensor, sort_key: torch.Tensor,
                 collectives: Collectives = None):
    """The direct estimator's trace through B2: the rays (origin row i //
    (R / origins)) in the order of a stable sort on `sort_key`, packed by K7
    into whole packets, traced. Returns (t f32[N], i32[R] each ray's
    position in t). The sort is the span `diff.sort`."""
    with span("diff.sort"):
        perm = torch.sort(sort_key, stable=True).indices
    o, d, inverse = pack_sorted(perm, orig, dirs, SHADOW_PACKET * _shards(collectives))
    return _trace_batch(trav, o, d, collectives)[0], inverse


def trace_in_order(trav, orig: torch.Tensor, dirs: torch.Tensor, sort_key: torch.Tensor, *, extend: Callable):
    """The direct estimator's trace through `extend` (the clustered
    traversal), its rays unsorted as JAX traces them; the sort key is not
    used. Returns (t f32[R], i32[R] each ray's position in t)."""
    o, d, inverse = pack_sorted(None, orig, dirs, 1)
    return extend(trav, o, d)[0], inverse


def extend_clustered(ca: ClusterArrays, orig: torch.Tensor, dirs: torch.Tensor, *, max_clusters: int,
                     collectives: Collectives = None):
    """Closest hits (t f32[R], triangle id i32[R]) of R rays in their input
    order through the clustered traversal, unsorted, as JAX traces them.
    With the `Collectives` of a 1-D ray mesh the batch is padded with parked
    rays to whole 1024-ray packets on every rank, this rank traces its
    slice, and the slices are all_gathered (uvtrace/diff/estimator.py:
    208-214)."""
    if collectives is None:
        return traverse_clustered(ca, orig, dirs, max_clusters=max_clusters)
    r, shards = orig.shape[0], collectives.mesh.size(0)
    pad = (-r) % (SHADOW_PACKET * shards)
    if pad:
        park = dirs.new_zeros((pad, 3))
        park[:, 1] = 1.0
        orig = torch.cat([orig, orig.new_full((pad, 3), PARK)])
        dirs = torch.cat([dirs, park])
    k = orig.shape[0] // shards
    i = collectives.mesh.get_local_rank(RAY_AXIS)
    t, hit = traverse_clustered(ca, orig[i * k:(i + 1) * k], dirs[i * k:(i + 1) * k], max_clusters=max_clusters)
    return collectives.all_gather(t, RAY_AXIS)[:r], collectives.all_gather(hit, RAY_AXIS)[:r]


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """x as an f32 tensor on like's device (a tensor keeps its graph)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _rod_points(lamp_xz, rod_base_y, rod_length, u_rod):
    """f32[R,1,3] points on the vertical rod at heights base + u * length."""
    n = u_rod.shape[0]
    return torch.cat([lamp_xz[0].expand(n, 1), rod_base_y + u_rod * rod_length, lamp_xz[1].expand(n, 1)],
                     dim=-1)[:, None, :]


def shadow_rays(rod_points, qs):
    """(orig f32[S*T,3], unit dir f32[S*T,3], dist f32[S,T]) of the shadow
    rays from points r (broadcastable to qs) to surface points q
    f32[S,T,3]."""
    d = qs - rod_points
    dist = torch.sqrt((d * d).sum(-1))
    direction = d / torch.clamp_min(dist[..., None], 1e-20)
    s, t_count = qs.shape[0], qs.shape[1]
    return rod_points.expand(qs.shape).reshape(s * t_count, 3), direction.reshape(s * t_count, 3), dist


def visible(t_hit, dist, eps: float = 1e-3):
    """f32 1 where nothing lies closer than the target point, within the
    tolerance: t >= dist (1 - eps) - eps."""
    return (t_hit.view(dist.shape) >= dist * (1.0 - eps) - eps).to(torch.float32)


def _visibility(scene: DiffScene, rod_points, qs, eps: float = 1e-3):
    """Binary visibility f32[S,T] between points r (broadcastable to qs) and
    surface points q f32[S,T,3]: 1 if the shadow ray reaches q before any
    other hit. Gradients are cut at the inputs, and the trace runs under
    no_grad: the piecewise-constant contract, and no traversal is ever
    differentiated."""
    with torch.no_grad():
        orig, direction, dist = shadow_rays(rod_points.detach(), qs.detach())
        return visible(scene.extend_fn(scene.trav_scene, orig, direction)[0], dist, eps)


def irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, key, *, n_samples: int = 8):
    """Differentiable per-triangle irradiance E_t in W/m^2, f32[T].

    lamp_xz: f32[2] lamp floor position (differentiable); rod_base_y: rod
    base height (floor + light_height); rod_length (m); power P (W); key:
    two uint32 words, fixed for common random numbers; n_samples: (rod
    point, triangle point) pairs per triangle. One `DirectIrradiance`
    (diff/direct.py): rod_base_y, rod_length and power are differentiable
    where they are tensors; the geometry is not."""
    return direct_irradiance(scene, (scene.v0, scene.e1, scene.e2, scene.normal), _as_tensor(lamp_xz, scene.v0),
                             rod_base_y, rod_length, power, key, n_samples)


def _points_direct(scene: DiffScene, pts, normals, lamp_xz, rod_base_y, rod_length, power, key, n_rod: int):
    """Differentiable direct irradiance f32[M] at surface points pts f32[M,3]
    with unit normals f32[M,3]: `irradiance`'s estimator, point-wise, its n_rod
    rod heights drawn from key. Raises where the points or normals require a
    gradient (the Function gives none)."""
    return direct_irradiance(scene, (pts.contiguous(), normals.contiguous()), _as_tensor(lamp_xz, scene.v0),
                             rod_base_y, rod_length, power, key, n_rod)


def area_cdf(areas):
    """(cumulative sum f32[T], area total as an f32 number) of the bounce
    estimator's area-weighted source choice, on the host. probs = areas /
    total in f32; total is the f32 rounding of the exact sum (XLA:CPU's tree
    reduction, `jnp.sum` there, gives the same total on the test room and
    the box rooms); the cumulative sum is `rng.cumsum_f32`'s, XLA:CPU's."""
    areas = np.ascontiguousarray(areas, np.float32)
    total = np.float32(math.fsum(areas.astype(np.float64)))
    return rng.cumsum_f32(areas / total), float(total)


def areas_digest(areas) -> tuple[np.ndarray, str]:
    """(areas f32[T] on the host, the digest that names them)."""
    if isinstance(areas, torch.Tensor):
        areas = areas.detach().cpu().numpy()
    areas = np.ascontiguousarray(areas, np.float32)
    return areas, hashlib.sha1(areas.tobytes()).hexdigest()


def _source_cdf(scene: DiffScene, areas):
    """`area_cdf` with the cumulative sum on the scene's device, kept on the
    scene by the areas' digest: they are static, so a step copies nothing
    to the device."""
    areas, key = areas_digest(areas)
    if key not in scene.source_cdfs:
        cdf, total = area_cdf(areas)
        scene.source_cdfs[key] = (torch.from_numpy(cdf).to(scene.v0.device), total)
    return scene.source_cdfs[key]


def source_points(scene: DiffScene, areas, keys, n_sources: int):
    """The virtual point lights of keys (`source_sample`, K11 on the card):
    (source triangles i64[M], x_m f32[M,3], n_m f32[M,3], the weight w =
    area total / M)."""
    cdf, total = _source_cdf(scene, areas)
    src, x_m, n_m = source_sample((keys[0], keys[1]), n_sources, cdf, (scene.v0, scene.e1, scene.e2, scene.normal))
    return src, x_m, n_m, float(np.float32(total) / np.float32(n_sources))


def _source_field(scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, keys, *,
                  n_samples, n_sources, n_bounces, transfer=None):
    """The virtual-point-light field: area-weighted source points x_m with
    normals (`source_points`), and each source's exitance strength rho_m *
    sum_k E_k(m) after n_bounces - 1 applications of the M x M Lambertian
    transfer matrix (`transfer_matrix`: K12, the trace and K13). transfer:
    the waypoint's `WaypointTransfer` (diff/transfer.py), which holds the
    sources and the matrix of these keys; None draws and traces them.
    Returns (x_m, n_m, strength, w)."""
    if transfer is None:
        src, x_m, n_m, w = source_points(scene, areas, keys, n_sources)
    else:
        src, x_m, n_m, w = transfer.src, transfer.x_m, transfer.n_m, transfer.w
    rho_m = _as_tensor(reflectance, scene.v0)[src]

    e_dir = _points_direct(scene, x_m, n_m, lamp_xz, rod_base_y, rod_length, power, keys[2],
                           n_rod=max(4, n_samples))  # [M]
    e_sum = e_dir
    if n_bounces > 1:
        # F[m', m], zero diagonal
        f_ss = transfer_matrix(scene, x_m, n_m) if transfer is None else transfer.f_ss
        e_k = e_dir
        for _ in range(1, n_bounces):
            e_k = w * ((rho_m * e_k) @ f_ss)  # E_k(m)
            e_sum = e_sum + e_k
    return x_m, n_m, rho_m * e_sum, w


SOURCE_CHUNK = 16  # sources a chunk of the receivers' transfer pass


def bounce_irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key, *,
                      n_samples: int = 4, n_sources: int = 64, n_bounces: int = 1, source_chunk: int = SOURCE_CHUNK,
                      transfer=None):
    """Differentiable multi-bounce (diffuse interreflection) irradiance
    sum_{k=1..n_bounces} E^k_t in W/m^2, f32[T], with per-triangle
    reflectance f32[T] and triangle areas f32[T] (mesh.areas, static).

    Virtual point lights: area-weighted source points x_m (probability
    proportional to A_s, weight w = A_total / M) carry E_0(m) = E_dir(x_m)
    and E_k(m) = w sum_{m' != m} rho_m' E_{k-1}(m') F(x_m', x_m), F the
    Lambertian form factor cos cos / (pi d^2) V; the receivers (a point on
    every triangle a sample, drawn from the key in K12) take one chunked
    transfer pass of the summed exitance (`ReceiverTransfer`, diff/bounce.py).
    Gradients are exact polynomials in `reflectance`; lamp, rod and power
    gradients flow through E_dir with the same visibility contract as
    `irradiance`.

    transfer: the `WaypointTransfer` of this key and these sizes (a route's
    plan, diff/transfer.py): its sources, source-to-source matrix and
    receivers' visibility bytes stand for their draws and traces, bit for
    bit; only the lamp's rays are traced. None draws and traces them."""
    keys = rng.split(key, 4)
    x_m, n_m, strength, w = _source_field(
        scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, keys,
        n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces, transfer=transfer)
    acc = receiver_transfer(scene, strength, (x_m, n_m), keys[3], n_samples,
                            (scene.v0, scene.e1, scene.e2, scene.normal), source_chunk,
                            None if transfer is None else transfer.vis)
    return w * torch.mean(acc.view(n_samples, scene.v0.shape[0]), dim=0)


def one_bounce_irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key, *,
                          n_samples: int = 4, n_sources: int = 64):
    """The one-bounce case of `bounce_irradiance`."""
    return bounce_irradiance(scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key,
                             n_samples=n_samples, n_sources=n_sources, n_bounces=1)


def route_dose(scene: DiffScene, waypoints_xz, durations, rod_base_y, rod_length, power, key, *,
               n_samples: int = 8, reflectance=None, areas=None, n_sources: int = 64, n_bounces: int = 1,
               transfer=None):
    """Differentiable cumulative dose [mJ/cm^2] over a route, f32[T]:

        dose_t = 0.1 * sum_w duration_w * E_t(lamp_w)   (Report §3 Eq. 1 units)

    waypoints_xz f32[W,2] and durations f32[W] are differentiable; waypoint
    w draws from fold_in(key, w). reflectance (f32[T], needs `areas`) adds
    the differentiable interreflection terms, from fold_in(fold_in(key, w), 1).

    transfer: a `RouteTransfer` (diff/transfer.py) of this scene, key, areas,
    waypoint count and sizes, whose per-waypoint sources, matrix and
    receivers' visibility stand for their draws and traces (the counter
    `diff.transfer.served`, a waypoint); the result is the same bit for bit.
    One built for other inputs raises ValueError."""
    if reflectance is not None and areas is None:
        raise ValueError("route_dose(reflectance=...) needs areas=mesh.areas")
    waypoints_xz = _as_tensor(waypoints_xz, scene.v0)
    durations = _as_tensor(durations, scene.v0)
    if transfer is not None:
        if reflectance is None:
            raise ValueError("route_dose(transfer=...) serves the interreflection term: give reflectance")
        transfer.check(scene, key, waypoints_xz.shape[0], areas, n_samples=n_samples, n_sources=n_sources,
                       n_bounces=n_bounces)
    acc = torch.zeros(scene.v0.shape[0], device=scene.v0.device)
    for w in range(waypoints_xz.shape[0]):
        with span("diff.waypoint", w=w):
            kw = rng.fold_in(key, w)
            e = irradiance(scene, waypoints_xz[w], rod_base_y, rod_length, power, kw, n_samples=n_samples)
            if reflectance is not None:
                planned = None if transfer is None else transfer.waypoints[w]
                e = e + bounce_irradiance(scene, waypoints_xz[w], rod_base_y, rod_length, power, reflectance, areas,
                                          rng.fold_in(kw, 1), n_samples=n_samples, n_sources=n_sources,
                                          n_bounces=n_bounces, transfer=planned)
                if planned is not None:
                    count("diff.transfer.served")
            acc = acc + durations[w] * e
    return 0.1 * acc
