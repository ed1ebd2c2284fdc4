"""Differentiable dose estimator (uvtrace/diff/estimator.py) in torch
autograd.

The count-based estimator (photon hits per triangle) is piecewise constant
in the lamp parameters, so the differentiable layer uses the next-event
factorization E_t = G_t(theta) * V_t:

    E_t(theta) = P * mean_{r on rod, q on tri} [ V(r,q) * |cos theta_q| / (4 pi |q-r|^2) ]

  - G (geometry term): closed form in lamp x/z, rod base height, rod length
    and the triangle geometry, differentiated exactly by autograd;
  - V (visibility): binary occlusion from shadow rays traced by the split
    kernel (B2, csrc/traverse_mxu.cu; its plain version on the CPU), held
    piecewise constant: `_visibility` detaches its inputs and runs under
    `torch.no_grad()`, so no traversal is ever differentiated. Gradients are
    exact wherever visibility is locally constant; silhouette terms are
    ignored. With common random numbers (a fixed key) this matches finite
    differences of the same estimator away from silhouettes.

Random numbers are the JAX package's: the keys of `split`, `fold_in` and
PRNGKey come from the host threefry (ops/rng.py), the uniforms are
bit-equal to jax.random.uniform, and the bounce estimator's area-weighted
source triangles are `jax.random.choice` with the cumulative sum in XLA:CPU's
order and the area total rounded once (`area_cdf`).

Units follow RayTracer::Shade (raytracer.cpp:96-116): irradiance (W/m^2)
times 100 is µW/cm^2; time-integrated and times 0.1, mJ/cm^2.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import coherence_sort
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.traverse_mxu import MxuScene, build_mxu_scene, traverse_mxu_slots

SHADOW_PACKET = 1024  # shadow rays are traced in 1024-ray packets (uvtrace/diff/estimator.py:129-132)
_PARK = 1e6  # origin coordinate of the padding rays, far outside the scene


class DiffScene(NamedTuple):
    """Static geometry of the differentiable estimator on one device."""

    v0: torch.Tensor  # f32[T,3]
    e1: torch.Tensor  # f32[T,3] v1 - v0
    e2: torch.Tensor  # f32[T,3] v2 - v0
    normal: torch.Tensor  # f32[T,3] unit normals
    trav_scene: MxuScene  # the occluders of the shadow rays
    extend_fn: Callable  # (trav_scene, orig f32[R,3], dir f32[R,3]) -> (t f32[R], slot i32[R])
    # padded slot -> triangle id (-1 for padding); visibility never needs
    # it, the dose-image planner (diff/image.py) does
    slot_to_tri: torch.Tensor
    # the bounce estimator's source cumulative sums, by the digest of the areas (`_source_cdf`)
    source_cdfs: dict


def make_diff_scene(mesh, max_clusters=None, backend: str = "auto", precision: str = "high",
                    device_mesh=None, device="cuda") -> DiffScene:
    """The differentiable scene of `mesh` on `device`. Shadow rays go through
    the split kernel B2 (`backend` "auto" or "mxu": 128-triangle clusters,
    `build_mxu_scene`); "clustered" and a `max_clusters` budget raise
    NotImplementedError (ROADMAP A4), `device_mesh` too (A13). Every
    `precision` computes in f32, as the Simulator does. device="cuda"
    raises when torch sees no card; "cpu" runs B2's plain version."""
    for name, value, item in (("max_clusters", max_clusters, "A4"), ("device_mesh", device_mesh, "A13")):
        if value is not None:
            raise NotImplementedError(f"{name}= is not ported yet (ROADMAP {item})")
    if backend == "clustered":
        raise NotImplementedError("backend='clustered' is not ported yet (ROADMAP A4); 'auto' and 'mxu' "
                                  "trace shadow rays with the split kernel")
    if backend not in ("auto", "mxu"):
        raise ValueError(f"backend must be 'auto', 'mxu' or 'clustered', got {backend!r}")
    if precision not in ("highest", "high", "fast"):
        raise ValueError(f"precision must be 'highest', 'high' or 'fast', got {precision!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch sees no CUDA device; pass device='cpu' "
                           "to run the plain PyTorch version")
    tris = torch.from_numpy(np.asarray(mesh.tris, np.float32)).to(device)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    n = torch.cross(e1, e2, dim=-1)
    n = n / torch.clamp_min(torch.sqrt((n * n).sum(-1, keepdim=True)), 1e-20)
    trav = build_mxu_scene(build_clusters(mesh.tris, cluster_size=128), device=device)
    return DiffScene(v0=v0, e1=e1, e2=e2, normal=n, trav_scene=trav, extend_fn=extend_shadow_rays,
                     slot_to_tri=trav.tri_idx_flat, source_cdfs={})


def pack_shadow_rays(orig: torch.Tensor, dirs: torch.Tensor):
    """The batch B2 traces for R rays: (orig, dir) f32[R + pad, 3]
    coherence-sorted (direction octant, origin cell) so that a packet's rays
    start near each other, padded to whole 1024-ray packets with parked rays
    (origin 1e6, direction (0, 1, 0)), and i64[R] the input position of
    each sorted ray."""
    r = orig.shape[0]
    idx = torch.arange(r, dtype=torch.int64, device=orig.device)
    o, d, _, idx_s = coherence_sort(orig, dirs, torch.ones(r, dtype=torch.bool, device=orig.device), index=idx)
    pad = (-r) % SHADOW_PACKET
    if pad:
        o = torch.cat([o, torch.full((pad, 3), _PARK, device=o.device)])
        d = torch.cat([d, torch.tensor([0.0, 1.0, 0.0], device=d.device).expand(pad, 3)])
    return o.contiguous(), d.contiguous(), idx_s


def extend_shadow_rays(trav: MxuScene, orig: torch.Tensor, dirs: torch.Tensor):
    """Closest hits (t f32[R], padded slot i32[R]) of R rays in their input
    order, through B2: the batch of `pack_shadow_rays`, traced, and
    scattered back by the index the sort carried. Slots are never remapped:
    visibility reads only t."""
    r = orig.shape[0]
    o, d, idx_s = pack_shadow_rays(orig, dirs)
    t_s, slot_s = traverse_mxu_slots(trav, o, d, packet=SHADOW_PACKET)
    t = torch.empty_like(t_s[:r]).index_copy_(0, idx_s, t_s[:r])
    slot = torch.empty_like(slot_s[:r]).index_copy_(0, idx_s, slot_s[:r])
    return t, slot


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """x as an f32 tensor on like's device (a tensor keeps its graph)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _rod_points(lamp_xz, rod_base_y, rod_length, u_rod):
    """f32[R,1,3] points on the vertical rod at heights base + u * length."""
    n = u_rod.shape[0]
    return torch.cat([lamp_xz[0].expand(n, 1), rod_base_y + u_rod * rod_length, lamp_xz[1].expand(n, 1)],
                     dim=-1)[:, None, :]


def _sample_triangle_points(scene: DiffScene, key, n_samples: int):
    """Uniform points on each triangle, q = v0 + u e1 + v e2 with (u, v)
    uniform on the unit triangle: f32[S,T,3], differentiable in geometry."""
    t_count = scene.v0.shape[0]
    ku, kv = rng.split(key)
    dev = scene.v0.device
    u = rng.uniform(ku, (n_samples, t_count, 1), dev)
    v = rng.uniform(kv, (n_samples, t_count, 1), dev)
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    return scene.v0[None] + u * scene.e1[None] + v * scene.e2[None]


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


def _geometry(pts, normals, rod_points):
    """The unoccluded point-to-rod term |cos| / (4 pi d^2): f32[R, M]."""
    d = pts - rod_points
    dist2 = (d * d).sum(-1)
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
    cos = torch.abs((d * normals).sum(-1)) / dist
    return cos / (4.0 * np.pi * torch.clamp_min(dist2, 1e-12))


def irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, key, *, n_samples: int = 8):
    """Differentiable per-triangle irradiance E_t in W/m^2, f32[T].

    lamp_xz: f32[2] lamp floor position (differentiable); rod_base_y: rod
    base height (floor + light_height); rod_length (m); power P (W); key:
    two uint32 words, fixed for common random numbers; n_samples: (rod
    point, triangle point) pairs per triangle."""
    keys = rng.split(key, 3)
    lamp_xz = _as_tensor(lamp_xz, scene.v0)
    qs = _sample_triangle_points(scene, keys[0], n_samples)  # [S,T,3]
    u_rod = rng.uniform(keys[1], (n_samples, 1), scene.v0.device)
    rod_points = _rod_points(lamp_xz, rod_base_y, rod_length, u_rod)  # [S,1,3]
    g = _geometry(qs, scene.normal[None], rod_points)  # [S,T]
    vis = _visibility(scene, rod_points, qs)
    return power * torch.mean(g * vis, dim=0)


def _points_direct(scene: DiffScene, pts, normals, lamp_xz, rod_base_y, rod_length, power, key, n_rod: int):
    """Differentiable direct irradiance f32[M] at surface points pts f32[M,3]
    with unit normals f32[M,3]: `irradiance`'s estimator, point-wise."""
    lamp_xz = _as_tensor(lamp_xz, scene.v0)
    u_rod = rng.uniform(key, (n_rod, 1), scene.v0.device)
    rod_points = _rod_points(lamp_xz, rod_base_y, rod_length, u_rod)  # [R,1,3]
    g = _geometry(pts[None], normals[None], rod_points)  # [R,M]
    qs = pts[None].expand((n_rod,) + tuple(pts.shape))
    vis = _visibility(scene, rod_points, qs)
    return power * torch.mean(g * vis, dim=0)


def area_cdf(areas):
    """(cumulative sum f32[T], area total as an f32 number) of the bounce
    estimator's area-weighted source choice, on the host. probs = areas /
    total in f32; total is the f32 rounding of the exact sum (XLA:CPU's tree
    reduction, `jnp.sum` there, gives the same total on the test room and
    the box rooms); the cumulative sum is `rng.cumsum_f32`'s, XLA:CPU's."""
    areas = np.ascontiguousarray(areas, np.float32)
    total = np.float32(math.fsum(areas.astype(np.float64)))
    return rng.cumsum_f32(areas / total), float(total)


def _source_cdf(scene: DiffScene, areas):
    """`area_cdf` with the cumulative sum on the scene's device, kept on the
    scene by the areas' digest: they are static, so a step copies nothing
    to the device."""
    if isinstance(areas, torch.Tensor):
        areas = areas.detach().cpu().numpy()
    areas = np.ascontiguousarray(areas, np.float32)
    key = hashlib.sha1(areas.tobytes()).hexdigest()
    if key not in scene.source_cdfs:
        cdf, total = area_cdf(areas)
        scene.source_cdfs[key] = (torch.from_numpy(cdf).to(scene.v0.device), total)
    return scene.source_cdfs[key]


def _source_field(scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, keys, *,
                  n_samples, n_sources, n_bounces):
    """The virtual-point-light field: area-weighted source points x_m with
    normals, and each source's exitance strength rho_m * sum_k E_k(m) after
    n_bounces - 1 applications of the M x M Lambertian transfer matrix.
    Returns (x_m, n_m, strength, w)."""
    dev = scene.v0.device
    cdf, total = _source_cdf(scene, areas)
    src = rng.choice_from_cdf(keys[0], (n_sources,), cdf)
    ku, kv = rng.split(keys[1])
    u = rng.uniform(ku, (n_sources, 1), dev)
    v = rng.uniform(kv, (n_sources, 1), dev)
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    x_m = scene.v0[src] + u * scene.e1[src] + v * scene.e2[src]  # [M,3]
    n_m = scene.normal[src]
    rho_m = _as_tensor(reflectance, scene.v0)[src]
    w = float(np.float32(total) / np.float32(n_sources))

    e_dir = _points_direct(scene, x_m, n_m, lamp_xz, rod_base_y, rod_length, power, keys[2],
                           n_rod=max(4, n_samples))  # [M]
    e_sum = e_dir
    if n_bounces > 1:
        # source-to-source transfer F[m', m]: one M^2 shadow-ray batch, zero diagonal
        d_ss = x_m[None] - x_m[:, None]  # [M',M,3]
        dist2_ss = (d_ss * d_ss).sum(-1)
        dist_ss = torch.sqrt(torch.clamp_min(dist2_ss, 1e-12))
        cos_src = torch.abs((d_ss * n_m[:, None, :]).sum(-1)) / dist_ss
        cos_rcv = torch.abs((d_ss * n_m[None, :, :]).sum(-1)) / dist_ss
        vis_ss = _visibility(scene, x_m[:, None, :], x_m[None].expand(n_sources, n_sources, 3))
        eye = torch.eye(n_sources, device=dev)
        f_ss = cos_src * cos_rcv / (np.pi * torch.clamp_min(dist2_ss, 1e-12)) * vis_ss * (1.0 - eye)
        e_k = e_dir
        for _ in range(1, n_bounces):
            e_k = w * ((rho_m * e_k) @ f_ss)  # E_k(m)
            e_sum = e_sum + e_k
    return x_m, n_m, rho_m * e_sum, w


def _receiver_transfer(scene, pts, normals, x_m, n_m, strength, source_chunk):
    """sum_m strength_m F(x_m, p) f32[P] at receiver points pts f32[P,3] with
    unit normals f32[P,3] (times w outside), over chunks of source_chunk
    sources: a chunk's shadow rays are [chunk * P]. The sources are padded
    to whole chunks with zero strength."""
    n_sources = x_m.shape[0]
    p_count = pts.shape[0]
    chunk = max(1, min(source_chunk, n_sources))
    pad = (-n_sources) % chunk
    if pad:  # weight 0: no contribution
        x_m = torch.cat([x_m, x_m[:1].expand(pad, 3)])
        n_m = torch.cat([n_m, n_m[:1].expand(pad, 3)])
        strength = torch.cat([strength, strength.new_zeros(pad)])
    parts = []
    for c0 in range(0, x_m.shape[0], chunk):
        x_c, n_c, s_c = x_m[c0:c0 + chunk], n_m[c0:c0 + chunk], strength[c0:c0 + chunk]
        d = pts[None] - x_c[:, None, :]  # [B,P,3]
        dist2 = (d * d).sum(-1)
        dist = torch.sqrt(torch.clamp_min(dist2, 1e-12))
        cos_m = torch.abs((d * n_c[:, None, :]).sum(-1)) / dist
        cos_p = torch.abs((d * normals[None]).sum(-1)) / dist
        vis = _visibility(scene, x_c[:, None, :], pts[None].expand(chunk, p_count, 3))
        transfer = cos_m * cos_p / (np.pi * torch.clamp_min(dist2, 1e-12)) * vis
        parts.append((s_c[:, None] * transfer).sum(0))
    return torch.stack(parts).sum(0)


def bounce_irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key, *,
                      n_samples: int = 4, n_sources: int = 64, n_bounces: int = 1, source_chunk: int = 16):
    """Differentiable multi-bounce (diffuse interreflection) irradiance
    sum_{k=1..n_bounces} E^k_t in W/m^2, f32[T], with per-triangle
    reflectance f32[T] and triangle areas f32[T] (mesh.areas, static).

    Virtual point lights: area-weighted source points x_m (probability
    proportional to A_s, weight w = A_total / M) carry E_0(m) = E_dir(x_m)
    and E_k(m) = w sum_{m' != m} rho_m' E_{k-1}(m') F(x_m', x_m), F the
    Lambertian form factor cos cos / (pi d^2) V; the receivers take one
    chunked transfer pass of the summed exitance. Gradients are exact
    polynomials in `reflectance`; lamp, rod and power gradients flow through
    E_dir with the same visibility contract as `irradiance`."""
    keys = rng.split(key, 4)
    x_m, n_m, strength, w = _source_field(
        scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, keys,
        n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces)
    qs = _sample_triangle_points(scene, keys[3], n_samples)  # [S,T,3]
    s, t = qs.shape[0], qs.shape[1]
    acc = _receiver_transfer(scene, qs.reshape(s * t, 3), scene.normal[None].expand(s, t, 3).reshape(s * t, 3),
                             x_m, n_m, strength, source_chunk).view(s, t)
    return w * torch.mean(acc, dim=0)


def one_bounce_irradiance(scene: DiffScene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key, *,
                          n_samples: int = 4, n_sources: int = 64):
    """The one-bounce case of `bounce_irradiance`."""
    return bounce_irradiance(scene, lamp_xz, rod_base_y, rod_length, power, reflectance, areas, key,
                             n_samples=n_samples, n_sources=n_sources, n_bounces=1)


def route_dose(scene: DiffScene, waypoints_xz, durations, rod_base_y, rod_length, power, key, *,
               n_samples: int = 8, reflectance=None, areas=None, n_sources: int = 64, n_bounces: int = 1):
    """Differentiable cumulative dose [mJ/cm^2] over a route, f32[T]:

        dose_t = 0.1 * sum_w duration_w * E_t(lamp_w)   (Report §3 Eq. 1 units)

    waypoints_xz f32[W,2] and durations f32[W] are differentiable; waypoint
    w draws from fold_in(key, w). reflectance (f32[T], needs `areas`) adds
    the differentiable interreflection terms, from fold_in(fold_in(key, w), 1)."""
    if reflectance is not None and areas is None:
        raise ValueError("route_dose(reflectance=...) needs areas=mesh.areas")
    waypoints_xz = _as_tensor(waypoints_xz, scene.v0)
    durations = _as_tensor(durations, scene.v0)
    acc = torch.zeros(scene.v0.shape[0], device=scene.v0.device)
    for w in range(waypoints_xz.shape[0]):
        kw = rng.fold_in(key, w)
        e = irradiance(scene, waypoints_xz[w], rod_base_y, rod_length, power, kw, n_samples=n_samples)
        if reflectance is not None:
            e = e + bounce_irradiance(scene, waypoints_xz[w], rod_base_y, rod_length, power, reflectance, areas,
                                      rng.fold_in(kw, 1), n_samples=n_samples, n_sources=n_sources,
                                      n_bounces=n_bounces)
        acc = acc + durations[w] * e
    return 0.1 * acc
