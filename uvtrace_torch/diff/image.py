"""Differentiable dose image with pixel gradients (uvtrace/diff/image.py).

  1. `plan_dose_image` fixes the pixel -> surface assignment once: the
     res x res top-down probes of `Simulator.dose_grid` (ops/probes.py, the
     same ceiling-band re-cast), traced by the scene's shadow-ray trace (B2)
     and mapped from padded slots to triangles. It depends on geometry only,
     so it is constant under differentiation.
  2. `dose_image` evaluates the differentiable point irradiance
     (`_points_direct`, plus the multi-bounce source-field transfer with a
     reflectance) at the planned points for every waypoint: autograd of any
     pixel with respect to lamp xz, durations, power or reflectance flows
     through the same G x V factorization as `route_dose`.

A pixel reports the point dose at its probe's hit point; the count pipeline's
`dose_grid` reports that point's triangle-average dose.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uvtrace_torch.diff.estimator import DiffScene, _as_tensor, _points_direct, _receiver_transfer, _source_field
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays


class ImagePlan(NamedTuple):
    """Fixed pixel -> surface assignment (geometry only; no lamp parameters)."""

    points: torch.Tensor  # f32[P,3] first-hit surface points (pixel centres); 1e6 on a miss
    normals: torch.Tensor  # f32[P,3] unit normals of the hit triangles
    tri: torch.Tensor  # i32[P] hit triangle id (-1 = miss)
    mask: torch.Tensor  # bool[P] the probe hit something
    res: int


def plan_dose_image(scene: DiffScene, res: int = 64, *, skip_ceiling: bool = True,
                    ceiling_margin: float = 0.05) -> ImagePlan:
    """Cast the res x res top-down probe grid once and keep each pixel's
    surface point and normal. The point is nudged 1e-4 m up, towards the
    probe, so that its own surface does not occlude its shadow rays."""
    verts = torch.cat([scene.v0, scene.v0 + scene.e1, scene.v0 + scene.e2], dim=0)
    lo = verts.min(0).values.cpu().numpy()
    hi = verts.max(0).values.cpu().numpy()
    orig, direction = probe_rays(lo, hi, res, device=scene.v0.device)

    def extend2(o, d):
        return scene.extend_fn(scene.trav_scene, o, d)[:2]

    t_hit, hit = first_hits_skip_ceiling(extend2, orig, direction, float(lo[1]), float(hi[1]),
                                         skip_ceiling=skip_ceiling, ceiling_margin=ceiling_margin)
    if scene.slot_to_tri is not None:  # B2's padded slots -> triangle ids
        hit = torch.where(hit >= 0, scene.slot_to_tri[hit.clamp_min(0).long()], -1)
    mask = hit >= 0
    points = orig + t_hit[:, None] * direction
    points = points + 1e-4 * torch.tensor([0.0, 1.0, 0.0], device=points.device)
    return ImagePlan(
        points=torch.where(mask[:, None], points, 1e6),
        normals=scene.normal[hit.clamp_min(0).long()],
        tri=hit.to(torch.int32),
        mask=mask,
        res=res,
    )


def dose_image(scene: DiffScene, plan: ImagePlan, waypoints_xz, durations, rod_base_y, rod_length, power, key, *,
               n_samples: int = 8, reflectance=None, areas=None, n_sources: int = 64, n_bounces: int = 1,
               source_chunk: int = 16) -> torch.Tensor:
    """Differentiable res x res cumulative-dose image [mJ/cm^2]:

        pixel = 0.1 * sum_w duration_w * E_point(p_pixel)   (miss pixels 0)

    waypoints_xz, durations, power and reflectance are differentiable; the
    plan and visibility are the fixed, piecewise-constant part. Fix `key`
    for common random numbers."""
    if reflectance is not None and areas is None:
        raise ValueError("dose_image(reflectance=...) needs areas=mesh.areas")
    waypoints_xz = _as_tensor(waypoints_xz, scene.v0)
    durations = _as_tensor(durations, scene.v0)
    t_count = scene.v0.shape[0]
    acc = torch.zeros(plan.points.shape[0], device=scene.v0.device)
    for w in range(waypoints_xz.shape[0]):
        kw = rng.fold_in(key, w)
        e = _points_direct(scene, plan.points, plan.normals, waypoints_xz[w], rod_base_y, rod_length, power, kw,
                           n_rod=n_samples)
        if reflectance is not None:
            keys = rng.split(rng.fold_in(kw, 1), 4)
            x_m, n_m, strength, wgt = _source_field(
                scene, waypoints_xz[w], rod_base_y, rod_length, power,
                _as_tensor(reflectance, scene.v0).expand(t_count), areas, keys,
                n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces)
            e = e + wgt * _receiver_transfer(scene, plan.points, plan.normals, x_m, n_m, strength, source_chunk)
        acc = acc + durations[w] * e
    img = torch.where(plan.mask, 0.1 * acc, 0.0)
    return img.view(plan.res, plan.res)
