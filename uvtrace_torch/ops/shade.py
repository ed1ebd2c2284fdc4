"""Dose / irradiance unit conversion and heatmap colouring
(uvtrace/ops/shade.py; reference cl/shade.cl:4-71)."""

from __future__ import annotations

import numpy as np
import torch


def triangle_areas(tris: torch.Tensor) -> torch.Tensor:
    """float[T] areas = |cross(v0-v1, v0-v2)|/2 (cl/shade.cl:31-36)."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    c = torch.linalg.cross(v0 - v1, v0 - v2, dim=-1)
    return 0.5 * torch.linalg.vector_norm(c, dim=-1)


def compute_dosage(photon_map, areas, photons_per_light, scaled_power):
    """dose_t = scaled_power * n_t / (area_t * photons_per_light)
    (cl/shade.cl:39)."""
    # Python scalars enter f32 kernels as f32 values, as jnp.asarray(x, f32)
    return (photon_map.to(torch.float32) * float(scaled_power)) / (areas * float(photons_per_light))


def greyscale_to_heatmap(intensity: torch.Tensor) -> torch.Tensor:
    """5-stop heat gradient (cl/shade.cl:4-21): scalar field ->
    float32[..., 3] RGB, piecewise around min_dosage_color=0.5."""
    i = intensity
    min_c = 0.5
    upper = min_c + (1.0 - min_c) / 2  # 0.75
    lower = min_c / 2.0  # 0.25
    one, zero = torch.ones_like(i), torch.zeros_like(i)
    r = torch.where(i > upper, one, torch.where(i > min_c, (i - min_c) / (upper - min_c), zero))
    g = torch.where(i > upper, (1.0 - i) / (1.0 - upper), torch.where(i > lower, one, i / lower))
    b = torch.where(i > min_c, zero, torch.where(i > lower, (min_c - i) / (min_c - lower), one))
    return torch.stack([r, g, b], dim=-1)


def dosage_to_color(dosage_map, min_value, threshold_view: bool = False):
    """Normalise by 2*min_value and colourise (cl/shade.cl:43-71); in the
    threshold view values below 0.5 render as a dark blue ramp. Returns
    float32[T,3] RGB clipped to [0, 1]."""
    norm = dosage_map / (2.0 * float(np.float32(min_value)))
    heat = greyscale_to_heatmap(norm)
    if threshold_view:
        zero = torch.zeros_like(norm)
        dark_blue = torch.stack([zero, zero, norm * 2.0], dim=-1)
        heat = torch.where((norm < 0.5)[..., None], dark_blue, heat)
    return torch.clamp(heat, 0.0, 1.0)
