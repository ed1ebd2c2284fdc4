"""Ray generation: the stratum grid and the packet-stratified sampler
(uvtrace/ops/generate.py).

`_stratum_grid` must equal uvtrace/ops/generate.py:_stratum_grid so that
packet g samples the same cell on both packages; the fused kernel generates
its rays itself (ops/traverse_mxu.py). `generate_stratified` is the split
path's sampler: the same cells, drawn from threefry uniforms on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from uvtrace_torch.ops import rng

# f32 constants as Python floats holding the f32 value, so that torch's scalar
# arithmetic uses exactly the constants JAX's f32 arithmetic uses
_F = lambda x: float(np.float32(x))  # noqa: E731
TWO_PI = _F(2.0 * np.pi)


class RayBatch(NamedTuple):
    """SoA ray queue: origins and unit directions, f32[N, 3]."""

    orig: torch.Tensor
    dir: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.orig.shape[0])


def _stratum_grid(g: int, height_bands: int = 1) -> tuple[int, int, int]:
    """Factor g packets into (rod-height bands) x (cos-theta bands) x
    (azimuth sectors). Height bands shrink the packet frustum's origin spread;
    at least 64 direction cells are kept so that small launches do not get
    fat direction cones."""
    gh = height_bands
    while gh > 1 and (g % gh or g // gh < 64):
        gh //= 2
    rest = g // gh
    gy = max(1, int(math.sqrt(rest)))
    while rest % gy:
        gy -= 1
    return gh, gy, rest // gy


def generate_stratified(key, n: int, light_pos, light_length, *, packet: int = 1024,
                        height_bands: int = 4, device="cpu") -> RayBatch:
    """Packet-stratified sphere sampler (uvtrace/ops/generate.py:140-182):
    packet g samples one equal-solid-angle cell of (cos-theta, azimuth) and
    one rod-height band, uniformly inside it. Keys (ku, ky, kp) = split(key,
    3) draw the height, cos-theta and azimuth uniforms; the f32 operation
    order is JAX's, with its constants rounded to f32 first.

    key: two uint32 words; light_pos: host floats (x, y, z); n a multiple of
    `packet`."""
    if n % packet:
        raise ValueError(f"n={n} must be a whole number of packets of {packet}")
    gh, gy, gphi = _stratum_grid(n // packet, height_bands=height_bands)
    ku, ky, kp = rng.split(key, 3)
    lx, ly, lz = (_F(v) for v in light_pos)
    cell = torch.arange(n, dtype=torch.int64, device=device) // packet
    ih = (cell // (gy * gphi)).to(torch.float32)
    iy = ((cell // gphi) % gy).to(torch.float32)
    ip = (cell % gphi).to(torch.float32)
    u_height = (ih + rng.uniform(ku, n, device)) / gh
    oy = ly + u_height * _F(light_length)
    orig = torch.stack([torch.full_like(oy, lx), oy, torch.full_like(oy, lz)], -1)
    dir_y = -1.0 + 2.0 * (iy + rng.uniform(ky, n, device)) / gy
    phi = TWO_PI * (ip + rng.uniform(kp, n, device)) / gphi
    r = torch.sqrt(torch.clamp_min(1.0 - dir_y * dir_y, 0.0))
    direction = torch.stack([r * torch.cos(phi), dir_y, r * torch.sin(phi)], -1)
    return RayBatch(orig=orig, dir=direction)
