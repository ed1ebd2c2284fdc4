"""Ray generation (uvtrace/ops/generate.py): the stratum grid and the three
samplers.

`_stratum_grid` must equal uvtrace/ops/generate.py:_stratum_grid so that
packet g samples the same cell on both packages; the fused kernel generates
its rays itself (ops/traverse_mxu.py). `generate_stratified` is the split
path's sampler: the same cells, drawn from threefry uniforms on the device.
The two iid samplers draw every photon uniformly over the rod and the
sphere: `generate_native` from threefry uniforms (uniform cos-theta and
azimuth), `generate_reference` from the reference's per-photon xorshift32
streams with its disc rejection loop (cl/generate.cl:8-40).
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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt, as XLA's and CUDA's: torch's vectorised CPU
    sqrt of f32 can be an ulp off, the f64 one rounded to f32 is not."""
    return torch.sqrt(x.double()).to(torch.float32)


REJECTION_ROUNDS = 64  # P(a lane still rejects) = (1 - pi/4)^64 < 1e-42


def _rod_origins(u_height: torch.Tensor, light_pos, light_length) -> torch.Tensor:
    lx, ly, lz = (_F(v) for v in light_pos)
    oy = ly + u_height * _F(light_length)
    return torch.stack([torch.full_like(oy, lx), oy, torch.full_like(oy, lz)], -1)


def generate_reference(n: int, light_pos, light_length, global_seed: int = 0, start: int = 0, *,
                       device="cpu") -> RayBatch:
    """The reference's sampler (cl/generate.cl:8-40, uvtrace/ops/generate.py:
    44-101): photon i = start + lane draws its rod height, dir-y and then
    (x, z) disc candidates from its own xorshift32 stream until one lies in
    the unit disc. The rejection loop runs a fixed REJECTION_ROUNDS masked
    rounds, JAX's bound: a lane that has accepted keeps its state and
    candidate, so the rounds after the last rejection change nothing, and no
    round reads the device.

    light_pos: host floats (x, y, z) of the 3-D lamp base; global_seed: the
    uint32 cross-launch SEED (rng.advance_global_seed)."""
    seeds = rng.photon_seeds(n, light_pos, global_seed, start=start, device=device)
    seeds, u_height = rng.random_float(seeds)
    orig = _rod_origins(u_height, light_pos, light_length)
    seeds, u_y = rng.random_float(seeds)
    dir_y = u_y * 2.0 - 1.0
    xz_len = _sqrt(torch.clamp_min(1.0 - dir_y * dir_y, 0.0))

    def draw(seeds):
        seeds, ux = rng.random_float(seeds)
        seeds, uz = rng.random_float(seeds)
        return seeds, ux * 2 - 1, uz * 2 - 1

    seeds, dx, dz = draw(seeds)
    for _ in range(REJECTION_ROUNDS):
        reject = dx * dx + dz * dz > 1.0
        new_seeds, ndx, ndz = draw(seeds)
        seeds = torch.where(reject, new_seeds, seeds)
        dx = torch.where(reject, ndx, dx)
        dz = torch.where(reject, ndz, dz)
    inv = xz_len / _sqrt(dx * dx + dz * dz)
    return RayBatch(orig=orig, dir=torch.stack([dx * inv, dir_y, dz * inv], -1))


def generate_native(key, n: int, light_pos, light_length, *, device="cpu") -> RayBatch:
    """Threefry iid sampler (uvtrace/ops/generate.py:104-120): keys (ku, ky,
    kp) = split(key, 3) draw a uniform rod height, a uniform cos-theta in
    [-1, 1] and a uniform azimuth in [0, 2 pi), the reference's distribution
    without its rejection loop. key: two uint32 words."""
    ku, ky, kp = rng.split(key, 3)
    orig = _rod_origins(rng.uniform(ku, n, device), light_pos, light_length)
    dir_y = rng.uniform(ky, n, device, minval=-1.0, maxval=1.0)
    phi = rng.uniform(kp, n, device, minval=0.0, maxval=2.0 * np.pi)
    r = _sqrt(torch.clamp_min(1.0 - dir_y * dir_y, 0.0))
    return RayBatch(orig=orig, dir=torch.stack([r * torch.cos(phi), dir_y, r * torch.sin(phi)], -1))


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
    cell = torch.arange(n, dtype=torch.int64, device=device) // packet
    ih = (cell // (gy * gphi)).to(torch.float32)
    iy = ((cell // gphi) % gy).to(torch.float32)
    ip = (cell % gphi).to(torch.float32)
    orig = _rod_origins((ih + rng.uniform(ku, n, device)) / gh, light_pos, light_length)
    dir_y = -1.0 + 2.0 * (iy + rng.uniform(ky, n, device)) / gy
    phi = TWO_PI * (ip + rng.uniform(kp, n, device)) / gphi
    r = torch.sqrt(torch.clamp_min(1.0 - dir_y * dir_y, 0.0))
    direction = torch.stack([r * torch.cos(phi), dir_y, r * torch.sin(phi)], -1)
    return RayBatch(orig=orig, dir=direction)
