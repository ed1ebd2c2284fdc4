"""Multi-bounce diffuse interreflection with Russian roulette
(uvtrace/ops/bounce.py; BASELINE config 2).

A photon deposits a full count at every surface arrival; at each arrival it
survives with probability rho (the surface's UV reflectance) and continues in
a cosine-weighted hemisphere direction about the normal oriented against the
incoming ray. Random numbers are threefry uniforms on the device
(ops/rng.uniform), drawn from the same keys as the JAX package, so the
roulette draws are bit-equal for equal inputs.
"""

from __future__ import annotations

import torch

from uvtrace_torch.ops import rng
from uvtrace_torch.ops.generate import TWO_PI, _F

_EPS = _F(1e-3)  # offset of a bounce origin along the normal


def orthonormal_basis(n: torch.Tensor):
    """Branchless ONB (Duff et al. 2017 / Frisvad) for unit normals [*, 3]."""
    n0, n1, n2 = n.unbind(-1)
    s = torch.where(n2 >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n2)
    b = n0 * n1 * a
    t1 = torch.stack([1.0 + s * (n0 * n0) * a, s * b, -s * n0], -1)
    t2 = torch.stack([b, s + (n1 * n1) * a, -n1], -1)
    return t1, t2


def cosine_hemisphere(key, normals: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about unit `normals` [N, 3]; key: two
    uint32 words, split into the radius and azimuth keys."""
    k1, k2 = rng.split(key)
    n = normals.shape[0]
    u1 = rng.uniform(k1, n, normals.device)
    u2 = rng.uniform(k2, n, normals.device)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t1, t2 = orthonormal_basis(normals)
    return x[:, None] * t1 + y[:, None] * t2 + z[:, None] * normals


def bounce_rays(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive):
    """One Russian-roulette bounce step (uvtrace/ops/bounce.py:50-84).

    orig, direction: f32[R, 3] current rays; t_hit, hit_ids: their closest
    hits (1e30 / -1 on a miss); normals f32[T, 3] and reflectance f32[T] in
    the hit-id space; alive: bool[R] photons in flight before this arrival.
    Returns (new_orig, new_dir, new_alive); dead lanes are parked far outside
    the scene (origin 1e6, direction (1, 0, 0)) so that their packets cull at
    once."""
    k_rr, k_dir = rng.split(key)
    safe = hit_ids.clamp_min(0).long()
    n = normals[safe]
    facing = (n * direction).sum(-1, keepdim=True)
    n = torch.where(facing > 0, -n, n)
    u = rng.uniform(k_rr, hit_ids.shape[0], hit_ids.device)
    new_alive = alive & (hit_ids >= 0) & (u < reflectance[safe])
    p = orig + t_hit[:, None] * direction
    new_dir = cosine_hemisphere(k_dir, n)
    new_orig = p + _EPS * n
    keep = new_alive[:, None]
    new_orig = torch.where(keep, new_orig, 1e6)
    new_dir = torch.where(keep, new_dir, torch.tensor([1.0, 0.0, 0.0], device=new_dir.device))
    return new_orig, new_dir, new_alive


def coherence_sort(orig, direction, alive, cell_meters: float = 1.0, index=None):
    """Re-pack bounce rays into packet-coherent order: a stable sort on the
    key (direction octant, origin cell modulo 8 per axis), dead lanes last
    (uvtrace/ops/bounce.py:87-129). `lax.sort` is stable, so an equal key
    keeps the input order on both packages and the permutation is identical.
    index: optional i32[N] carried through the sort and returned fourth."""
    oct_ = ((direction[:, 0] >= 0).to(torch.int32) * 4 + (direction[:, 1] >= 0).to(torch.int32) * 2
            + (direction[:, 2] >= 0).to(torch.int32))
    cell = torch.zeros_like(oct_)
    for a in range(3):
        cell = cell * 8 + (torch.floor(orig[:, a] / cell_meters).to(torch.int32) & 7)
    key = torch.where(alive, oct_ * 512 + cell, 1 << 30)
    perm = torch.sort(key, stable=True).indices
    result = (orig[perm], direction[perm], alive[perm])
    if index is not None:
        return result + (index[perm],)
    return result
