"""Multi-bounce diffuse interreflection with Russian roulette
(uvtrace/ops/bounce.py; BASELINE config 2).

A photon deposits a full count at every surface arrival; at each arrival it
survives with probability rho (the surface's UV reflectance) and continues in
a cosine-weighted hemisphere direction about the normal oriented against the
incoming ray. Random numbers are threefry uniforms drawn from the same keys
as the JAX package, so the roulette draws are bit-equal for equal inputs.

`bounce_step` is one bounce step and the key of the coherence sort: on a
CUDA device one launch of the kernel K4 (csrc/launch_ops.cu), which
replaces the XLA fusion of `bounce_rays` and `coherence_sort`'s key inside
the JAX package's launch; on the CPU `bounce_step_reference`, its plain
version. `bounce_rays` and `coherence_sort` keep the JAX package's names.
"""

from __future__ import annotations

import torch

from uvtrace_torch.ops import rng
from uvtrace_torch.ops.generate import TWO_PI, _F, _div
from uvtrace_torch.ops.intersect import dot3
from uvtrace_torch.utils.timing import span

_EPS = _F(1e-3)  # offset of a bounce origin along the normal
DEAD_KEY = 1 << 30  # the sort key of a dead lane: dead lanes sort last


def orthonormal_basis(n: torch.Tensor):
    """Branchless ONB (Duff et al. 2017 / Frisvad) for unit normals [*, 3]."""
    n0, n1, n2 = n.unbind(-1)
    s = torch.where(n2 >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n2)
    b = n0 * n1 * a
    t1 = torch.stack([1.0 + s * (n0 * n0) * a, s * b, -s * n0], -1)
    t2 = torch.stack([b, s + (n1 * n1) * a, -n1], -1)
    return t1, t2


def _hemisphere(u1: torch.Tensor, u2: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about unit `normals` [N, 3] from the
    radius and azimuth uniforms u1, u2 [N]."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t1, t2 = orthonormal_basis(normals)
    return x[:, None] * t1 + y[:, None] * t2 + z[:, None] * normals


def cosine_hemisphere(key, normals: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about unit `normals` [N, 3]; key: two
    uint32 words, split into the radius and azimuth keys."""
    k1, k2 = rng.split(key)
    n = normals.shape[0]
    return _hemisphere(rng.uniform(k1, n, normals.device), rng.uniform(k2, n, normals.device), normals)


def coherence_key(orig, direction, alive, cell_meters: float = 1.0) -> torch.Tensor:
    """i32[R] sort key of `coherence_sort` (uvtrace/ops/bounce.py:111-121):
    direction octant * 512 + origin cell modulo 8 per axis, 2^30 for a dead
    lane. The cell divides by a 0-d device tensor (generate._div), an IEEE
    division on every device as JAX's."""
    o = (direction >= 0).to(torch.int32)
    c = torch.floor(_div(orig, cell_meters)).to(torch.int32) & 7
    key = (o[:, 0] * 4 + o[:, 1] * 2 + o[:, 2]) * 512 + (c[:, 0] * 8 + c[:, 1]) * 8 + c[:, 2]
    return torch.where(alive, key, DEAD_KEY)


def bounce_step_reference(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive,
                          cell_meters: float = 1.0):
    """Plain PyTorch version of `bounce_step`: the JAX package's
    `bounce_rays` op for op (its roulette and hemisphere uniforms through
    rng.uniform_reference), then `coherence_key` of the new rays."""
    k_rr, k_dir = rng.split(key)
    k1, k2 = rng.split(k_dir)
    r = hit_ids.shape[0]
    safe = hit_ids.clamp_min(0).long()
    n = normals[safe]
    n = torch.where(dot3(n, direction)[:, None] > 0, -n, n)
    u = rng.uniform_reference(k_rr, r, hit_ids.device)
    new_alive = alive & (hit_ids >= 0) & (u < reflectance[safe])
    p = orig + t_hit[:, None] * direction
    # cosine_hemisphere(k_dir, n), its uniforms from the plain draw
    new_dir = _hemisphere(rng.uniform_reference(k1, r, n.device), rng.uniform_reference(k2, r, n.device), n)
    new_orig = p + _EPS * n
    keep = new_alive[:, None]
    new_orig = torch.where(keep, new_orig, 1e6)
    new_dir = torch.where(keep, new_dir, torch.tensor([1.0, 0.0, 0.0], device=new_dir.device))
    return new_orig, new_dir, new_alive, coherence_key(new_orig, new_dir, new_alive, cell_meters)


def _bounce_step_kernel(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive, cell_meters: float):
    """One launch of csrc/launch_ops.cu's bounce_step_kernel (K4)."""
    from uvtrace_torch import _build

    dev, r, s = orig.device, orig.shape[0], normals.shape[0]
    _build.check_elements(r)
    for name, x, dtype, shape in (
            ("orig", orig, torch.float32, (r, 3)), ("direction", direction, torch.float32, (r, 3)),
            ("t_hit", t_hit, torch.float32, (r,)), ("hit_ids", hit_ids, torch.int32, (r,)),
            ("alive", alive, torch.bool, (r,)), ("normals", normals, torch.float32, (s, 3)),
            ("reflectance", reflectance, torch.float32, (s,))):
        _build.check_tensor(name, x, dtype, shape, dev)
    new_orig = torch.empty((r, 3), dtype=torch.float32, device=dev)
    new_dir = torch.empty((r, 3), dtype=torch.float32, device=dev)
    new_alive = torch.empty(r, dtype=torch.bool, device=dev)
    sort_key = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
        ptr = _build.ptr
        _build.launch("bounce_step_launch", dev, k0, k1, r, _F(cell_meters), ptr(orig), ptr(direction), ptr(t_hit),
                      ptr(hit_ids), ptr(alive), ptr(normals), ptr(reflectance), ptr(new_orig), ptr(new_dir),
                      ptr(new_alive), ptr(sort_key))
    return new_orig, new_dir, new_alive, sort_key


def bounce_step(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive, cell_meters: float = 1.0):
    """One Russian-roulette bounce step and the coherence sort's key of the
    new rays (uvtrace/ops/bounce.py:50-84 and :111-121).

    key: the bounce's two uint32 words (split into the roulette key and the
    direction key, and that into the radius and azimuth keys, as the JAX
    package splits them). orig, direction: f32[R, 3] current rays; t_hit,
    hit_ids: their closest hits (i32, -1 on a miss); normals f32[S, 3] and
    reflectance f32[S] in the hit-id space; alive: bool[R] photons in
    flight before this arrival. Returns (new_orig, new_dir, new_alive, key
    i32[R]); dead lanes are parked far outside the scene (origin 1e6,
    direction (1, 0, 0)) so that their packets cull at once, and their key
    is 2^30. On a CUDA device one launch of the kernel K4; on the CPU
    `bounce_step_reference`. A launch that fails raises."""
    dev = orig.device
    if dev.type == "cpu":
        return bounce_step_reference(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive, cell_meters)
    if dev.type != "cuda":
        raise ValueError(f"bounce_step runs on cpu or cuda tensors, not {dev}")
    return _bounce_step_kernel(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive, cell_meters)


def bounce_rays(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive):
    """One Russian-roulette bounce step (uvtrace/ops/bounce.py:50-84): the
    (new_orig, new_dir, new_alive) of `bounce_step`."""
    return bounce_step(key, orig, direction, t_hit, hit_ids, normals, reflectance, alive)[:3]


def sort_rays(sort_key, orig, direction, alive, index=None):
    """The rays in the order of a stable sort on `sort_key` (the counterpart
    of `jax.lax.sort` carrying the ray fields, uvtrace/ops/bounce.py:120):
    (orig, direction, alive[, index]). Traced as `launch.sort`, with the
    device interval between two events on the current stream."""
    with span("launch.sort", sort_key.device):
        perm = torch.sort(sort_key, stable=True).indices
        result = (orig[perm], direction[perm], alive[perm])
        if index is not None:
            result += (index[perm],)
    return result


def coherence_sort(orig, direction, alive, cell_meters: float = 1.0, index=None):
    """Re-pack bounce rays into packet-coherent order: a stable sort on the
    key (direction octant, origin cell modulo 8 per axis), dead lanes last
    (uvtrace/ops/bounce.py:87-129). `lax.sort` is stable, so an equal key
    keeps the input order on both packages and the permutation is identical.
    index: optional i32[N] carried through the sort and returned fourth."""
    return sort_rays(coherence_key(orig, direction, alive, cell_meters), orig, direction, alive, index)
