"""The dose of one iteration over a route, in plain PyTorch: the photons of
each waypoint drawn from the session key as the forward simulator defines
them (the packet-stratified sphere sampler with its counter-based hash),
traced (reference/tracer.py), histogrammed per triangle and weighted by the
waypoint's dwell time.

With bounces, each photon that arrives alive counts a hit, survives with
the surface's reflectance and leaves in a cosine-weighted direction
(`bounce`). Keys: the session key is PRNGKey(seed); every launch (one waypoint of one
iteration, in route order) splits it into (next session key, launch key),
and chunk g of a launch draws from fold_in(launch key, g). A launch of n
photons a lamp traces whole chunks of min(2^20, next_pow2(n)) photons (at
least 1024). Chunk rays: packet p of 1024 samples one cell of a grid of
(rod-height bands) x (cos-theta bands) x (azimuth sectors), uniformly inside
it, from the hash WangHash(WangHash(counter ^ k0) ^ k1) of the counter k P +
lane + p 3P for uniform k of 3.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import threefry
from benchmarks.reference.tracer import trace

PACKET = 1024
HEIGHT_BANDS = 4
MAX_CHUNK = 1 << 20
_F = lambda x: float(np.float32(x))  # noqa: E731
TWO_PI = _F(2.0 * np.pi)
_PI, _HALF_PI, _THREE_HALF_PI = _F(np.pi), _F(np.pi / 2), _F(3 * np.pi / 2)


def stratum_grid(g: int, height_bands: int = HEIGHT_BANDS):
    """(height bands, cos-theta bands, azimuth sectors) of g packets: at most
    `height_bands` bands while each keeps 64 direction cells, then the most
    square split of the rest."""
    gh = height_bands
    while gh > 1 and (g % gh or g // gh < 64):
        gh //= 2
    rest = g // gh
    gy = max(1, int(math.sqrt(rest)))
    while rest % gy:
        gy -= 1
    return gh, gy, rest // gy


def chunk_rays(key_words, lamp_xyz, light_length: float, n: int, device):
    """(orig f32[n, 3], dir f32[n, 3]) of one chunk."""
    packet = min(PACKET, n)
    g = n // packet
    gh, gy, gphi = stratum_grid(g)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key_words)
    i64 = dict(dtype=torch.int64, device=device)
    ctr = (torch.arange(3, **i64)[:, None, None] * packet + torch.arange(packet, **i64)[None, None, :]
           + torch.arange(g, **i64)[None, :, None] * (3 * packet)) & 0xFFFFFFFF
    h = threefry.wang_hash(threefry.wang_hash(ctr ^ k0) ^ k1)
    uh, uy, up = ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).unbind(0)
    pid = torch.arange(g, **i64)[:, None]
    ih = (pid // (gy * gphi)).to(torch.float32)
    iy = ((pid // gphi) % gy).to(torch.float32)
    ip = (pid % gphi).to(torch.float32)
    # each packet's azimuth sector bounds its cos and sin (the cell's frustum)
    plo, phh = TWO_PI * ip / gphi, TWO_PI * (ip + 1.0) / gphi
    one = torch.ones_like(plo)
    ca, cb, sa, sb = torch.cos(plo), torch.cos(phh), torch.sin(plo), torch.sin(phh)
    c_hi = torch.where((plo <= 0.0) | (phh >= TWO_PI), one, torch.maximum(ca, cb))
    c_lo = torch.where((plo <= _PI) & (phh >= _PI), -one, torch.minimum(ca, cb))
    s_hi = torch.where((plo <= _HALF_PI) & (phh >= _HALF_PI), one, torch.maximum(sa, sb))
    s_lo = torch.where((plo <= _THREE_HALF_PI) & (phh >= _THREE_HALF_PI), -one, torch.minimum(sa, sb))
    snap = lambda v: torch.where(v.abs() < 1e-6, 0.0, v)  # noqa: E731
    c_lo, c_hi, s_lo, s_hi = snap(c_lo), snap(c_hi), snap(s_lo), snap(s_hi)
    lx, ly, lz = (_F(v) for v in lamp_xyz)
    dy = -1.0 + 2.0 * (iy + uy) / gy
    phi = TWO_PI * (ip + up) / gphi
    r = torch.sqrt(torch.clamp_min(1.0 - dy * dy, 0.0))
    dx = r * torch.clamp(torch.cos(phi), c_lo, c_hi)
    dz = r * torch.clamp(torch.sin(phi), s_lo, s_hi)
    oy = ly + (ih + uh) / gh * _F(light_length)
    orig = torch.stack([torch.full_like(oy, lx), oy, torch.full_like(oy, lz)], -1).reshape(n, 3)
    return orig, torch.stack([dx, dy, dz], -1).reshape(n, 3)


def stratified_rays(key_words, lamp_xyz, light_length: float, n: int, device):
    """(orig, dir) of one chunk of the split path's sampler: the same cells,
    each ray's three uniforms drawn from split(key, 3) by threefry."""
    packet = min(PACKET, n)
    gh, gy, gphi = stratum_grid(n // packet)
    ku, ky, kp = threefry.split(key_words, 3)
    cell = torch.arange(n, dtype=torch.int64, device=device) // packet
    ih = (cell // (gy * gphi)).to(torch.float32)
    iy = ((cell // gphi) % gy).to(torch.float32)
    ip = (cell % gphi).to(torch.float32)
    div = lambda x, d: x / torch.full((), float(d), device=device)  # noqa: E731  (an IEEE division)
    lx, ly, lz = (_F(v) for v in lamp_xyz)
    oy = ly + div(ih + threefry.uniform(ku, n, device), gh) * _F(light_length)
    dy = -1.0 + div(2.0 * (iy + threefry.uniform(ky, n, device)), gy)
    phi = div(TWO_PI * (ip + threefry.uniform(kp, n, device)), gphi)
    r = torch.sqrt(torch.clamp_min(1.0 - dy * dy, 0.0))
    orig = torch.stack([torch.full_like(oy, lx), oy, torch.full_like(oy, lz)], -1)
    return orig, torch.stack([r * torch.cos(phi), dy, r * torch.sin(phi)], -1)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def bounce(key_words, orig, dirs, t, tri, alive, normals, reflectance: float):
    """One diffuse bounce with Russian roulette: a lane that hit and was
    alive survives where its roulette uniform is under the reflectance and
    leaves its hit point (1e-3 along the normal facing it) in a
    cosine-weighted direction about that normal; dead lanes are parked at
    1e6 heading +x. Returns (orig, dir, alive, coherence key: direction
    octant x 512 + the origin's 1 m cell modulo 8 a axis, 2^30 if dead)."""
    dev = orig.device
    k_rr, k_dir = threefry.split(key_words)
    k1, k2 = threefry.split(k_dir)
    r = orig.shape[0]
    n = normals[tri.clamp_min(0)]
    n = torch.where((_dot(n, dirs) > 0)[:, None], -n, n)
    alive = alive & (tri >= 0) & (threefry.uniform(k_rr, r, dev) < reflectance)
    u1, u2 = threefry.uniform(k1, r, dev), threefry.uniform(k2, r, dev)
    rad, phi = torch.sqrt(u1), TWO_PI * u2
    x, y, z = rad * torch.cos(phi), rad * torch.sin(phi), torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    n0, n1, n2 = n.unbind(-1)
    sg = torch.where(n2 >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + n2)
    b = n0 * n1 * a
    t1 = torch.stack([1.0 + sg * (n0 * n0) * a, sg * b, -sg * n0], -1)
    t2 = torch.stack([b, sg + (n1 * n1) * a, -n1], -1)
    new_dir = x[:, None] * t1 + y[:, None] * t2 + z[:, None] * n
    new_orig = orig + t.clamp_max(3e38)[:, None] * dirs + _F(1e-3) * n
    keep = alive[:, None]
    new_orig = torch.where(keep, new_orig, 1e6)
    new_dir = torch.where(keep, new_dir, torch.tensor([1.0, 0.0, 0.0], device=dev))
    octant = (new_dir >= 0).to(torch.int32)
    c = torch.floor(new_orig / torch.full((), 1.0, device=dev)).to(torch.int32) & 7
    key = (octant[:, 0] * 4 + octant[:, 1] * 2 + octant[:, 2]) * 512 + (c[:, 0] * 8 + c[:, 1]) * 8 + c[:, 2]
    return new_orig, new_dir, alive, torch.where(alive, key, 1 << 30)


def launch_size(photon_count: int, lamps: int):
    """(photons traced a lamp, chunk): the per-lamp count (even, rounded
    down) rounded up to whole chunks."""
    n = (photon_count // max(1, lamps)) & ~1
    chunk = max(PACKET, min(MAX_CHUNK, 1 << (n - 1).bit_length()))
    return -(-n // chunk) * chunk, chunk


def launch_key(seed: int, launch: int):
    """The launch key of launch number `launch` (0-based) of a session."""
    k = threefry.key(seed)
    for _ in range(launch):
        k = threefry.split(k)[0]
    return threefry.split(k)[1]


def iteration_hits(scene, t_count: int, route, floor_height: float, light_height: float, light_length: float,
                   photon_count: int, seed: int, iteration: int, device, dtype=torch.float32,
                   sample_every: int = 0, bounces: int = 0, reflectance: float = 0.0, normals=None):
    """(f64[T] dwell-weighted hits of iteration number `iteration` of a
    session, photons traced, work sample). route: [(x, z, seconds)]. Direct
    lighting draws a chunk's rays from the counter hash (`chunk_rays`); with
    bounces, from threefry (`stratified_rays`), and every arrival of a live
    photon counts, bounce b of chunk g drawing from fold_in(fold_in(launch
    key, 7919 + b), g), its rays in the stable order of their coherence
    keys. With sample_every > 0, every sample_every-th ray of each traced
    batch is traced once more for its work count (rooflines/work.py):
    (live ray segments traced, their work scaled from the sample to the
    batch). A dead lane is parked where it enters no box: it needs no work."""
    n, chunk = launch_size(photon_count, len(route))
    acc = torch.zeros(t_count, dtype=torch.float64, device=device)
    sampled = [0, 0.0]

    def traced(o, d, alive):
        t, tri = trace(scene, o, d, dtype=dtype)
        if sample_every:
            _, _, work = trace(scene, o[::sample_every], d[::sample_every], work=True)
            sampled[0] += int(alive.sum())
            sampled[1] += float(work.sum()) * o.shape[0] / work.shape[0]
        return t, tri

    for w, (x, z, seconds) in enumerate(route):
        lamp = (x, float(np.float32(floor_height + light_height)), z)
        rng_in = launch_key(seed, iteration * len(route) + w)
        counts = torch.zeros(t_count, dtype=torch.int64, device=device)
        for g in range(n // chunk):
            kg = threefry.fold_in(rng_in, g)
            o, d = (stratified_rays if bounces else chunk_rays)(kg, lamp, light_length, chunk, device)
            alive = torch.ones(chunk, dtype=torch.bool, device=device)
            t, tri = traced(o, d, alive)
            counts += torch.bincount(tri[tri >= 0], minlength=t_count)
            for b in range(bounces):
                kb = threefry.fold_in(threefry.fold_in(rng_in, 7919 + b), g)
                o, d, alive, key = bounce(kb, o, d, t, tri, alive, normals, reflectance)
                perm = torch.sort(key, stable=True).indices
                o, d, alive = o[perm], d[perm], alive[perm]
                t, tri = traced(o, d, alive)
                counts += torch.bincount(tri[(tri >= 0) & alive], minlength=t_count)
        acc += counts.double() * float(seconds)
    return acc, n * len(route), tuple(sampled)
