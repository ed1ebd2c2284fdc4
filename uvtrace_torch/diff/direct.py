"""The direct estimator's per-waypoint work as kernels, behind one
`torch.autograd.Function` (uvtrace/diff/estimator.py:217-320 and the mxu
`extend`'s coherence sort :99-140 in the JAX package).

    E_m = P / S * sum_s G(r_s, q_sm) V(r_s, q_sm)

for S rod points r_s = (x, base + u_s length, z) and M targets: the sampled
points q = v0 + u e1 + v e2 of the scene's triangles (`irradiance`), or given
points with normals (`_points_direct`). A waypoint runs, on a CUDA device,
five launches and the sort (csrc/diff_ops.cu):

  K8 `shadow_sample`: the draws from the waypoint's key (its splits derived
     on the device), the rod points, each shadow ray's direction and length,
     the geometry term G and the coherence sort's key;
  the stable `torch.sort` of the keys;
  K7 `pack_sorted`: the sorted batch in whole 1024-ray packets (parked
     padding rays) and each ray's position in it;
  B2 (the scene's `trace_fn`): the closest hits of the batch;
  K9 `visibility_reduce`: each ray's visibility, read through K7's inverse
     permutation, and E = power * mean_s(G V), keeping the visibility bits;
  and backward K10 `direct_grad`: d loss / d (lamp x, lamp z, rod base, rod
     length, power) in closed form from those bits and the key's draws,
     reduced in a fixed order (a step's gradients repeat bit for bit).

Each wrapper dispatches on its tensors' device: the kernel on `cuda` (a
failed build or launch raises; there is no fallback), its plain version
`*_reference` on `cpu`. The plain versions are the estimator's own op
sequence, written in the kernels' order (dot products as ops/intersect.dot3,
the division by S as ops/generate._div), so that on the card K7, K8 and K9
equal them bit for bit; K10's plain version is the closed form in torch ops,
held to autograd of the plain forward. Visibility is piecewise constant, as
in the estimator: no gradient flows through the trace, and the Function
gives none with respect to the scene's geometry, the points or the normals
(a caller that asks for one gets an error, not a silent None).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import coherence_key
from uvtrace_torch.ops.generate import _F, _div
from uvtrace_torch.ops.intersect import dot3

SHADOW_PACKET = 1024  # shadow rays are traced in 1024-ray packets (uvtrace/diff/estimator.py:129-132)
PARK = 1e6  # origin coordinate of the padding rays, far outside the scene
EPS = 1e-3  # visibility tolerance: visible where t >= dist (1 - eps) - eps
FOUR_PI = _F(4.0 * np.pi)
N_GRAD = 5  # K10's gradients: lamp x, lamp z, rod base, rod length, power
_GRAD_THREADS = 256  # K10's block size: one partial of N_GRAD values a block


def _key_words(key) -> tuple[int, int]:
    return tuple(int(w) & 0xFFFFFFFF for w in key)


def _check_targets(targets, dev):
    """Raise unless targets is (v0, e1, e2, normal) f32[T,3] or (points,
    normals) f32[M,3], contiguous on dev."""
    from uvtrace_torch import _build

    if len(targets) not in (2, 4):
        raise ValueError(f"targets are (v0, e1, e2, normal) or (points, normals), got {len(targets)} tensors")
    m = targets[0].shape[0]
    for i, x in enumerate(targets):
        _build.check_tensor(f"targets[{i}]", x, torch.float32, (m, 3), dev)
    return m


# --------------------------------------------------------------------------
# K8 shadow_sample
# --------------------------------------------------------------------------


def _rays_reference(key, n_s: int, targets, lamp_xz, base, length):
    """(u_rod f32[S,1], rod points f32[S,3], d = q - r f32[S,M,3], normals
    f32[1|S,M,3]) of the plain version: `irradiance`'s draws for triangles
    (split(key, 3)[0] split into the u and v keys, [1] the rod's), or
    `_points_direct`'s (the rod drawn from key) for given points."""
    dev = targets[0].device
    if len(targets) == 4:
        v0, e1, e2, normal = targets
        keys = rng.split(key, 3)
        ku, kv = rng.split(keys[0])
        t_count = v0.shape[0]
        u = rng.uniform_reference(ku, (n_s, t_count, 1), dev)
        v = rng.uniform_reference(kv, (n_s, t_count, 1), dev)
        flip = (u + v) > 1.0
        u = torch.where(flip, 1.0 - u, u)
        v = torch.where(flip, 1.0 - v, v)
        q = v0[None] + u * e1[None] + v * e2[None]
        n, k_rod = normal[None], keys[1]
    else:
        pts, normals = targets
        q, n, k_rod = pts[None], normals[None], key
    u_rod = rng.uniform_reference(k_rod, (n_s, 1), dev)
    rod = torch.cat([lamp_xz[0].expand(n_s, 1), base + u_rod * length, lamp_xz[1].expand(n_s, 1)], dim=-1)
    return u_rod, rod, q - rod[:, None, :], n


def shadow_sample_reference(key, n_s: int, targets, lamp_xz, base, length):
    """Plain PyTorch version of `shadow_sample`: the estimator's draws and
    shadow rays op for op."""
    _, rod, d, n = _rays_reference(key, n_s, targets, lamp_xz, base, length)
    d2 = dot3(d, d)
    dist = torch.sqrt(d2)
    direction = (d / torch.clamp_min(dist, 1e-20)[..., None]).reshape(-1, 3)
    dd = torch.clamp_min(d2, 1e-12)
    g = torch.abs(dot3(d, n)) / torch.sqrt(dd) / (FOUR_PI * dd)
    orig = rod[:, None, :].expand(d.shape).reshape(-1, 3)
    sort_key = coherence_key(orig, direction, torch.ones(orig.shape[0], dtype=torch.bool, device=orig.device))
    return rod, direction, dist.reshape(-1), g.reshape(-1), sort_key


def _shadow_sample_kernel(key, n_s: int, targets, lamp_xz, base: float, length: float):
    """One launch of csrc/diff_ops.cu's shadow_sample_kernel (K8)."""
    from uvtrace_torch import _build

    dev = lamp_xz.device
    m = _check_targets(targets, dev)
    _build.check_tensor("lamp_xz", lamp_xz, torch.float32, (2,), dev)
    r = n_s * m
    _build.check_elements(r)
    rod = torch.empty((n_s, 3), dtype=torch.float32, device=dev)
    direction = torch.empty((r, 3), dtype=torch.float32, device=dev)
    dist = torch.empty(r, dtype=torch.float32, device=dev)
    g = torch.empty(r, dtype=torch.float32, device=dev)
    sort_key = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        ptr = _build.ptr
        a, b, c = (targets[0], targets[1], targets[2]) if len(targets) == 4 else (targets[0], None, None)
        _build.launch("shadow_sample_launch", dev, *_key_words(key), int(len(targets) == 2), n_s, m, ptr(lamp_xz),
                      _F(base), _F(length), ptr(a), ptr(b), ptr(c), ptr(targets[-1]), ptr(rod), ptr(direction),
                      ptr(dist), ptr(g), ptr(sort_key))
        shadow_sample.launches += 1
    return rod, direction, dist, g, sort_key


def shadow_sample(key, n_s: int, targets, lamp_xz, base: float, length: float):
    """The S x M shadow rays of one waypoint: (rod points f32[S,3], unit
    directions f32[S*M,3], lengths f32[S*M], geometry terms f32[S*M], sort
    keys i32[S*M]); ray i = s M + m runs from rod point s to target m.

    key: the waypoint's two uint32 words. targets: (v0, e1, e2, normal)
    f32[T,3] for `irradiance` (a point drawn on each triangle a sample) or
    (points, normals) f32[M,3] for `_points_direct`. lamp_xz: f32[2] on the
    targets' device; base, length: the rod's floats. On a CUDA device one
    launch of K8; on the CPU `shadow_sample_reference`."""
    dev = targets[0].device
    if dev.type == "cpu":
        return shadow_sample_reference(key, n_s, targets, lamp_xz, base, length)
    if dev.type != "cuda":
        raise ValueError(f"shadow_sample runs on cpu or cuda tensors, not {dev}")
    return _shadow_sample_kernel(key, n_s, targets, lamp_xz, base, length)


shadow_sample.launches = 0  # K8 launches, counted where the kernel is launched


# --------------------------------------------------------------------------
# K7 pack_sorted
# --------------------------------------------------------------------------


def _group(orig, dirs) -> int:
    r, g = dirs.shape[0], orig.shape[0]
    if g == 0 or r % g:
        raise ValueError(f"{r} rays cannot share {g} origins evenly")
    return r // g


def pack_sorted_reference(perm, orig, dirs, multiple: int = SHADOW_PACKET):
    """Plain PyTorch version of `pack_sorted`: the gathers, the padding
    filled on the device, the inverse permutation by a scatter."""
    r, group = dirs.shape[0], _group(orig, dirs)
    src = perm if perm is not None else torch.arange(r, device=dirs.device)
    o = orig.index_select(0, torch.div(src, group, rounding_mode="floor"))
    d = dirs.index_select(0, src)
    inverse = torch.empty(r, dtype=torch.int32, device=dirs.device).index_copy_(
        0, src, torch.arange(r, dtype=torch.int32, device=dirs.device))
    pad = (-r) % multiple
    if pad:
        park = d.new_zeros((pad, 3))
        park[:, 1] = 1.0
        o = torch.cat([o, o.new_full((pad, 3), PARK)])
        d = torch.cat([d, park])
    return o, d, inverse


def _pack_sorted_kernel(perm, orig, dirs, multiple: int):
    """One launch of csrc/diff_ops.cu's pack_sorted_kernel (K7)."""
    from uvtrace_torch import _build

    dev, r, group = dirs.device, dirs.shape[0], _group(orig, dirs)
    n_out = r + (-r) % multiple
    _build.check_elements(n_out)
    _build.check_tensor("orig", orig, torch.float32, (r // group, 3), dev)
    _build.check_tensor("dirs", dirs, torch.float32, (r, 3), dev)
    if perm is not None:
        _build.check_tensor("perm", perm, torch.int64, (r,), dev)
    o = torch.empty((n_out, 3), dtype=torch.float32, device=dev)
    d = torch.empty((n_out, 3), dtype=torch.float32, device=dev)
    inverse = torch.empty(r, dtype=torch.int32, device=dev)
    if n_out:
        ptr = _build.ptr
        _build.launch("pack_sorted_launch", dev, r, n_out, group, ptr(perm), ptr(orig), ptr(dirs), ptr(o), ptr(d),
                      ptr(inverse))
        pack_sorted.launches += 1
    return o, d, inverse


def pack_sorted(perm, orig, dirs, multiple: int = SHADOW_PACKET):
    """The batch B2 traces for R rays: (orig, dir) f32[R + pad, 3] with ray
    j of the batch the input ray perm[j] (its origin row perm[j] // (R /
    origins): S origins for S x M shadow rays, or one a ray), padded to a
    multiple of `multiple` with parked rays (origin 1e6, direction (0, 1,
    0)), and i32[R] the batch position of each input ray. perm: i64[R] (a
    stable sort's indices), or None for the input order. On a CUDA device
    one launch of K7; on the CPU `pack_sorted_reference`."""
    dev = dirs.device
    if dev.type == "cpu":
        return pack_sorted_reference(perm, orig, dirs, multiple)
    if dev.type != "cuda":
        raise ValueError(f"pack_sorted runs on cpu or cuda tensors, not {dev}")
    return _pack_sorted_kernel(perm, orig, dirs, multiple)


pack_sorted.launches = 0  # K7 launches, counted where the kernel is launched


# --------------------------------------------------------------------------
# K9 visibility_reduce
# --------------------------------------------------------------------------


def visibility_reduce_reference(t, inverse, dist, g, n_s: int, power: float):
    """Plain PyTorch version of `visibility_reduce`: visibility through the
    inverse permutation, G V summed over s in order, then power (sum / S)."""
    seen = t.index_select(0, inverse) >= dist * _F(1.0 - EPS) - _F(EPS)
    gv = (g * seen.to(torch.float32)).view(n_s, -1)
    acc = gv[0]
    for s in range(1, n_s):
        acc = acc + gv[s]
    return power * _div(acc, n_s), seen.to(torch.uint8)


def _visibility_reduce_kernel(t, inverse, dist, g, n_s: int, power: float):
    """One launch of csrc/diff_ops.cu's visibility_reduce_kernel (K9)."""
    from uvtrace_torch import _build

    dev, r = dist.device, dist.shape[0]
    if n_s <= 0 or r % n_s:
        raise ValueError(f"{r} rays are not {n_s} samples of whole targets")
    m = r // n_s
    _build.check_elements(r)
    for name, x, dtype, shape in (("t", t, torch.float32, (t.shape[0],)), ("inverse", inverse, torch.int32, (r,)),
                                  ("dist", dist, torch.float32, (r,)), ("g", g, torch.float32, (r,))):
        _build.check_tensor(name, x, dtype, shape, dev)
    e = torch.empty(m, dtype=torch.float32, device=dev)
    vis = torch.empty(r, dtype=torch.uint8, device=dev)
    if r:
        ptr = _build.ptr
        _build.launch("visibility_reduce_launch", dev, n_s, m, _F(1.0 - EPS), _F(EPS), _F(power), ptr(t),
                      ptr(inverse), ptr(dist), ptr(g), ptr(e), ptr(vis))
        visibility_reduce.launches += 1
    return e, vis


def visibility_reduce(t, inverse, dist, g, n_s: int, power: float):
    """(E f32[M], visibility u8[S*M]) of S x M shadow rays: ray i is
    visible where its hit t[inverse[i]] (t f32[N] of the traced batch) lies
    no closer than its target, t >= dist (1 - eps) - eps, and E_m = power *
    (sum_s G V) / S. On a CUDA device one launch of K9; on the CPU
    `visibility_reduce_reference`."""
    dev = dist.device
    if dev.type == "cpu":
        return visibility_reduce_reference(t, inverse, dist, g, n_s, power)
    if dev.type != "cuda":
        raise ValueError(f"visibility_reduce runs on cpu or cuda tensors, not {dev}")
    return _visibility_reduce_kernel(t, inverse, dist, g, n_s, power)


visibility_reduce.launches = 0  # K9 launches, counted where the kernel is launched


# --------------------------------------------------------------------------
# K10 direct_grad
# --------------------------------------------------------------------------


def direct_grad_terms(grad, vis, key, n_s: int, targets, lamp_xz, base, length, power):
    """f32[5, S, M]: each ray's term of d loss / d (lamp x, lamp z, rod base,
    rod length, power), in torch ops. With D = max(d.d, 1e-12) and G =
    |d.n| / (4 pi D sqrt(D)), the ray's dL/dr = -dG/dd = 3 G d / D (where
    d.d >= 1e-12, as autograd of the clamp) - sign(d.n) n / (4 pi D sqrt(D)),
    times dL/dE_m P / S and its visibility; r_y moves with the base and u_rod
    times the length; dE/dP = mean_s(G V)."""
    u_rod, _, d, n = _rays_reference(key, n_s, targets, lamp_xz, base, length)
    d2 = dot3(d, d)
    dd = torch.clamp_min(d2, 1e-12)
    cn = dot3(d, n)
    root = torch.sqrt(dd)
    g = torch.abs(cn) / root / (FOUR_PI * dd)
    a_n = torch.sign(cn) / (FOUR_PI * dd * root)
    a_d = torch.where(d2 >= _F(1e-12), 3.0 * g / dd, 0.0)
    dl_dr = a_d[..., None] * d - a_n[..., None] * n  # [S,M,3]
    w = grad[None, :] * vis.view(n_s, -1).to(torch.float32)  # [S,M]
    wp = w * _div(torch.as_tensor(power, dtype=torch.float32, device=w.device), n_s)
    return torch.stack([wp * dl_dr[..., 0], wp * dl_dr[..., 2], wp * dl_dr[..., 1], wp * dl_dr[..., 1] * u_rod,
                        _div(w * g, n_s)])


def direct_grad_reference(grad, vis, key, n_s: int, targets, lamp_xz, base, length, power):
    """Plain PyTorch version of `direct_grad`: `direct_grad_terms` summed."""
    return direct_grad_terms(grad, vis, key, n_s, targets, lamp_xz, base, length, power).sum((1, 2))


def _direct_grad_kernel(grad, vis, key, n_s: int, targets, lamp_xz, base: float, length: float, power: float):
    """One call of csrc/diff_ops.cu's direct_grad_launch (K10: the blocks'
    partials and their fixed-order sum, two kernels on the stream)."""
    from uvtrace_torch import _build

    dev = lamp_xz.device
    m = _check_targets(targets, dev)
    _build.check_elements(n_s * m)
    _build.check_tensor("lamp_xz", lamp_xz, torch.float32, (2,), dev)
    _build.check_tensor("grad", grad, torch.float32, (m,), dev)
    _build.check_tensor("vis", vis, torch.uint8, (n_s * m,), dev)
    partials = torch.empty((math.ceil(m / _GRAD_THREADS), N_GRAD), dtype=torch.float32, device=dev)
    out = torch.empty(N_GRAD, dtype=torch.float32, device=dev)
    if m and n_s:
        ptr = _build.ptr
        a, b, c = (targets[0], targets[1], targets[2]) if len(targets) == 4 else (targets[0], None, None)
        _build.launch("direct_grad_launch", dev, *_key_words(key), int(len(targets) == 2), n_s, m, ptr(lamp_xz),
                      _F(base), _F(length), _F(power), ptr(a), ptr(b), ptr(c), ptr(targets[-1]), ptr(grad), ptr(vis),
                      ptr(partials), ptr(out))
        direct_grad.launches += 1
    else:
        out.zero_()
    return out


def direct_grad(grad, vis, key, n_s: int, targets, lamp_xz, base: float, length: float, power: float):
    """f32[5] d loss / d (lamp x, lamp z, rod base, rod length, power) of
    one waypoint's E, given dL/dE f32[M] and the visibility bits u8[S*M] of
    its forward (the draws are the key's, as `shadow_sample` makes them). On
    a CUDA device one call of K10; on the CPU `direct_grad_reference`."""
    dev = grad.device
    if dev.type == "cpu":
        return direct_grad_reference(grad, vis, key, n_s, targets, lamp_xz, base, length, power)
    if dev.type != "cuda":
        raise ValueError(f"direct_grad runs on cpu or cuda tensors, not {dev}")
    return _direct_grad_kernel(grad, vis, key, n_s, targets, lamp_xz, base, length, power)


direct_grad.launches = 0  # K10 launches, counted where the kernel is launched


# --------------------------------------------------------------------------
# the estimator
# --------------------------------------------------------------------------


def _scalar(x) -> float:
    """A rod or power argument as a float (a tensor is read back: a sync on
    the card)."""
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


class DirectIrradiance(torch.autograd.Function):
    """E f32[M] of one waypoint (module docstring), differentiable in lamp_xz
    f32[2] and, where they are tensors, in rod_base_y, rod_length and power.
    The same Function runs on both devices: the kernels on `cuda`, their
    plain versions on `cpu`."""

    @staticmethod
    def forward(ctx, lamp_xz, rod_base_y, rod_length, power, scene, targets, key, n_s):
        lamp_xz = lamp_xz.detach().contiguous()
        base, length, pw = _scalar(rod_base_y), _scalar(rod_length), _scalar(power)
        rod, dirs, dist, g, sort_key = shadow_sample(key, n_s, targets, lamp_xz, base, length)
        t, inverse = scene.trace_fn(scene.trav_scene, rod, dirs, sort_key)
        e, vis = visibility_reduce(t, inverse, dist, g, n_s, pw)
        ctx.save_for_backward(lamp_xz, vis)
        ctx.args = (key, n_s, targets, base, length, pw)
        ctx.shapes = [x.shape if isinstance(x, torch.Tensor) else None for x in (rod_base_y, rod_length, power)]
        return e

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_e):
        lamp_xz, vis = ctx.saved_tensors
        key, n_s, targets, base, length, pw = ctx.args
        grads = direct_grad(grad_e.contiguous(), vis, key, n_s, targets, lamp_xz, base, length, pw)
        rest = [None if shape is None else grads[2 + k].reshape(shape) for k, shape in enumerate(ctx.shapes)]
        return (grads[:2], *rest, None, None, None, None)


def direct_irradiance(scene, targets, lamp_xz, rod_base_y, rod_length, power, key, n_s: int) -> torch.Tensor:
    """E f32[M] at the targets (`shadow_sample`'s) through `DirectIrradiance`.
    Raises where the targets require a gradient: the Function gives none
    with respect to the geometry."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in targets):
        raise ValueError("the direct estimator gives no gradient with respect to the scene's geometry, the points "
                         "or the normals; detach them, or differentiate with respect to the lamp, rod and power")
    return DirectIrradiance.apply(lamp_xz, rod_base_y, rod_length, power, scene, tuple(targets), key, n_s)
