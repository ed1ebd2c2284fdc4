"""The interreflection term's per-waypoint work as kernels, behind one
`torch.autograd.Function` (uvtrace/diff/estimator.py:396-488 in the JAX
package: `_source_field`'s draws and source-to-source matrix, and
`_receiver_transfer`).

Virtual point lights x_m (normals n_m, strengths s_m) light receivers p
through the Lambertian form factor F(x_m, p) = cos_m cos_p / (pi d^2) and a
binary visibility V:

    out_p = sum_m s_m F(x_m, p) V(x_m, p)

A waypoint runs, on a CUDA device (csrc/bounce_ops.cu):

  K11 `source_sample`: the M sources drawn from the area CDF and two keys;
  K12 `transfer_rays`: the shadow rays of B sources x P receivers, their
     lengths, F without visibility and the coherence sort's key; receivers
     drawn from a key in the kernel (`bounce_irradiance`: a point on every
     triangle a sample) or given (the dose image's points, the sources);
  the stable `torch.sort` of the keys, K7 `pack_sorted` and B2 (the scene's
     `trace_fn`, as for the direct estimator);
  K13 `transfer_reduce`: visibility through K7's inverse permutation, then
     out += sum_b s_b F V (reduce mode, keeping a visibility byte a ray) or
     F V (1 - I) (matrix mode, the M x M source-to-source transfer); in
     kept-visibility mode the same sum with V read from bytes an earlier
     reduce kept, so that nothing is traced;
  and backward K14 `transfer_grad`: d loss / d s_b = sum_p g_p F V from the
     kept bytes, F recomputed, reduced in a fixed order.

`ReceiverTransfer` runs K12, the trace and K13 over its chunks of sources
(padded to whole chunks with zero strength) and K14 a chunk backward: only
the strengths get a gradient. Given the chunks' visibility bytes (a route's
transfer plan, diff/transfer.py: receivers and sources that do not move
see the same occluders every step) it runs K12 for F and K13 in
kept-visibility mode, and traces nothing. `transfer_matrix` is the M x M
case. The Neumann iteration on that matrix, the reflectances' gather and
the mean over samples stay torch ops, as they stay XLA ops outside any
kernel in the JAX package: autograd of the reflectance polynomial flows
through them.

Each wrapper dispatches on its tensors' device: the kernel on `cuda` (a
failed build or launch raises; there is no fallback), its plain version
`*_reference` on `cpu`. The plain versions are the estimator's own op
sequence written in the kernels' order (dot products as ops/intersect.dot3,
the chunk's sum over sources in order), so that on the card K11, K12 and K13
equal them bit for bit; K14's plain version is the terms g_p F V summed.
Visibility is piecewise constant: no gradient flows through the trace, the
points, the normals or the sources (a caller that asks for one gets an
error, not a silent None).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from uvtrace_torch.diff.direct import EPS, _key_words
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import coherence_key
from uvtrace_torch.ops.generate import _F
from uvtrace_torch.ops.intersect import dot3

PI = _F(np.pi)
_GRAD_THREADS = 256  # K14's block size: one partial a source a block


def _check_rows(name, rows, dev) -> int:
    """Raise unless rows is a tuple of contiguous f32[n, 3] tensors on dev;
    return n."""
    from uvtrace_torch import _build

    n = rows[0].shape[0]
    for i, x in enumerate(rows):
        _build.check_tensor(f"{name}[{i}]", x, torch.float32, (n, 3), dev)
    return n


def _receiver_count(n_s: int, targets) -> int:
    """P: S x T drawn receivers for (v0, e1, e2, normal), or the given
    points' count for (points, normals)."""
    if len(targets) not in (2, 4):
        raise ValueError(f"targets are (v0, e1, e2, normal) or (points, normals), got {len(targets)} tensors")
    return targets[0].shape[0] * (n_s if len(targets) == 4 else 1)


def _flip(u, v):
    flip = (u + v) > 1.0
    return torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)


# --------------------------------------------------------------------------
# K11 source_sample
# --------------------------------------------------------------------------


def source_sample_reference(keys, n_sources: int, cdf, targets):
    """Plain PyTorch version of `source_sample`: `jax.random.choice` from
    the CDF (rng.choice_from_cdf) and the point draws, op for op."""
    dev = cdf.device
    v0, e1, e2, normal = targets
    src = rng.choice_from_cdf(keys[0], (n_sources,), cdf)
    ku, kv = rng.split(keys[1])
    u, v = _flip(rng.uniform_reference(ku, (n_sources, 1), dev), rng.uniform_reference(kv, (n_sources, 1), dev))
    return src, v0[src] + u * e1[src] + v * e2[src], normal[src]


def _source_sample_kernel(keys, n_sources: int, cdf, targets):
    """One launch of csrc/bounce_ops.cu's source_sample_kernel (K11)."""
    from uvtrace_torch import _build

    dev = cdf.device
    t_count = _check_rows("targets", targets, dev)
    _build.check_tensor("cdf", cdf, torch.float32, (t_count,), dev)
    _build.check_elements(n_sources)
    src = torch.empty(n_sources, dtype=torch.int64, device=dev)
    x = torch.empty((n_sources, 3), dtype=torch.float32, device=dev)
    n = torch.empty((n_sources, 3), dtype=torch.float32, device=dev)
    if n_sources and t_count:
        ptr = _build.ptr
        _build.launch("source_sample_launch", dev, *_key_words(keys[0]), *_key_words(keys[1]), n_sources, t_count,
                      ptr(cdf), *(ptr(a) for a in targets), ptr(src), ptr(x), ptr(n))
    return src, x, n


def source_sample(keys, n_sources: int, cdf, targets):
    """The virtual point lights of one waypoint: (source triangles i64[M],
    points x_m f32[M,3], normals n_m f32[M,3]). keys: the choice key
    (area-weighted triangles: the first whose cumulative area cdf f32[T]
    reaches cdf[-1] (1 - u)) and the point key (split into the u and v keys;
    x_m = v0 + u e1 + v e2 folded onto the lower triangle). targets: (v0, e1,
    e2, normal) f32[T,3]. On a CUDA device one launch of K11; on the CPU
    `source_sample_reference`."""
    dev = cdf.device
    if dev.type == "cpu":
        return source_sample_reference(keys, n_sources, cdf, targets)
    if dev.type != "cuda":
        raise ValueError(f"source_sample runs on cpu or cuda tensors, not {dev}")
    return _source_sample_kernel(keys, n_sources, cdf, targets)


# --------------------------------------------------------------------------
# K12 transfer_rays
# --------------------------------------------------------------------------


def receivers_reference(key, n_s: int, targets):
    """(points f32[P,3], normals f32[P,3]) of the receivers: a point on
    every triangle a sample (uvtrace/diff/estimator.py:217-227's
    `_sample_triangle_points` of the key, receiver p = s T + t), or the
    given points."""
    if len(targets) == 2:
        return targets
    v0, e1, e2, normal = targets
    dev, t_count = v0.device, v0.shape[0]
    ku, kv = rng.split(key)
    u, v = _flip(rng.uniform_reference(ku, (n_s, t_count, 1), dev), rng.uniform_reference(kv, (n_s, t_count, 1), dev))
    q = v0[None] + u * e1[None] + v * e2[None]
    return q.reshape(-1, 3), normal.repeat(n_s, 1)


def _form_factor(d, n_src, n_rcv):
    """(d.d, F) of rays d f32[B,P,3]: F = (|d.n_b| / sqrt(D)) (|d.n_p| /
    sqrt(D)) / (pi D), D = max(d.d, 1e-12), without visibility."""
    d2 = dot3(d, d)
    dd = torch.clamp_min(d2, 1e-12)
    root = torch.sqrt(dd)
    return d2, torch.abs(dot3(d, n_src)) / root * (torch.abs(dot3(d, n_rcv)) / root) / (PI * dd)


def transfer_rays_reference(key, n_s: int, targets, sources):
    """Plain PyTorch version of `transfer_rays`: the estimator's shadow rays
    and form factors op for op."""
    x_c, n_c = sources
    q, nq = receivers_reference(key, n_s, targets)
    d = q[None] - x_c[:, None, :]  # [B,P,3]
    d2, f = _form_factor(d, n_c[:, None, :], nq[None])
    dist = torch.sqrt(d2)
    direction = (d / torch.clamp_min(dist, 1e-20)[..., None]).reshape(-1, 3)
    orig = x_c[:, None, :].expand(d.shape).reshape(-1, 3)
    sort_key = coherence_key(orig, direction, torch.ones(orig.shape[0], dtype=torch.bool, device=orig.device))
    return direction, dist.reshape(-1), f.reshape(-1), sort_key


def _transfer_args(key, n_s: int, targets, sources, dev):
    """The entry points' shared leading arguments: (key words, points,
    B, P, T) and the source and receiver pointers."""
    from uvtrace_torch import _build

    b_count = _check_rows("sources", sources, dev)
    t_count = _check_rows("targets", targets, dev)
    p_count = _receiver_count(n_s, targets)
    _build.check_elements(b_count * p_count)
    points = len(targets) == 2
    words = (0, 0) if points else _key_words(key)
    ptr = _build.ptr
    a, b, c = (targets[0], None, None) if points else targets[:3]
    return (*words, int(points), b_count, p_count, t_count, *(ptr(x) for x in (*sources, a, b, c, targets[-1])))


def _transfer_rays_kernel(key, n_s: int, targets, sources):
    """One launch of csrc/bounce_ops.cu's transfer_rays_kernel (K12)."""
    from uvtrace_torch import _build

    dev = sources[0].device
    args = _transfer_args(key, n_s, targets, sources, dev)
    r = args[3] * args[4]
    direction = torch.empty((r, 3), dtype=torch.float32, device=dev)
    dist = torch.empty(r, dtype=torch.float32, device=dev)
    f = torch.empty(r, dtype=torch.float32, device=dev)
    sort_key = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        ptr = _build.ptr
        _build.launch("transfer_rays_launch", dev, *args, ptr(direction), ptr(dist), ptr(f), ptr(sort_key))
    return direction, dist, f, sort_key


def transfer_rays(key, n_s: int, targets, sources):
    """The B x P shadow rays of one chunk of sources: (unit directions
    f32[B*P,3], lengths f32[B*P], form factors without visibility
    f32[B*P], sort keys i32[B*P]); ray i = b P + p runs from source b to
    receiver p.

    sources: (x_c, n_c) f32[B,3]. targets: (v0, e1, e2, normal) f32[T,3]
    with the receivers' key and n_s samples (P = S T receivers drawn from
    key as `receivers_reference` draws them), or (points, normals)
    f32[P,3] (key and n_s unused). On a CUDA device one launch of K12; on the
    CPU `transfer_rays_reference`."""
    dev = sources[0].device
    if dev.type == "cpu":
        return transfer_rays_reference(key, n_s, targets, sources)
    if dev.type != "cuda":
        raise ValueError(f"transfer_rays runs on cpu or cuda tensors, not {dev}")
    return _transfer_rays_kernel(key, n_s, targets, sources)


# --------------------------------------------------------------------------
# K13 transfer_reduce
# --------------------------------------------------------------------------


def transfer_reduce_reference(t, inverse, dist, f, n_src: int, strength=None, acc=None, vis=None):
    """Plain PyTorch version of `transfer_reduce`: visibility through the
    inverse permutation (or the kept bytes vis), then the sources' terms
    summed in order and added to acc (reduce mode), or F V (1 - I) (matrix
    mode)."""
    if vis is None:
        seen = t.index_select(0, inverse) >= dist * _F(1.0 - EPS) - _F(EPS)
    else:
        _check_kept(vis, f, strength)
        seen = vis != 0
    fv = (f * seen.to(torch.float32)).view(n_src, -1)
    if strength is None:
        return fv * (1.0 - torch.eye(n_src, fv.shape[1], device=f.device))
    terms = strength[:, None] * fv
    part = terms[0]
    for b in range(1, n_src):
        part = part + terms[b]
    return (part if acc is None else acc + part), (seen.to(torch.uint8) if vis is None else vis)


def _check_kept(vis, f, strength):
    """Raise unless vis can stand for a reduce's traced visibility: a byte
    a ray of f, and a reduce (strength given)."""
    if strength is None:
        raise ValueError("kept visibility serves reduce mode only: give the strengths")
    if vis.dtype != torch.uint8 or vis.shape != f.shape:
        raise ValueError(f"kept visibility is u8{list(f.shape)}, got {vis.dtype}{list(vis.shape)}")


def _transfer_reduce_kernel(t, inverse, dist, f, n_src: int, strength=None, acc=None, vis=None):
    """One launch of csrc/bounce_ops.cu's transfer_reduce_kernel (K13);
    reduce mode adds into acc in place where it is given; with vis it reads
    those bytes (kept-visibility mode: t, inverse and dist unused)."""
    from uvtrace_torch import _build

    dev, r = f.device, f.shape[0]
    if n_src <= 0 or r % n_src:
        raise ValueError(f"{r} rays are not {n_src} sources of whole receivers")
    p_count = r // n_src
    _build.check_elements(r)
    if vis is None:
        checked = (("t", t, torch.float32, (t.shape[0],)), ("inverse", inverse, torch.int32, (r,)),
                   ("dist", dist, torch.float32, (r,)), ("f", f, torch.float32, (r,)))
    else:
        _check_kept(vis, f, strength)
        checked = (("f", f, torch.float32, (r,)), ("vis", vis, torch.uint8, (r,)))
        t = inverse = dist = None
    for name, x, dtype, shape in checked:
        _build.check_tensor(name, x, dtype, shape, dev)
    if strength is None:
        if p_count != n_src:
            raise ValueError(f"matrix mode takes {n_src} x {n_src} rays, got {n_src} x {p_count}")
        out, vis = torch.empty((n_src, p_count), dtype=torch.float32, device=dev), None
    else:
        _build.check_tensor("strength", strength, torch.float32, (n_src,), dev)
        if acc is not None:
            _build.check_tensor("acc", acc, torch.float32, (p_count,), dev)
        out = acc if acc is not None else torch.empty(p_count, dtype=torch.float32, device=dev)
        if vis is None:
            vis = torch.empty(r, dtype=torch.uint8, device=dev)
    if r:
        ptr = _build.ptr
        _build.launch("transfer_reduce_launch", dev, n_src, p_count, _F(1.0 - EPS), _F(EPS), ptr(t), ptr(inverse),
                      ptr(dist), ptr(f), ptr(strength), ptr(acc), ptr(out), ptr(vis))
    return out if strength is None else (out, vis)


def transfer_reduce(t, inverse, dist, f, n_src: int, strength=None, acc=None, vis=None):
    """One chunk's traced rays reduced: ray i (of n_src x P) is visible
    where its hit t[inverse[i]] (t f32[N] of the traced batch) lies no
    closer than its receiver, t >= dist (1 - eps) - eps.

    Reduce mode (strength f32[B]): (out f32[P], visibility u8[B*P]) with
    out_p = acc_p + sum_b s_b F V, the sources in order (acc None: the sum
    alone); on the card acc is updated in place and returned. Kept-visibility
    mode (vis u8[B*P], the bytes a reduce of the same rays returned; t,
    inverse and dist unused): the same sum with V read from vis, bit for bit
    the traced reduce's, and vis returned as it is. Matrix mode (strength
    None, P = B): F V (1 - I) f32[B,B]. On a CUDA device one launch of K13;
    on the CPU `transfer_reduce_reference`."""
    dev = (dist if vis is None else vis).device
    if dev.type == "cpu":
        return transfer_reduce_reference(t, inverse, dist, f, n_src, strength, acc, vis)
    if dev.type != "cuda":
        raise ValueError(f"transfer_reduce runs on cpu or cuda tensors, not {dev}")
    return _transfer_reduce_kernel(t, inverse, dist, f, n_src, strength, acc, vis)


# --------------------------------------------------------------------------
# K14 transfer_grad
# --------------------------------------------------------------------------


def transfer_grad_terms(grad, vis, key, n_s: int, targets, sources):
    """f32[B, P]: each ray's term g_p F_bp V_bp of d loss / d s_b."""
    x_c, n_c = sources
    q, nq = receivers_reference(key, n_s, targets)
    f = _form_factor(q[None] - x_c[:, None, :], n_c[:, None, :], nq[None])[1]
    return grad[None, :] * (f * vis.view(f.shape).to(torch.float32))


def transfer_grad_reference(grad, vis, key, n_s: int, targets, sources):
    """Plain PyTorch version of `transfer_grad`: `transfer_grad_terms`
    summed over the receivers."""
    return transfer_grad_terms(grad, vis, key, n_s, targets, sources).sum(1)


def _transfer_grad_kernel(grad, vis, key, n_s: int, targets, sources):
    """One call of csrc/bounce_ops.cu's transfer_grad_launch (K14: the
    blocks' partials and their fixed-order sum, two kernels on the
    stream)."""
    from uvtrace_torch import _build

    dev = sources[0].device
    args = _transfer_args(key, n_s, targets, sources, dev)
    b_count, p_count = args[3], args[4]
    _build.check_tensor("grad", grad, torch.float32, (p_count,), dev)
    _build.check_tensor("vis", vis, torch.uint8, (b_count * p_count,), dev)
    partials = torch.empty((math.ceil(p_count / _GRAD_THREADS), b_count), dtype=torch.float32, device=dev)
    out = torch.empty(b_count, dtype=torch.float32, device=dev)
    if b_count and p_count:
        ptr = _build.ptr
        _build.launch("transfer_grad_launch", dev, *args, ptr(grad), ptr(vis), ptr(partials), ptr(out))
    else:
        out.zero_()
    return out


def transfer_grad(grad, vis, key, n_s: int, targets, sources):
    """f32[B] d loss / d s_b of one chunk's reduce, given dL/dout f32[P] and
    the visibility bytes u8[B*P] of its forward (the receivers are the
    key's, as `transfer_rays` draws them). On a CUDA device one call of
    K14; on the CPU `transfer_grad_reference`."""
    dev = grad.device
    if dev.type == "cpu":
        return transfer_grad_reference(grad, vis, key, n_s, targets, sources)
    if dev.type != "cuda":
        raise ValueError(f"transfer_grad runs on cpu or cuda tensors, not {dev}")
    return _transfer_grad_kernel(grad, vis, key, n_s, targets, sources)


# --------------------------------------------------------------------------
# the transfer
# --------------------------------------------------------------------------


def _refuse_geometry_gradients(*tensors):
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise ValueError("the interreflection transfer gives no gradient with respect to the sources' points or "
                         "normals, the receivers or the scene's geometry; detach them, or differentiate with "
                         "respect to the strengths")


def _chunks(x_m, n_m, chunk: int):
    """The source rows (x, n) of each chunk of `chunk` sources, the last
    padded with copies of source 0."""
    pad = (-x_m.shape[0]) % chunk
    if pad:
        x_m = torch.cat([x_m, x_m[:1].expand(pad, 3)])
        n_m = torch.cat([n_m, n_m[:1].expand(pad, 3)])
    return [(x_m[c:c + chunk], n_m[c:c + chunk]) for c in range(0, x_m.shape[0], chunk)]


def _chunk_size(source_chunk: int, m: int) -> int:
    return max(1, min(source_chunk, m))


def _traced_chunk(scene, key, n_s: int, targets, src, strength, acc):
    """One chunk of sources through K12, the trace and K13's reduce mode:
    (out, visibility bytes)."""
    dirs, dist, f, sort_key = transfer_rays(key, n_s, targets, src)
    t, inverse = scene.trace_fn(scene.trav_scene, src[0], dirs, sort_key)
    return transfer_reduce(t, inverse, dist, f, src[0].shape[0], strength, acc)


def _kept_chunk(key, n_s: int, targets, src, strength, acc, vis):
    """One chunk of sources through K12 (for F) and K13's kept-visibility
    mode on its bytes vis: (out, vis)."""
    f = transfer_rays(key, n_s, targets, src)[2]
    return transfer_reduce(None, None, None, f, src[0].shape[0], strength, acc, vis)


class ReceiverTransfer(torch.autograd.Function):
    """out f32[P] = sum_m s_m F(x_m, p) V(x_m, p) (module docstring),
    differentiable in the strengths s f32[M] only. The sources go in chunks
    of `chunk` (the last padded with zero strength); each chunk is K12, the
    trace and K13 forward, K14 backward. With `kept`, a chunk's visibility
    bytes, a chunk is K12 and K13 in kept-visibility mode, and the backward
    reads those bytes as they are. The same Function runs on both devices:
    the kernels on `cuda`, their plain versions on `cpu`."""

    @staticmethod
    def forward(ctx, strength, scene, sources, key, n_s, targets, chunk, kept):
        m = strength.shape[0]
        chunks = _chunks(*sources, chunk)
        s = strength.detach()
        if chunk * len(chunks) > m:
            s = torch.cat([s, s.new_zeros(chunk * len(chunks) - m)])
        acc, seen = None, []
        for c, src in enumerate(chunks):
            s_c = s[c * chunk:(c + 1) * chunk]
            if kept is None:
                acc, vis = _traced_chunk(scene, key, n_s, targets, src, s_c, acc)
            else:
                acc, vis = _kept_chunk(key, n_s, targets, src, s_c, acc, kept[c])
            seen.append(vis)
        ctx.save_for_backward(*seen)
        ctx.args = (chunks, key, n_s, targets, m)
        return acc

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        chunks, key, n_s, targets, m = ctx.args
        g = grad_out.contiguous()
        ds = [transfer_grad(g, vis, key, n_s, targets, src) for vis, src in zip(ctx.saved_tensors, chunks)]
        return torch.cat(ds)[:m], None, None, None, None, None, None, None


def receiver_transfer(scene, strength, sources, key, n_s: int, targets, source_chunk: int,
                      transfer=None) -> torch.Tensor:
    """sum_m s_m F(x_m, p) V(x_m, p) f32[P] through `ReceiverTransfer`, over
    chunks of source_chunk sources. sources: (x_m, n_m) f32[M,3]; targets:
    `transfer_rays`'. transfer: the visibility bytes of each chunk of these
    sources and receivers (`receiver_visibility`), read in place of a trace;
    None traces them. Raises where the sources or the targets require a
    gradient: the Function gives none."""
    _refuse_geometry_gradients(*sources, *targets)
    chunk = _chunk_size(source_chunk, sources[0].shape[0])
    sources = tuple(x.contiguous() for x in sources)
    targets = tuple(x.contiguous() for x in targets)
    if transfer is not None and len(transfer) != -(-sources[0].shape[0] // chunk):
        raise ValueError(f"{len(transfer)} chunks of kept visibility for {sources[0].shape[0]} sources in chunks "
                         f"of {chunk}")
    return ReceiverTransfer.apply(strength, scene, sources, key, n_s, targets, chunk, transfer)


def receiver_visibility(scene, sources, key, n_s: int, targets, source_chunk: int) -> tuple:
    """The visibility bytes u8[chunk * P] of each chunk of source_chunk
    sources (the last padded as `ReceiverTransfer` pads it), traced as
    `receiver_transfer` traces them: what it reads in their place."""
    _refuse_geometry_gradients(*sources, *targets)
    chunk = _chunk_size(source_chunk, sources[0].shape[0])
    targets = tuple(x.contiguous() for x in targets)
    zero = sources[0].new_zeros(chunk)
    return tuple(_traced_chunk(scene, key, n_s, targets, src, zero, None)[1]
                 for src in _chunks(*(x.contiguous() for x in sources), chunk))


def transfer_matrix(scene, x_m, n_m) -> torch.Tensor:
    """The M x M source-to-source transfer F V (1 - I) f32[M,M], row m' the
    source, column m the receiver: K12 with the sources as given receivers,
    the trace and K13 in matrix mode. Constant: raises where x_m or n_m
    require a gradient."""
    _refuse_geometry_gradients(x_m, n_m)
    sources = (x_m.contiguous(), n_m.contiguous())
    dirs, dist, f, sort_key = transfer_rays(None, 1, sources, sources)
    t, inverse = scene.trace_fn(scene.trav_scene, sources[0], dirs, sort_key)
    return transfer_reduce(t, inverse, dist, f, x_m.shape[0])
