"""The interreflection term's kernels (csrc/bounce_ops.cu: K11
`source_sample`, K12 `transfer_rays`, K13 `transfer_reduce`, K14
`transfer_grad`) and the `ReceiverTransfer` Function around them
(uvtrace_torch/diff/bounce.py), on the CPU.

Each plain version goes against the JAX package's expressions on the box
room of tests/test_torch_diff.py: K11's source triangles equal
`jax.random.choice` and its points JAX's bit for bit (the same uniforms and
f32 steps); K12's directions and lengths within 2 ulp and its form factors
within 8 ulp of JAX's (uvtrace/diff/estimator.py:466-480: XLA:CPU sums the
three products of a dot product and divides in its own order; 2, 1 and 4
ulp measured); K13 and K14 against one JAX chunk, JAX's source-to-source
matrix and `jax.grad` at rtol 2e-3 (JAX traces its shadow rays with its
clustered Möller–Trumbore backend, the port with B2's plain Plücker tests).
The whole term, the route dose and the dose image with reflectance go
against JAX's with their gradients at the same tolerance, at 1, 2 and 4
bounces. K14's plain version goes against torch autograd of the plain
forward at rtol 1e-5.

There is no card here, so a CUDA request is followed as far as the C entry
point, as in tests/test_torch_diff_kernels.py; the kernels' bit equality to
these plain versions is tests/test_torch_cuda.py's, on the card.
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace import diff as J
from uvtrace.diff import estimator as jest
from uvtrace.geometry.procedural import make_box_room
from uvtrace_torch import _build
from uvtrace_torch import diff as P
from uvtrace_torch.diff import bounce
from uvtrace_torch.diff import estimator as est
from uvtrace_torch.ops import rng
from uvtrace_torch.utils import timing

RTOL, ATOL = 2e-3, 1e-6
LAMP = np.array([0.3, -0.4], np.float32)
KERNELS = ("source_sample", "transfer_rays", "transfer_reduce", "transfer_grad")
KEY = jax.random.fold_in(jax.random.PRNGKey(5), 3)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)


@pytest.fixture(scope="module")
def scenes(room):
    return J.make_diff_scene(room), P.make_diff_scene(room, device="cpu")


@pytest.fixture(scope="module")
def field(room, scenes):
    """The port's sources of KEY (K11's plain version) and their keys."""
    ps = scenes[1]
    keys = rng.split(_words(KEY), 4)
    cdf = est._source_cdf(ps, room.areas)[0]
    src, x_m, n_m = bounce.source_sample_reference((keys[0], keys[1]), 12, cdf, _tri(ps))
    return keys, src, x_m, n_m


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _tri(scene):
    return scene.v0, scene.e1, scene.e2, scene.normal


def _plan_points(ps):
    plan = P.plan_dose_image(ps, res=12)
    return plan.points[plan.mask].contiguous(), plan.normals[plan.mask].contiguous()


def _ulps(a, b) -> np.ndarray:
    """|a - b| in f32 ulps of b (a and b f32 arrays)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b).astype(np.float32)).astype(np.float64)


# ------------------------------------------------------ each plain version against JAX


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_source_sample_is_jax_choice(room, scenes, seed):
    """K11's plain version: the source triangles are jax.random.choice's
    with p = areas / sum(areas), the points and normals JAX's bit for bit
    (uvtrace/diff/estimator.py:404-413)."""
    js, ps = scenes
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    areas = jnp.asarray(room.areas)
    src_j = jax.random.choice(keys[0], room.triangle_count, (64,), p=areas / jnp.sum(areas))
    ku, kv = jax.random.split(keys[1])
    u, v = jax.random.uniform(ku, (64, 1)), jax.random.uniform(kv, (64, 1))
    flip = (u + v) > 1.0
    u, v = jnp.where(flip, 1.0 - u, u), jnp.where(flip, 1.0 - v, v)
    x_j = js.v0[src_j] + u * js.e1[src_j] + v * js.e2[src_j]
    cdf = est._source_cdf(ps, room.areas)[0]
    src, x_m, n_m = bounce.source_sample((_words(keys[0]), _words(keys[1])), 64, cdf, _tri(ps))
    assert src.dtype == torch.int64
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(x_m.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(n_m.numpy(), ps.normal.numpy()[np.asarray(src_j)])


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_transfer_rays_match_jax(scenes, field, mode):
    """K12's plain version against JAX's expressions for one chunk: the
    receivers (drawn as `_sample_triangle_points` draws them, or given), the
    unit directions and lengths of `_visibility`'s shadow rays within 2 ulp,
    and the form factors cos_m cos_p / (pi max(d.d, 1e-12)) within 8 ulp;
    the sort keys are coherence_key's of those rays."""
    js, ps = scenes
    keys, _, x_m, n_m = field
    x_c, n_c = x_m[:5].contiguous(), n_m[:5].contiguous()
    if mode == "triangles":
        targets, n_s = _tri(ps), 2
        qs = jest._sample_triangle_points(js, jax.random.wrap_key_data(jnp.asarray(keys[3])), n_s)
        pts = qs.reshape(-1, 3)
        nrm = jnp.broadcast_to(js.normal[None], (n_s, *js.normal.shape)).reshape(-1, 3)
    else:
        targets, n_s = _plan_points(ps), 1
        pts, nrm = (jnp.asarray(x.numpy()) for x in targets)
    dirs, dist, f, sort_key = bounce.transfer_rays(keys[3], n_s, targets, (x_c, n_c))
    xj, nj = jnp.asarray(x_c.numpy()), jnp.asarray(n_c.numpy())
    d = pts[None] - xj[:, None, :]
    dist2 = jnp.sum(d * d, axis=-1)
    cl = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    cos_m = jnp.abs(jnp.sum(d * nj[:, None, :], axis=-1)) / cl
    cos_p = jnp.abs(jnp.sum(d * nrm[None], axis=-1)) / cl
    f_j = np.asarray(cos_m * cos_p / (np.pi * jnp.maximum(dist2, 1e-12))).reshape(-1)
    length = jnp.linalg.norm(d, axis=-1)
    dir_j = np.asarray(d / jnp.maximum(length[..., None], 1e-20)).reshape(-1, 3)
    r = 5 * pts.shape[0]
    assert dirs.shape == (r, 3) and dist.shape == f.shape == sort_key.shape == (r,)
    assert _ulps(dist.numpy(), np.asarray(length).reshape(-1)).max() <= 2
    assert _ulps(dirs.numpy(), dir_j).max() <= 2
    assert _ulps(f.numpy(), f_j).max() <= 8 and (f_j > 0).mean() > 0.5
    orig = x_c.repeat_interleave(pts.shape[0], 0)
    assert torch.equal(sort_key, P.estimator.coherence_key(orig, dirs, torch.ones(r, dtype=torch.bool)))


def _jax_chunk(js, pts, nrm, x_c, n_c, s_c):
    """JAX's receiver transfer of one chunk of sources (`_receiver_transfer`
    with the chunk as its only chunk)."""
    return jest._receiver_transfer(js, pts, nrm, x_c, n_c, s_c, x_c.shape[0])


def _trace(ps, dirs, x_c, sort_key):
    return ps.trace_fn(ps.trav_scene, x_c, dirs, sort_key)


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_transfer_reduce_matches_a_jax_chunk(scenes, field, mode):
    """K13's reduce mode after K12 and the trace, chunk after chunk, against
    JAX's receiver transfer of the same sources and strengths."""
    js, ps = scenes
    keys, _, x_m, n_m = field
    s = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2.0, 8).astype(np.float32))
    if mode == "triangles":
        targets, n_s = _tri(ps), 2
        pts, nrm = bounce.receivers_reference(keys[3], n_s, targets)
    else:
        targets, n_s = _plan_points(ps), 1
        pts, nrm = targets
    acc = None
    for c in (0, 4):
        src = (x_m[c:c + 4].contiguous(), n_m[c:c + 4].contiguous())
        dirs, dist, f, sort_key = bounce.transfer_rays(keys[3], n_s, targets, src)
        t, inverse = _trace(ps, dirs, src[0], sort_key)
        acc, vis = bounce.transfer_reduce(t, inverse, dist, f, 4, s[c:c + 4], acc)
        assert vis.dtype == torch.uint8 and vis.shape == (4 * pts.shape[0],) and 0.2 < vis.float().mean() < 1
    want = _jax_chunk(js, *(jnp.asarray(x.numpy()) for x in (pts, nrm, x_m[:8], n_m[:8], s)))
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


def test_transfer_matrix_matches_jax(scenes, field):
    """K13's matrix mode (after K12 with the sources as receivers and the
    trace): JAX's source-to-source matrix F V (1 - I) (uvtrace/diff/
    estimator.py:425-443)."""
    js, ps = scenes
    _, _, x_m, n_m = field
    f_ss = bounce.transfer_matrix(ps, x_m, n_m)
    xj, nj = jnp.asarray(x_m.numpy()), jnp.asarray(n_m.numpy())
    m = xj.shape[0]
    d = xj[None] - xj[:, None]
    dist2 = jnp.sum(d * d, axis=-1)
    cl = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    cos_src = jnp.abs(jnp.sum(d * nj[:, None, :], axis=-1)) / cl
    cos_rcv = jnp.abs(jnp.sum(d * nj[None, :, :], axis=-1)) / cl
    vis = jax.jit(lambda x: jest._visibility(js, x[:, None, :], jnp.broadcast_to(x[None], (m, m, 3))))(xj)
    want = np.asarray(cos_src * cos_rcv / (np.pi * jnp.maximum(dist2, 1e-12)) * vis * (1.0 - jnp.eye(m)))
    assert f_ss.shape == (m, m) and (np.diag(f_ss.numpy()) == 0).all() and (want > 0).mean() > 0.3
    np.testing.assert_allclose(f_ss.numpy(), want, rtol=RTOL, atol=ATOL * float(want.max()))


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_transfer_grad_matches_jax_grad(scenes, field, mode):
    """K14's plain version given K13's visibility bytes and a dL/dout:
    jax.grad of sum(g out) with respect to the chunk's strengths."""
    js, ps = scenes
    keys, _, x_m, n_m = field
    src = (x_m[:6].contiguous(), n_m[:6].contiguous())
    if mode == "triangles":
        targets, n_s = _tri(ps), 2
        pts, nrm = bounce.receivers_reference(keys[3], n_s, targets)
    else:
        targets, n_s = _plan_points(ps), 1
        pts, nrm = targets
    dirs, dist, f, sort_key = bounce.transfer_rays(keys[3], n_s, targets, src)
    t, inverse = _trace(ps, dirs, src[0], sort_key)
    _, vis = bounce.transfer_reduce(t, inverse, dist, f, 6, torch.ones(6))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=pts.shape[0]).astype(np.float32))
    got = bounce.transfer_grad(g, vis, keys[3], n_s, targets, src)
    jx = [jnp.asarray(x.numpy()) for x in (pts, nrm, *src)]
    want = jax.grad(lambda s: jnp.sum(jnp.asarray(g.numpy()) * _jax_chunk(js, *jx, s)))(jnp.ones(6))
    scale = bounce.transfer_grad_terms(g, vis, keys[3], n_s, targets, src).abs().sum(1).numpy()
    assert got.shape == (6,) and (scale > 0).all()
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want)), RTOL * scale)


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_kept_visibility_mode_is_the_traced_mode(scenes, field, mode):
    """K13's plain version in kept-visibility mode, given the bytes its
    traced mode returned for the same rays, chunk after chunk: the same
    sums bit for bit, the bytes returned as they are; it serves reduce mode
    alone, on bytes of the rays' shape."""
    ps = scenes[1]
    keys, _, x_m, n_m = field
    s = torch.from_numpy(np.random.default_rng(8).uniform(0.5, 2.0, 8).astype(np.float32))
    targets, n_s = (_tri(ps), 2) if mode == "triangles" else (_plan_points(ps), 1)
    traced = kept = None
    for c in (0, 4):
        src = (x_m[c:c + 4].contiguous(), n_m[c:c + 4].contiguous())
        dirs, dist, f, sort_key = bounce.transfer_rays_reference(keys[3], n_s, targets, src)
        t, inverse = _trace(ps, dirs, src[0], sort_key)
        traced, vis = bounce.transfer_reduce_reference(t, inverse, dist, f, 4, s[c:c + 4], traced)
        kept, same = bounce.transfer_reduce_reference(None, None, None, f, 4, s[c:c + 4], kept, vis)
        assert same is vis and torch.equal(kept, traced)
    assert bounce.transfer_reduce(None, None, None, f, 4, s[4:], None, vis)[1] is vis
    with pytest.raises(ValueError, match="reduce mode only"):
        bounce.transfer_reduce_reference(None, None, None, f, 4, None, None, vis)
    with pytest.raises(ValueError, match="kept visibility is u8"):
        bounce.transfer_reduce_reference(None, None, None, f, 4, s[4:], None, vis.bool())
    with pytest.raises(ValueError, match="kept visibility is u8"):
        bounce.transfer_reduce_reference(None, None, None, f, 4, s[4:], None, vis[1:])


def test_plain_backward_is_autograd_of_the_plain_forward(scenes, field):
    """K14's plain version against torch autograd of K12's plain version,
    the trace and K13's, through two chunks: rtol 1e-5, with an absolute
    term of 1e-6 times the terms' absolute sum."""
    ps = scenes[1]
    keys, _, x_m, n_m = field
    s = torch.linspace(0.5, 1.5, 8, requires_grad=True)
    w = torch.from_numpy(np.random.default_rng(5).normal(size=2 * ps.v0.shape[0]).astype(np.float32))
    acc, kept = None, []
    for c in (0, 4):
        src = (x_m[c:c + 4].contiguous(), n_m[c:c + 4].contiguous())
        dirs, dist, f, sort_key = bounce.transfer_rays_reference(keys[3], 2, _tri(ps), src)
        t, inverse = _trace(ps, dirs, src[0], sort_key)
        acc, vis = bounce.transfer_reduce_reference(t, inverse, dist, f, 4, s[c:c + 4], acc)
        kept.append((vis, src))
    (auto,) = torch.autograd.grad((acc * w).sum(), s)
    closed = torch.cat([bounce.transfer_grad_reference(w, vis, keys[3], 2, _tri(ps), src) for vis, src in kept])
    scale = torch.cat([bounce.transfer_grad_terms(w, vis, keys[3], 2, _tri(ps), src).abs().sum(1)
                       for vis, src in kept])
    np.testing.assert_array_less(np.abs(closed.numpy() - auto.numpy()),
                                 1e-5 * np.abs(auto.numpy()) + 1e-6 * scale.numpy() + 1e-30)


# ------------------------------------------------------ the term, the route dose and the image against JAX


def _jax_value_and_grads(fn, args):
    """JAX's fn(*args) and the gradients of its sum with respect to every
    argument, jitted as one program (one compile instead of one an op)."""
    out, grads = jax.jit(lambda *a: (fn(*a), jax.grad(lambda *b: jnp.sum(fn(*b)), argnums=tuple(range(len(a))))(
        *a)))(*(jnp.asarray(a) for a in args))
    return np.asarray(out), grads


@pytest.mark.parametrize("n_bounces", [1, 2, 4])
def test_bounce_irradiance_matches_jax(room, scenes, n_bounces):
    """bounce_irradiance through K11, the matrix and ReceiverTransfer (12
    sources in chunks of 5: the last one padded) against JAX's, with the
    gradients with respect to lamp xz, power and every triangle's
    reflectance."""
    js, ps = scenes
    base = np.float32(room.floor_height + 0.8)
    rho = np.random.default_rng(6).uniform(0.2, 0.6, room.triangle_count).astype(np.float32)
    kw = dict(n_samples=2, n_sources=12, n_bounces=n_bounces, source_chunk=5)

    def jf(xz, pw, r):
        return J.bounce_irradiance(js, xz, base, 1.0, pw, r, jnp.asarray(room.areas), KEY, **kw)

    args = (LAMP, np.float32(450.0), rho)
    ej, gj = _jax_value_and_grads(jf, args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ep = P.bounce_irradiance(ps, ts[0], base, 1.0, ts[1], ts[2], room.areas, _words(KEY), **kw)
    gp = torch.autograd.grad(ep.sum(), ts)
    np.testing.assert_allclose(ep.detach().numpy(), ej, rtol=RTOL, atol=ATOL)
    for g_p, g_j in zip(gp, gj):
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)
    assert (ep > 0).float().mean() > 0.5 and all(bool((g != 0).any()) for g in gp)


def test_route_dose_with_four_bounces_matches_jax(room, scenes):
    """route_dose over two waypoints with the 4-bounce term: the dose and
    its gradients with respect to the waypoints, the durations, the power
    and every reflectance."""
    js, ps = scenes
    base = np.float32(room.floor_height + 0.8)
    args = (np.array([[0.3, -0.4], [-0.5, 0.2]], np.float32), np.array([40.0, 25.0], np.float32),
            np.float32(450.0), np.full(room.triangle_count, 0.4, np.float32))
    kw = dict(n_samples=2, n_sources=10, n_bounces=4)

    def jf(wp, durs, pw, r):
        return J.route_dose(js, wp, durs, base, 1.0, pw, KEY, reflectance=r, areas=jnp.asarray(room.areas), **kw)

    dj, gj = _jax_value_and_grads(jf, args)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    dp = P.route_dose(ps, ts[0], ts[1], base, 1.0, ts[2], _words(KEY), reflectance=ts[3], areas=room.areas, **kw)
    gp = torch.autograd.grad(dp.sum(), ts)
    np.testing.assert_allclose(dp.detach().numpy(), dj, rtol=RTOL, atol=ATOL)
    for g_p, g_j in zip(gp, gj):
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)


def test_dose_image_with_reflectance_matches_jax(room, scenes):
    """The dose image with the 4-bounce term (8 sources in chunks of 3)
    through ReceiverTransfer on the plan's points, and the gradients of its
    sum with respect to the waypoints and the reflectance."""
    js, ps = scenes
    jplan, pplan = J.plan_dose_image(js, res=12), P.plan_dose_image(ps, res=12)
    base = room.floor_height + 0.8
    wp, durs = np.array([[0.1, 0.2], [-0.5, 0.4]], np.float32), np.array([45.0, 30.0], np.float32)
    kw = dict(n_samples=2, n_sources=8, n_bounces=4, source_chunk=3)

    def jf(w, r):
        return J.dose_image(js, jplan, w, durs, base, 1.0, 450.0, KEY, reflectance=r, areas=jnp.asarray(room.areas),
                            **kw)

    img_j, gj = _jax_value_and_grads(jf, (wp, np.float32(0.5)))
    w_t, r_t = torch.tensor(wp, requires_grad=True), torch.tensor(0.5, requires_grad=True)
    img_p = P.dose_image(ps, pplan, w_t, durs, base, 1.0, 450.0, _words(KEY), reflectance=r_t, areas=room.areas, **kw)
    gp = torch.autograd.grad(img_p.sum(), (w_t, r_t))
    same = (pplan.tri.numpy() == np.asarray(jplan.tri)).reshape(img_j.shape)
    assert same.mean() > 0.9
    np.testing.assert_allclose(img_p.detach().numpy()[same], img_j[same], rtol=RTOL, atol=1e-4)
    for g_p, g_j in zip(gp, gj):
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-5)


def test_geometry_gradients_are_refused(scenes, field):
    """ReceiverTransfer gives a gradient for the strengths only: asking for
    one with respect to the points, the normals or the sources raises; the
    matrix is constant in the sources. Without a graph the inputs run."""
    ps = scenes[1]
    _, _, x_m, n_m = field
    pts, nrm = _plan_points(ps)
    s = torch.ones(12, requires_grad=True)
    for sources, targets in (((x_m, n_m), (pts.clone().requires_grad_(True), nrm)),
                             ((x_m, n_m), (pts, nrm.clone().requires_grad_(True))),
                             ((x_m.clone().requires_grad_(True), n_m), (pts, nrm)),
                             ((x_m, n_m.clone().requires_grad_(True)), (pts, nrm))):
        with pytest.raises(ValueError, match="no gradient"):
            bounce.receiver_transfer(ps, s, sources, None, 1, targets, 4)
    with pytest.raises(ValueError, match="no gradient"):
        bounce.transfer_matrix(ps, x_m.clone().requires_grad_(True), n_m)
    out = bounce.receiver_transfer(ps, s, (x_m, n_m), None, 1, (pts, nrm), 5)
    (g,) = torch.autograd.grad(out.sum(), s)
    assert g.shape == (12,) and bool((g > 0).any())
    with torch.no_grad():
        bounce.receiver_transfer(ps, s, (x_m, n_m), None, 1, (pts.clone().requires_grad_(True), nrm), 4)


# ------------------------------------------------------ the dispatch


def _must_not_run(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} ran")
    return fail


PLAIN = {name: getattr(bounce, f"{name}_reference") for name in KERNELS}
PLAIN_TERMS = bounce.transfer_grad_terms


class _Ptr(ctypes.c_void_p):
    """A device address that remembers its tensor (the emulator reads it)."""


def _ptr(x):
    p = _Ptr(0 if x is None else x.data_ptr())
    p.tensor = x
    return p


@pytest.fixture
def on_card(monkeypatch):
    """The kernels' wrappers as far as the C entry point, on CPU tensors:
    the plain bodies refused, every `_build.call` recorded."""
    for name in KERNELS:
        monkeypatch.setattr(bounce, f"{name}_reference", _must_not_run(f"{name}_reference"))
    monkeypatch.setattr(bounce, "transfer_grad_terms", _must_not_run("transfer_grad_terms"))
    monkeypatch.setattr(_build, "ptr", _ptr)
    calls = []
    monkeypatch.setattr(_build, "call", lambda name, device, *args: calls.append((name, device, args)))
    return calls


def _check_signature(name, args):
    """The arguments fit the entry point's ctypes signature (its stream is
    added by `_build.launch`)."""
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is _build._I32 and len(args) + 1 == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is _build._PTR:
            assert isinstance(a, _build._PTR)
        elif t is _build._F32:
            assert isinstance(a, float) and np.float32(a) == a
        else:
            lo, hi = (0, 2**32) if t is _build._U32 else (-2**31, 2**31)
            assert isinstance(a, int) and lo <= a < hi


def _counts():
    """The launches counted so far of each of KERNELS."""
    return [timing.counters()[f"launches.{name}_launch"] for name in KERNELS]


def _values(ptrs):
    return [p.value for p in ptrs]


def test_cpu_requests_never_touch_the_kernel_library(room, scenes, monkeypatch):
    """The term on the CPU, forward and backward, runs the plain versions
    and counts no launch."""
    for name in ("build", "load", "launch"):
        monkeypatch.setattr(_build, name, _must_not_run(f"_build.{name}"))
    before = _counts()
    rho = torch.full((room.triangle_count,), 0.5, requires_grad=True)
    e = P.bounce_irradiance(scenes[1], LAMP, room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, _words(KEY),
                            n_samples=2, n_sources=8, n_bounces=2, source_chunk=3)
    torch.autograd.grad(e.sum(), rho)
    assert _counts() == before


def test_cuda_requests_reach_the_kernel_wrappers(monkeypatch):
    """Each wrapper sends a CUDA request to its kernel wrapper with its
    arguments as given, never to the plain version."""
    calls = []
    for name in KERNELS:
        monkeypatch.setattr(bounce, f"_{name}_kernel", lambda *a, _n=name: calls.append((_n, a)) or _n)
        monkeypatch.setattr(bounce, f"{name}_reference", _must_not_run(f"{name}_reference"))
    card = types.SimpleNamespace(device=torch.device("cuda:0"))
    assert bounce.source_sample(1, 2, card, 4) == "source_sample"
    assert bounce.transfer_rays(1, 2, 3, (card, 5)) == "transfer_rays"
    assert bounce.transfer_reduce(1, 2, card, 4, 5, 6, 7) == "transfer_reduce"
    assert bounce.transfer_grad(card, 2, 3, 4, 5, 6) == "transfer_grad"
    assert bounce.transfer_reduce(None, None, None, 4, 5, 6, 7, card) == "transfer_reduce"
    assert calls == [("source_sample", (1, 2, card, 4)), ("transfer_rays", (1, 2, 3, (card, 5))),
                     ("transfer_reduce", (1, 2, card, 4, 5, 6, 7, None)), ("transfer_grad", (card, 2, 3, 4, 5, 6)),
                     ("transfer_reduce", (None, None, None, 4, 5, 6, 7, card))]


def test_source_sample_kernel_reaches_its_entry_point(room, scenes, field, on_card):
    ps = scenes[1]
    keys = field[0]
    cdf = est._source_cdf(ps, room.areas)[0]
    before = _counts()
    src, x, n = bounce._source_sample_kernel((keys[0], keys[1]), 64, cdf, _tri(ps))
    assert _counts() == [before[0] + 1, *before[1:]]
    [(name, device, args)] = on_card
    assert name == "source_sample_launch" and device == cdf.device
    _check_signature(name, args)
    assert args[:6] == (*(int(w) for w in keys[0]), *(int(w) for w in keys[1]), 64, room.triangle_count)
    assert _values(args[6:]) == [v.data_ptr() for v in (cdf, *_tri(ps), src, x, n)]
    assert [(v.dtype, tuple(v.shape)) for v in (src, x, n)] == [(torch.int64, (64,)), (torch.float32, (64, 3)),
                                                                (torch.float32, (64, 3))]
    with pytest.raises(ValueError, match="cdf"):
        bounce._source_sample_kernel((keys[0], keys[1]), 64, cdf[1:], _tri(ps))


def test_transfer_rays_kernel_reaches_its_entry_point(scenes, field, on_card):
    ps = scenes[1]
    keys, _, x_m, n_m = field
    pts, nrm = _plan_points(ps)
    src = (x_m[:4].contiguous(), n_m[:4].contiguous())
    before = _counts()
    out = bounce._transfer_rays_kernel(keys[3], 3, _tri(ps), src)
    out_p = bounce._transfer_rays_kernel(None, 1, (pts, nrm), src)
    assert _counts() == [before[0], before[1] + 2, *before[2:]]
    (name, _, args), (_, _, pargs) = on_card
    assert name == "transfer_rays_launch"
    for a in (args, pargs):
        _check_signature(name, a)
    t = ps.v0.shape[0]
    assert args[:6] == (int(keys[3][0]), int(keys[3][1]), 0, 4, 3 * t, t)
    assert pargs[:6] == (0, 0, 1, 4, pts.shape[0], pts.shape[0])
    assert _values(args[6:]) == [v.data_ptr() for v in (*src, *_tri(ps), *out)]
    assert _values(pargs[6:12]) == [src[0].data_ptr(), src[1].data_ptr(), pts.data_ptr(), None, None,
                                    nrm.data_ptr()]
    assert [(v.dtype, tuple(v.shape)) for v in out] == [
        (torch.float32, (12 * t, 3)), (torch.float32, (12 * t,)), (torch.float32, (12 * t,)), (torch.int32, (12 * t,))]
    assert out_p[0].shape == (4 * pts.shape[0], 3)
    with pytest.raises(ValueError, match="sources\\[1\\]"):
        bounce._transfer_rays_kernel(keys[3], 3, _tri(ps), (src[0], src[1][:3]))
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        bounce._transfer_rays_kernel(keys[3], 1 << 24, _tri(ps), src)


def _reduce_inputs(b, p):
    g = np.random.default_rng(7)
    r = b * p
    return (torch.from_numpy(g.uniform(0, 3, r + 500).astype(np.float32)),
            torch.from_numpy(g.permutation(r).astype(np.int32)),
            torch.from_numpy(g.uniform(0, 3, r).astype(np.float32)), torch.from_numpy(g.random(r).astype(np.float32)))


def test_transfer_reduce_kernel_reaches_its_entry_point(on_card):
    t, inverse, dist, f = _reduce_inputs(4, 300)
    s, acc = torch.ones(4), torch.zeros(300)
    before = _counts()
    out, vis = bounce._transfer_reduce_kernel(t, inverse, dist, f, 4, s, acc)
    m_t, m_inv, m_dist, m_f = _reduce_inputs(20, 20)
    mat = bounce._transfer_reduce_kernel(m_t, m_inv, m_dist, m_f, 20, None, None)
    assert _counts() == [*before[:2], before[2] + 2, before[3]]
    (name, _, args), (_, _, margs) = on_card
    assert name == "transfer_reduce_launch"
    for a in (args, margs):
        _check_signature(name, a)
    eps = (float(np.float32(1.0 - 1e-3)), float(np.float32(1e-3)))
    assert args[:4] == (4, 300, *eps) and margs[:4] == (20, 20, *eps)
    assert out is acc and vis.shape == (1200,) and vis.dtype == torch.uint8 and mat.shape == (20, 20)
    assert _values(args[4:]) == [v.data_ptr() for v in (t, inverse, dist, f, s, acc, acc, vis)]
    assert _values(margs[8:]) == [None, None, mat.data_ptr(), None]
    with pytest.raises(ValueError, match="inverse"):
        bounce._transfer_reduce_kernel(t, inverse.long(), dist, f, 4, s, None)
    with pytest.raises(ValueError, match="strength"):
        bounce._transfer_reduce_kernel(t, inverse, dist, f, 4, s[:3], None)
    with pytest.raises(ValueError, match="matrix mode"):
        bounce._transfer_reduce_kernel(t, inverse, dist, f, 4, None, None)
    with pytest.raises(ValueError, match="sources of whole receivers"):
        bounce._transfer_reduce_kernel(t, inverse, dist, f, 7, s, None)


def test_transfer_reduce_kernel_kept_mode_reaches_its_entry_point(on_card):
    """Kept-visibility mode: t, inverse and dist go as null pointers, the
    kept bytes as vis (read, not written), the sum into acc in place."""
    _, _, _, f = _reduce_inputs(4, 300)
    s, acc, vis = torch.ones(4), torch.zeros(300), (torch.rand(1200) > 0.4).to(torch.uint8)
    before = _counts()
    out, same = bounce._transfer_reduce_kernel(None, None, None, f, 4, s, acc, vis)
    assert _counts() == [*before[:2], before[2] + 1, before[3]]
    [(name, _, args)] = on_card
    assert name == "transfer_reduce_launch"
    _check_signature(name, args)
    assert args[:2] == (4, 300) and out is acc and same is vis
    assert _values(args[4:]) == [None, None, None, f.data_ptr(), s.data_ptr(), acc.data_ptr(), acc.data_ptr(),
                                 vis.data_ptr()]
    with pytest.raises(ValueError, match="vis"):
        bounce._transfer_reduce_kernel(None, None, None, f, 4, s, acc, vis[1:])
    with pytest.raises(ValueError, match="reduce mode only"):
        bounce._transfer_reduce_kernel(None, None, None, f, 4, None, None, vis)


def test_transfer_grad_kernel_reaches_its_entry_point(scenes, field, on_card):
    ps = scenes[1]
    keys, _, x_m, n_m = field
    src = (x_m[:4].contiguous(), n_m[:4].contiguous())
    p = 2 * ps.v0.shape[0]
    grad, vis = torch.linspace(-1, 1, p), (torch.rand(4 * p) > 0.3).to(torch.uint8)
    before = _counts()
    out = bounce._transfer_grad_kernel(grad, vis, keys[3], 2, _tri(ps), src)
    assert _counts() == [*before[:3], before[3] + 1]
    [(name, _, args)] = on_card
    assert name == "transfer_grad_launch"
    _check_signature(name, args)
    assert args[:6] == (int(keys[3][0]), int(keys[3][1]), 0, 4, p, ps.v0.shape[0])
    partials = args[14].tensor
    assert partials.shape == (-(-p // 256), 4) and out.shape == (4,)
    assert _values(args[6:14]) == [v.data_ptr() for v in (*src, *_tri(ps), grad, vis)]
    assert args[15].value == out.data_ptr()
    with pytest.raises(ValueError, match="vis"):
        bounce._transfer_grad_kernel(grad, vis.bool(), keys[3], 2, _tri(ps), src)
    with pytest.raises(ValueError, match="grad"):
        bounce._transfer_grad_kernel(grad[1:], vis, keys[3], 2, _tri(ps), src)


def _emulate(name, device, *args):
    """An entry point of csrc/bounce_ops.cu run by its plain version on the
    tensors its pointers name (a stand-in for the card)."""
    p = lambda a: a.tensor  # noqa: E731
    if name == "source_sample_launch":
        c0, c1, p0, p1, m = args[:5]
        outs = PLAIN["source_sample"](((c0, c1), (p0, p1)), m, p(args[6]), tuple(p(a) for a in args[7:11]))
        dests = args[11:]
    elif name in ("transfer_rays_launch", "transfer_grad_launch"):
        k0, k1, points, b_count, p_count, t_count, sx, sn, a, b, c, nrm = args[:12]
        targets = (p(a), p(nrm)) if points else (p(a), p(b), p(c), p(nrm))
        n_s = 1 if points else p_count // t_count
        if name == "transfer_rays_launch":
            outs = PLAIN["transfer_rays"]((k0, k1), n_s, targets, (p(sx), p(sn)))
            dests = args[12:]
        else:
            outs = [PLAIN_TERMS(p(args[12]), p(args[13]), (k0, k1), n_s, targets, (p(sx), p(sn))).sum(1)]
            dests = args[15:]
    else:
        assert name == "transfer_reduce_launch"
        b_count, p_count, scale, offset, t, inverse, dist, f, strength, acc = args[:10]
        assert (scale, offset) == (float(np.float32(1.0 - 1e-3)), float(np.float32(1e-3)))
        kept = None if p(t) is not None else p(args[11])  # kept-visibility mode reads the bytes
        outs = PLAIN["transfer_reduce"](p(t), p(inverse), p(dist), p(f), b_count, p(strength), p(acc), kept)
        outs, dests = ([outs], args[10:11]) if p(strength) is None else (outs, args[10:])
    with torch.no_grad():
        for dest, out in zip(dests, outs):
            p(dest).copy_(out.reshape(p(dest).shape))


@pytest.mark.parametrize("case", ["bounce_irradiance", "dose_image", "planned_route"])
def test_the_term_on_cuda_runs_only_the_kernels(room, scenes, monkeypatch, case):
    """The term's CUDA route, forward and backward, through the four entry
    points (emulated by their plain versions) and no plain body: the plain
    route's values and gradients bit for bit, K11 once, K12 and K13 a chunk
    and once for the matrix, K14 a chunk; no fallback. With a route's
    transfer plan (built on the plain path) a waypoint runs K12 and K13 in
    kept-visibility mode a chunk and K14 a chunk, and equals the unplanned
    plain route (20 sources in the route's chunks of 16, the last padded)."""
    ps = scenes[1]
    base = room.floor_height + 0.8
    plan = P.plan_dose_image(ps, res=12)
    sizes = dict(n_samples=2, n_sources=8, n_bounces=2)
    route_sizes = dict(sizes, n_sources=20)
    route_plan = P.plan_route_transfer(ps, _words(KEY), 1, room.areas, **route_sizes)

    def run(transfer=None):
        xz = torch.tensor(LAMP, requires_grad=True)
        rho = torch.full((room.triangle_count,), 0.5, requires_grad=True)
        if case == "bounce_irradiance":
            e = P.bounce_irradiance(ps, xz, base, 1.0, 450.0, rho, room.areas, _words(KEY), source_chunk=3, **sizes)
        elif case == "dose_image":
            e = P.dose_image(ps, plan, xz[None], [30.0], base, 1.0, 450.0, _words(KEY), reflectance=rho,
                             areas=room.areas, source_chunk=3, **sizes)
        else:
            e = P.route_dose(ps, xz[None], [30.0], base, 1.0, 450.0, _words(KEY), reflectance=rho, areas=room.areas,
                             transfer=transfer, **route_sizes)
        return (e.detach(), *torch.autograd.grad((e * torch.linspace(-1, 1, e.numel()).view(e.shape)).sum(),
                                                 (xz, rho)))

    want = run()
    for name in KERNELS:  # the CPU tensors take the kernel route
        kernel = getattr(bounce, f"_{name}_kernel")
        monkeypatch.setattr(bounce, name, kernel)
        monkeypatch.setattr(bounce, f"{name}_reference", _must_not_run(f"{name}_reference"))
    monkeypatch.setattr(est, "source_sample", bounce.source_sample)
    monkeypatch.setattr(bounce, "transfer_grad_terms", _must_not_run("transfer_grad_terms"))
    monkeypatch.setattr(_build, "ptr", _ptr)
    seen = []
    monkeypatch.setattr(_build, "call",
                        lambda name, device, *args: seen.append(name) or _emulate(name, device, *args))
    before = _counts()
    if case == "planned_route":
        got = run(route_plan)
        assert seen == [*["transfer_rays_launch", "transfer_reduce_launch"] * 2, *["transfer_grad_launch"] * 2]
        assert [a - b for a, b in zip(_counts(), before)] == [0, 2, 2, 2]
    else:
        got = run()
        assert seen == ["source_sample_launch", *["transfer_rays_launch", "transfer_reduce_launch"] * 4,
                        *["transfer_grad_launch"] * 3]
        assert [a - b for a, b in zip(_counts(), before)] == [1, 4, 4, 3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_failing_launch_raises(room, scenes, field, on_card, monkeypatch, kernel):
    """No fallback: a launch the card refuses raises, the plain version is
    not run in its place, and nothing is counted."""
    ps = scenes[1]
    keys, _, x_m, n_m = field
    src = (x_m[:4].contiguous(), n_m[:4].contiguous())
    t, inverse, dist, f = _reduce_inputs(4, 300)

    monkeypatch.setattr(_build, "call", lambda name, device, *args: 700)  # the card's error
    call = {
        "source_sample": lambda: bounce._source_sample_kernel((keys[0], keys[1]), 8,
                                                              est._source_cdf(ps, room.areas)[0], _tri(ps)),
        "transfer_rays": lambda: bounce._transfer_rays_kernel(keys[3], 2, _tri(ps), src),
        "transfer_reduce": lambda: bounce._transfer_reduce_kernel(t, inverse, dist, f, 4, torch.ones(4), None),
        "transfer_grad": lambda: bounce._transfer_grad_kernel(torch.ones(300), torch.ones(1200, dtype=torch.uint8),
                                                              None, 1, (torch.zeros(300, 3), torch.zeros(300, 3)), src),
    }[kernel]
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert _counts() == before


def test_other_devices_are_refused(on_card):
    meta = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bounce.source_sample((KEY, KEY), 4, meta[:, 0], (meta,) * 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bounce.transfer_rays(None, 1, (meta, meta), (meta, meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        bounce.transfer_reduce(meta, meta, meta[:, 0], meta, 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        bounce.transfer_grad(meta[:, 0], meta, None, 1, (meta, meta), (meta, meta))
    assert on_card == []
