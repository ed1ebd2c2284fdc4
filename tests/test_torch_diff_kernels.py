"""The direct estimator's kernels (csrc/diff_ops.cu: K8 `shadow_sample`, K7
`pack_sorted`, K9 `visibility_reduce`, K10 `direct_grad`) and the
`DirectIrradiance` Function around them (uvtrace_torch/diff/direct.py), on
the CPU.

The Function's plain forward and backward go against JAX's `irradiance` and
`_points_direct` and their `jax.grad` (lamp x and z, rod base, rod length and
power) on the box room of tests/test_torch_diff.py, at its tolerances (rtol
2e-3 against JAX's clustered shadow rays; the keys and uniforms are
bit-equal, the f32 sums taken in other orders). The closed-form backward goes
against torch autograd of the plain forward on the same rays: rtol 1e-5, and
an absolute term of 1e-6 times the sum of the absolute values of the terms it
adds (a gradient that cancels to near 0 keeps only the f32 order of its sums).
The key derivation the kernels run on the device (threefry.cuh's
`split_key`) is replayed in torch int64 (`rng.split_words`) against
`rng.split`.

There is no card here, so a CUDA request is followed as far as the C entry
point, as in tests/test_torch_sampler_dispatch.py: `_build.launch` is
replaced by a recorder (or by an emulator that runs each entry point's plain
version on the tensors its pointers name), the plain bodies raise if they are
reached, and the arguments are checked against `_build.SIGNATURES`. The
kernels' bit equality to these plain versions is tests/test_torch_cuda.py's,
on the card.
"""

import ctypes
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace import diff as J
from uvtrace.diff.estimator import _points_direct as jax_points_direct
from uvtrace.geometry.procedural import make_box_room
from uvtrace_torch import _build
from uvtrace_torch import diff as P
from uvtrace_torch.diff import direct
from uvtrace_torch.diff import estimator as est
from uvtrace_torch.ops import rng

RTOL, ATOL = 2e-3, 1e-6
LAMP = np.array([0.3, -0.4], np.float32)
KEY = rng.fold_in(rng.PRNGKey(5), 3)
KERNELS = ("shadow_sample", "pack_sorted", "visibility_reduce", "direct_grad")


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)


@pytest.fixture(scope="module")
def scenes(room):
    return J.make_diff_scene(room), P.make_diff_scene(room, device="cpu")


@pytest.fixture(scope="module")
def points(scenes):
    """Surface points with their normals: the lit pixels of a 16 x 16 plan."""
    plan = P.plan_dose_image(scenes[1], res=16)
    return plan.points[plan.mask].contiguous(), plan.normals[plan.mask].contiguous()


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _targets(scene, mode, points):
    return (scene.v0, scene.e1, scene.e2, scene.normal) if mode == "triangles" else points


# ------------------------------------------------------ the plain versions vs JAX and autograd


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_function_matches_jax(room, scenes, points, mode):
    """Values and the gradients with respect to lamp x, z, rod base, rod
    length and power through the Function against JAX's estimator."""
    js, ps = scenes
    key = jax.random.PRNGKey(5)
    base = np.float32(room.floor_height + 0.8)
    args = (LAMP, base, np.float32(1.2), np.float32(450.0))

    if mode == "triangles":
        def jf(xz, b, ln, pw):
            return J.irradiance(js, xz, b, ln, pw, key, n_samples=4)

        def pf(xz, b, ln, pw):
            return P.irradiance(ps, xz, b, ln, pw, _words(key), n_samples=4)
    else:
        pts, nrm = (x.numpy() for x in points)

        def jf(xz, b, ln, pw):
            return jax_points_direct(js, jnp.asarray(pts), jnp.asarray(nrm), xz, b, ln, pw, key, n_rod=8)

        def pf(xz, b, ln, pw):
            return est._points_direct(ps, points[0], points[1], xz, b, ln, pw, _words(key), n_rod=8)

    ej = np.asarray(jf(*(jnp.asarray(a) for a in args)))
    gj = jax.grad(lambda *a: jnp.sum(jf(*a)), argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ep = pf(*ts)
    gp = torch.autograd.grad(ep.sum(), ts)
    np.testing.assert_allclose(ep.detach().numpy(), ej, rtol=RTOL, atol=ATOL)
    for g_p, g_j in zip(gp, gj):
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)
    assert (ep > 0).float().mean() > 0.5 and all(bool((g != 0).any()) for g in gp)


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_plain_backward_is_autograd_of_the_plain_forward(scenes, points, mode):
    """direct_grad_reference (the closed form) against torch autograd of
    the plain forward (K8's, the trace and K9's plain versions) for a loss
    sum(w E) with random weights w."""
    ps = scenes[1]
    targets = _targets(ps, mode, points)
    n_s = 4 if mode == "triangles" else 8
    g = np.random.default_rng(1)
    theta = [torch.tensor(v, requires_grad=True) for v in (LAMP, np.float32(-0.2), np.float32(1.2),
                                                           np.float32(450.0))]
    rod, dirs, dist, gt, sort_key = direct.shadow_sample_reference(KEY, n_s, targets, *theta[:3])
    t, inverse = ps.trace_fn(ps.trav_scene, rod.detach(), dirs.detach(), sort_key)
    e, vis = direct.visibility_reduce_reference(t, inverse, dist, gt, n_s, theta[3])
    w = torch.from_numpy(g.normal(size=e.shape[0]).astype(np.float32))
    auto = torch.cat([x.reshape(-1) for x in torch.autograd.grad((e * w).sum(), theta)]).numpy()
    args = (w, vis, KEY, n_s, targets, theta[0].detach(), *(x.item() for x in theta[1:]))
    closed = direct.direct_grad_reference(*args).numpy()
    scale = direct.direct_grad_terms(*args).abs().sum((1, 2)).numpy()
    assert closed.shape == (direct.N_GRAD,) and 0.05 < float(vis.float().mean()) < 1.0
    np.testing.assert_allclose(closed, auto, rtol=1e-5, atol=0)
    np.testing.assert_array_less(np.abs(closed - auto), 1e-5 * np.abs(auto) + 1e-6 * scale + 1e-30)


def test_the_function_is_the_plain_pipeline(scenes):
    """Forward: the Function's E is K8, the trace and K9 (plain) op for op;
    backward: its gradients are K10's plain version given dL/dE."""
    ps = scenes[1]
    targets = _targets(ps, "triangles", None)
    xz = torch.tensor(LAMP, requires_grad=True)
    e = P.irradiance(ps, xz, -0.2, 1.2, 450.0, KEY, n_samples=4)
    rod, dirs, dist, gt, sort_key = direct.shadow_sample_reference(KEY, 4, targets, xz.detach(), -0.2, 1.2)
    t, inverse = ps.trace_fn(ps.trav_scene, rod, dirs, sort_key)
    e_ref, vis = direct.visibility_reduce_reference(t, inverse, dist, gt, 4, 450.0)
    assert torch.equal(e.detach(), e_ref)
    w = torch.linspace(-1.0, 1.0, e.shape[0])
    (g,) = torch.autograd.grad((e * w).sum(), xz)
    assert torch.equal(g, direct.direct_grad_reference(w, vis, KEY, 4, targets, xz.detach(), -0.2, 1.2, 450.0)[:2])


def test_device_key_derivation_is_rng_split():
    """The kernels' keys (threefry.cuh's split_key: threefry2x32 of the
    counter (0, i), both words), replayed in torch int64, are rng.split's:
    split(kw, 3)[0] and [1], and the u and v keys split from [0]."""
    for kw in (KEY, rng.PRNGKey(0), rng.fold_in(rng.PRNGKey(2**32 - 1), 2**31 + 5)):
        words = rng.split_words(kw, 3, "cpu").numpy().astype(np.uint32)
        np.testing.assert_array_equal(words, rng.split(kw, 3))
        np.testing.assert_array_equal(rng.split_words(words[0], 2, "cpu").numpy().astype(np.uint32),
                                      rng.split(rng.split(kw, 3)[0]))


def test_pack_sorted_reference_packs_and_inverts():
    """K7's plain version: the sorted rays with shared origins, parked
    padding to whole packets, and the inverse permutation; in input order
    with no permutation."""
    g = np.random.default_rng(0)
    rod = torch.from_numpy(g.normal(size=(3, 3)).astype(np.float32))
    dirs = torch.from_numpy(g.normal(size=(3 * 700, 3)).astype(np.float32))
    perm = torch.from_numpy(g.permutation(2100))
    o, d, inv = direct.pack_sorted_reference(perm, rod, dirs)
    assert o.shape == d.shape == (3072, 3) and inv.dtype == torch.int32
    assert torch.equal(d[:2100], dirs[perm]) and torch.equal(o[:2100], rod[perm // 700])
    assert torch.equal(inv[perm], torch.arange(2100, dtype=torch.int32))
    assert (o[2100:] == direct.PARK).all() and torch.equal(d[2100:], torch.tensor([0.0, 1.0, 0.0]).expand(972, 3))
    o, d, inv = direct.pack_sorted_reference(None, rod, dirs, 1)
    assert torch.equal(d, dirs) and torch.equal(o, rod.repeat_interleave(700, 0))
    assert torch.equal(inv, torch.arange(2100, dtype=torch.int32))
    with pytest.raises(ValueError, match="origins"):
        direct.pack_sorted_reference(None, rod, dirs[:2099])


def test_geometry_gradients_are_refused(room, scenes, points):
    """The Function gives no gradient with respect to the scene's geometry,
    the points or the normals: asking for one raises instead of returning
    None. Without a graph (no_grad) the same inputs run."""
    ps = scenes[1]
    base = room.floor_height + 0.8
    moved = ps._replace(v0=ps.v0.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="geometry"):
        P.irradiance(moved, LAMP, base, 1.0, 450.0, KEY, n_samples=2)
    pts = points[0].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="geometry"):
        est._points_direct(ps, pts, points[1], LAMP, base, 1.0, 450.0, KEY, n_rod=4)
    with pytest.raises(ValueError, match="geometry"):
        est._points_direct(ps, points[0], points[1].clone().requires_grad_(True), LAMP, base, 1.0, 450.0, KEY,
                           n_rod=4)
    with torch.no_grad():
        assert torch.equal(P.irradiance(moved, LAMP, base, 1.0, 450.0, KEY, n_samples=2),
                           P.irradiance(ps, LAMP, base, 1.0, 450.0, KEY, n_samples=2))
        est._points_direct(ps, pts, points[1], LAMP, base, 1.0, 450.0, KEY, n_rod=4)


# ------------------------------------------------------ the dispatch


def _must_not_run(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} ran")
    return fail


PLAIN = {name: getattr(direct, f"{name}_reference") for name in KERNELS}
PLAIN_TERMS = direct.direct_grad_terms


class _Ptr(ctypes.c_void_p):
    """A device address that remembers its tensor (the emulator reads it)."""


def _ptr(x):
    p = _Ptr(0 if x is None else x.data_ptr())
    p.tensor = x
    return p


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library cannot be built, loaded or launched."""
    for name in ("build", "load", "launch"):
        monkeypatch.setattr(_build, name, _must_not_run(f"_build.{name}"))


@pytest.fixture
def on_card(monkeypatch):
    """The kernels' wrappers as far as the C entry point, on CPU tensors:
    the plain bodies refused, every `_build.launch` call recorded."""
    for name in KERNELS:
        monkeypatch.setattr(direct, f"{name}_reference", _must_not_run(f"{name}_reference"))
    monkeypatch.setattr(direct, "direct_grad_terms", _must_not_run("direct_grad_terms"))
    monkeypatch.setattr(_build, "ptr", _ptr)
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, device, *args: calls.append((name, device, args)))
    return calls


def _check_signature(name, args):
    """The arguments fit the entry point's ctypes signature (its stream is
    added by `_build.launch`)."""
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is _build._I32
    assert len(args) + 1 == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is _build._PTR:
            assert isinstance(a, _build._PTR)
        elif t is _build._F32:
            assert isinstance(a, float) and np.float32(a) == a
        else:
            lo, hi = (0, 2**32) if t is _build._U32 else (-2**31, 2**31)
            assert isinstance(a, int) and lo <= a < hi


def _counts():
    return [getattr(direct, name).launches for name in KERNELS]


def _small(scene, n_s=3):
    """Inputs of every kernel on the CPU, at the box room's 202 triangles."""
    targets = _targets(scene, "triangles", None)
    xz = torch.tensor(LAMP)
    rod, dirs, dist, g, key = PLAIN["shadow_sample"](KEY, n_s, targets, xz, -0.2, 1.2)
    perm = torch.sort(key, stable=True).indices
    t = torch.rand(dirs.shape[0] + 1000)
    inverse = PLAIN["pack_sorted"](perm, rod, dirs, 1024)[2]
    vis = (torch.rand(dirs.shape[0]) > 0.3).to(torch.uint8)
    return dict(targets=targets, xz=xz, rod=rod, dirs=dirs, dist=dist, g=g, perm=perm, t=t, inverse=inverse,
                vis=vis, grad=torch.linspace(-1, 1, targets[0].shape[0]), n_s=n_s)


def test_cpu_requests_never_touch_the_kernel_library(room, scenes, no_library):
    """The estimator on the CPU, forward and backward, runs the plain
    versions and counts no launch."""
    before = _counts()
    xz = torch.tensor(LAMP, requires_grad=True)
    e = P.irradiance(scenes[1], xz, room.floor_height + 0.8, 1.0, 450.0, KEY, n_samples=2)
    torch.autograd.grad(e.sum(), xz)
    assert _counts() == before


def test_cuda_requests_reach_the_kernel_wrappers(monkeypatch):
    """Each wrapper sends a CUDA request to its kernel wrapper with its
    arguments as given, never to the plain version."""
    calls = []
    for name in KERNELS:
        monkeypatch.setattr(direct, f"_{name}_kernel", lambda *a, _n=name: calls.append((_n, a)) or _n)
        monkeypatch.setattr(direct, f"{name}_reference", _must_not_run(f"{name}_reference"))
    card = types.SimpleNamespace(device=torch.device("cuda:0"))
    assert direct.shadow_sample(KEY, 4, (card, 2, 3, 4), 5, 6.0, 7.0) == "shadow_sample"
    assert direct.pack_sorted(1, 2, card, 1024) == "pack_sorted"
    assert direct.visibility_reduce(1, 2, card, 4, 5, 6.0) == "visibility_reduce"
    assert direct.direct_grad(card, 2, KEY, 4, 5, 6, 7.0, 8.0, 9.0) == "direct_grad"
    assert calls == [("shadow_sample", (KEY, 4, (card, 2, 3, 4), 5, 6.0, 7.0)), ("pack_sorted", (1, 2, card, 1024)),
                     ("visibility_reduce", (1, 2, card, 4, 5, 6.0)),
                     ("direct_grad", (card, 2, KEY, 4, 5, 6, 7.0, 8.0, 9.0))]


def test_shadow_sample_kernel_reaches_its_entry_point(scenes, points, on_card):
    x = _small(scenes[1])
    before = _counts()
    rod, dirs, dist, g, key = direct._shadow_sample_kernel(KEY, 3, x["targets"], x["xz"], -0.2, 1.2)
    pts, nrm = points
    direct._shadow_sample_kernel(KEY, 8, points, x["xz"], -0.2, 1.2)
    assert _counts() == [before[0] + 2, *before[1:]]
    (name, device, args), (_, _, pargs) = on_card
    assert name == "shadow_sample_launch" and device == x["xz"].device
    for a in (args, pargs):
        _check_signature(name, a)
    t = x["targets"][0].shape[0]
    assert args[:5] == (int(KEY[0]), int(KEY[1]), 0, 3, t) and pargs[:5] == (int(KEY[0]), int(KEY[1]), 1, 8,
                                                                            pts.shape[0])
    assert args[6:8] == (float(np.float32(-0.2)), float(np.float32(1.2)))
    assert [p.value for p in args[8:12]] == [v.data_ptr() for v in x["targets"]]
    assert [p.value for p in pargs[8:12]] == [pts.data_ptr(), None, None, nrm.data_ptr()]
    assert [p.value for p in (args[5], *args[12:])] == [v.data_ptr() for v in (x["xz"], rod, dirs, dist, g, key)]
    assert [(v.dtype, tuple(v.shape)) for v in (rod, dirs, dist, g, key)] == [
        (torch.float32, (3, 3)), (torch.float32, (3 * t, 3)), (torch.float32, (3 * t,)), (torch.float32, (3 * t,)),
        (torch.int32, (3 * t,))]
    with pytest.raises(ValueError, match="targets\\[1\\]"):
        direct._shadow_sample_kernel(KEY, 3, (x["targets"][0], x["targets"][1][:5]), x["xz"], 0.0, 1.0)
    with pytest.raises(ValueError, match="lamp_xz"):
        direct._shadow_sample_kernel(KEY, 3, x["targets"], x["xz"].double(), 0.0, 1.0)
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        direct._shadow_sample_kernel(KEY, 1 << 24, x["targets"], x["xz"], 0.0, 1.0)
    assert len(on_card) == 2


def test_pack_sorted_kernel_reaches_its_entry_point(scenes, on_card):
    x = _small(scenes[1])
    before = _counts()
    r = x["dirs"].shape[0]
    o, d, inv = direct._pack_sorted_kernel(x["perm"], x["rod"], x["dirs"], 2048)
    direct._pack_sorted_kernel(None, x["rod"], x["dirs"], 1)
    assert _counts() == [before[0], before[1] + 2, *before[2:]]
    (name, _, args), (_, _, args_in_order) = on_card
    assert name == "pack_sorted_launch"
    _check_signature(name, args)
    assert args[:3] == (r, 2048, r // 3) and args_in_order[:3] == (r, r, r // 3)
    assert [p.value for p in args[3:]] == [v.data_ptr() for v in (x["perm"], x["rod"], x["dirs"], o, d, inv)]
    assert args_in_order[3].value is None
    assert o.shape == d.shape == (2048, 3) and inv.shape == (r,) and inv.dtype == torch.int32
    with pytest.raises(ValueError, match="perm"):
        direct._pack_sorted_kernel(x["perm"].int(), x["rod"], x["dirs"], 1024)
    with pytest.raises(ValueError, match="origins"):
        direct._pack_sorted_kernel(None, x["rod"], x["dirs"][:-1], 1024)


def test_visibility_reduce_kernel_reaches_its_entry_point(scenes, on_card):
    x = _small(scenes[1])
    before = _counts()
    e, vis = direct._visibility_reduce_kernel(x["t"], x["inverse"], x["dist"], x["g"], 3, 450.0)
    assert _counts() == [*before[:2], before[2] + 1, before[3]]
    [(name, _, args)] = on_card
    assert name == "visibility_reduce_launch"
    _check_signature(name, args)
    m = x["dirs"].shape[0] // 3
    assert args[:5] == (3, m, float(np.float32(1.0 - 1e-3)), float(np.float32(1e-3)), 450.0)
    assert [p.value for p in args[5:]] == [v.data_ptr() for v in (x["t"], x["inverse"], x["dist"], x["g"], e, vis)]
    assert (e.shape, e.dtype, vis.shape, vis.dtype) == ((m,), torch.float32, (3 * m,), torch.uint8)
    with pytest.raises(ValueError, match="inverse"):
        direct._visibility_reduce_kernel(x["t"], x["inverse"].long(), x["dist"], x["g"], 3, 1.0)
    with pytest.raises(ValueError, match="samples"):
        direct._visibility_reduce_kernel(x["t"], x["inverse"], x["dist"], x["g"], 5, 1.0)


def test_direct_grad_kernel_reaches_its_entry_point(scenes, on_card):
    x = _small(scenes[1])
    before = _counts()
    out = direct._direct_grad_kernel(x["grad"], x["vis"], KEY, 3, x["targets"], x["xz"], -0.2, 1.2, 450.0)
    assert _counts() == [*before[:3], before[3] + 1]
    [(name, _, args)] = on_card
    assert name == "direct_grad_launch"
    _check_signature(name, args)
    m = x["targets"][0].shape[0]
    assert args[:5] == (int(KEY[0]), int(KEY[1]), 0, 3, m)
    assert args[6:9] == (float(np.float32(-0.2)), float(np.float32(1.2)), 450.0)
    partials = args[15].tensor
    assert partials.shape == (-(-m // 256), direct.N_GRAD) and out.shape == (direct.N_GRAD,)
    assert [p.value for p in (args[5], *args[9:15], args[16])] == [
        v.data_ptr() for v in (x["xz"], *x["targets"], x["grad"], x["vis"], out)]
    with pytest.raises(ValueError, match="vis"):
        direct._direct_grad_kernel(x["grad"], x["vis"].bool(), KEY, 3, x["targets"], x["xz"], 0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="grad"):
        direct._direct_grad_kernel(x["grad"][1:], x["vis"], KEY, 3, x["targets"], x["xz"], 0.0, 1.0, 1.0)


def _emulate(name, device, *args):
    """An entry point of csrc/diff_ops.cu run by its plain version on the
    tensors its pointers name (a stand-in for the card)."""
    f, p = (lambda a: float(a)), (lambda a: a.tensor)
    if name == "shadow_sample_launch":
        k0, k1, points, n_s, m, xz, base, length, a, b, c, nrm = args[:12]
        targets = (p(a), p(nrm)) if points else (p(a), p(b), p(c), p(nrm))
        outs = PLAIN["shadow_sample"]((k0, k1), n_s, targets, p(xz), f(base), f(length))
        dests = args[12:]
    elif name == "pack_sorted_launch":
        r, n_out, group, perm, orig, dirs = args[:6]
        assert group * p(orig).shape[0] == r
        outs = PLAIN["pack_sorted"](p(perm), p(orig), p(dirs), n_out if n_out > r else 1)
        dests = args[6:]
    elif name == "visibility_reduce_launch":
        n_s, m, scale, offset, power, t, inverse, dist, g = args[:9]
        assert (scale, offset) == (float(np.float32(1.0 - direct.EPS)), float(np.float32(direct.EPS)))
        outs = PLAIN["visibility_reduce"](p(t), p(inverse), p(dist), p(g), n_s, f(power))
        dests = args[9:]
    else:
        assert name == "direct_grad_launch"
        k0, k1, points, n_s, m, xz, base, length, power, a, b, c, nrm, grad, vis = args[:15]
        targets = (p(a), p(nrm)) if points else (p(a), p(b), p(c), p(nrm))
        outs = [PLAIN_TERMS(p(grad), p(vis), (k0, k1), n_s, targets, p(xz), f(base), f(length), f(power)).sum((1, 2))]
        dests = args[16:]
    with torch.no_grad():
        for dest, out in zip(dests, outs):
            p(dest).copy_(out.reshape(p(dest).shape))


@pytest.mark.parametrize("mode", ["triangles", "points"])
def test_the_estimator_on_cuda_runs_only_the_kernels(scenes, points, monkeypatch, mode):
    """The Function's CUDA route, forward and backward, through the four
    entry points (emulated by their plain versions) and no plain body: the
    plain route's E and gradients, one launch of each kernel, no fallback."""
    ps = scenes[1]
    base = -0.2

    def run():
        xz = torch.tensor(LAMP, requires_grad=True)
        pw = torch.tensor(450.0, requires_grad=True)
        if mode == "triangles":
            e = P.irradiance(ps, xz, base, 1.2, pw, KEY, n_samples=4)
        else:
            e = est._points_direct(ps, points[0], points[1], xz, base, 1.2, pw, KEY, n_rod=8)
        return (e.detach(), *torch.autograd.grad((e * torch.linspace(-1, 1, e.shape[0])).sum(), (xz, pw)))

    want = run()
    for name in KERNELS:  # the CPU tensors take the kernel route
        kernel = getattr(direct, f"_{name}_kernel")
        monkeypatch.setattr(direct, name, kernel)
        kernel.launches = 0
        monkeypatch.setattr(direct, f"{name}_reference", _must_not_run(f"{name}_reference"))
    monkeypatch.setattr(est, "pack_sorted", direct.pack_sorted)
    monkeypatch.setattr(direct, "direct_grad_terms", _must_not_run("direct_grad_terms"))
    monkeypatch.setattr(_build, "ptr", _ptr)
    seen = []
    monkeypatch.setattr(_build, "launch", lambda name, device, *args: seen.append(name) or _emulate(name, device,
                                                                                                     *args))
    got = run()
    assert seen == ["shadow_sample_launch", "pack_sorted_launch", "visibility_reduce_launch", "direct_grad_launch"]
    assert [getattr(direct, name).launches for name in KERNELS] == [1, 1, 1, 1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_failing_launch_raises(scenes, on_card, monkeypatch, kernel):
    """No fallback: a launch the card refuses raises, the plain version is
    not run in its place, and nothing is counted."""
    x = _small(scenes[1])

    def refuse(name, device, *args):
        raise RuntimeError(f"{name} failed with CUDA error 700")

    monkeypatch.setattr(_build, "launch", refuse)
    call = {
        "shadow_sample": lambda: direct._shadow_sample_kernel(KEY, 3, x["targets"], x["xz"], 0.0, 1.0),
        "pack_sorted": lambda: direct._pack_sorted_kernel(x["perm"], x["rod"], x["dirs"], 1024),
        "visibility_reduce": lambda: direct._visibility_reduce_kernel(x["t"], x["inverse"], x["dist"], x["g"], 3, 1.0),
        "direct_grad": lambda: direct._direct_grad_kernel(x["grad"], x["vis"], KEY, 3, x["targets"], x["xz"], 0.0,
                                                          1.0, 1.0),
    }[kernel]
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert _counts() == before


def test_other_devices_are_refused(on_card):
    meta = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        direct.shadow_sample(KEY, 2, (meta, meta), meta, 0.0, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        direct.pack_sorted(None, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        direct.visibility_reduce(meta, meta, meta, meta, 2, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        direct.direct_grad(meta, meta, KEY, 2, (meta, meta), meta, 0.0, 1.0, 1.0)
    assert on_card == []


# ------------------------------------------------------ config 4's waypoint 6


@pytest.mark.slow  # about 17 min on the CPU: 5 evaluations a package of 179,464 shadow rays on the test room
def test_waypoint_6_gradient_against_jax_and_fd():
    """mean(irradiance) at assets/lange_route.xml's waypoint 6 on
    testroomopt (n_samples 4, key fold_in(PRNGKey(0), 6)): JAX's autograd and
    central FD (eps 1e-3) beside the port's.

    The port equals JAX in value and autograd (rtol 2e-3: the same estimator
    on the same keys). Both part from their own FD by more than the FD
    check's rtol 0.08 in the same components: the estimator's own
    visibility flips at silhouettes between x - eps and x + eps, which the
    piecewise-constant contract ignores. The two packages' FD quotients
    differ by no more than the rays whose hit lies within rtol 1e-5 of the
    visibility threshold t = dist (1 - eps) - eps can move them: the port's
    f32 Plücker t and JAX's Möller–Trumbore t may round such a ray to either
    side (each moves the mean by P G / (S T))."""
    from uvtrace.geometry.gltf import load_glb
    from uvtrace.io.routexml import load_route_xml
    from uvtrace.sim import SimParams

    root = os.path.join(os.path.dirname(__file__), "..", "assets")
    mesh = load_glb(os.path.join(root, "testroomopt.glb"))
    route = load_route_xml(os.path.join(root, "lange_route.xml"))
    p = route.apply_to(SimParams())
    base, length, power = mesh.floor_height + p.light_height, p.light_length, p.light_intensity
    lo, hi = mesh.aabb
    xz0 = np.clip(np.array([route.waypoints[6].x, route.waypoints[6].y], np.float32),
                  np.float32([lo[0] + 0.1, lo[2] + 0.1]) + 1e-3, np.float32([hi[0] - 0.1, hi[2] - 0.1]) - 1e-3)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 6)
    js, ps = J.make_diff_scene(mesh), P.make_diff_scene(mesh, device="cpu")
    # JAX's budget-free clustered traversal one packet a scan step: its dense
    # [packet, clusters, triangles] planes stay near 0.3 GB each
    js = js._replace(extend_fn=functools.partial(js.extend_fn.func, **{**js.extend_fn.keywords, "group": 1}))
    targets, n_s, t_count = _targets(ps, "triangles", None), 4, mesh.triangle_count

    def jf(xz):
        return jnp.mean(J.irradiance(js, xz, base, length, power, key, n_samples=n_s))

    def port_side(xz):
        """The port's mean E at xz (the Function's forward, plain: K8, the
        trace, K9) and the most its threshold ties can move it."""
        rod, dirs, dist, g, sort_key = direct.shadow_sample_reference(_words(key), n_s, targets,
                                                                      torch.from_numpy(xz), base, length)
        t, inverse = ps.trace_fn(ps.trav_scene, rod, dirs, sort_key)
        e, _ = direct.visibility_reduce_reference(t, inverse, dist, g, n_s, power)
        thr = dist * np.float32(1.0 - direct.EPS) - np.float32(direct.EPS)
        ties = (t.index_select(0, inverse) - thr).abs() <= 1e-5 * thr.abs()
        return e.mean().item(), power * g[ties].sum().item() / (n_s * t_count), int(ties.sum())

    ej, gj = jax.value_and_grad(jf)(jnp.asarray(xz0))
    xt = torch.tensor(xz0, requires_grad=True)
    ep = P.irradiance(ps, xt, base, length, power, _words(key), n_samples=n_s).mean()
    (gp,) = torch.autograd.grad(ep, xt)
    fd_j, fd_p, slack, n_ties = [], [], [], 0
    for i in range(2):
        e = np.zeros(2, np.float32)
        e[i] = 1e-3
        fd_j.append((float(jf(jnp.asarray(xz0 + e))) - float(jf(jnp.asarray(xz0 - e)))) / 2e-3)
        (hi_m, hi_s, hi_n), (lo_m, lo_s, lo_n) = port_side(xz0 + e), port_side(xz0 - e)
        fd_p.append((hi_m - lo_m) / 2e-3)
        slack.append((hi_s + lo_s) / 2e-3)
        n_ties += hi_n + lo_n
    gp, gj, fd_p, fd_j = gp.numpy(), np.asarray(gj), np.array(fd_p), np.array(fd_j)
    print(f"waypoint 6 at {xz0.tolist()}: value port {ep.item():.7g} JAX {float(ej):.7g}; autograd port "
          f"{gp.tolist()} JAX {gj.tolist()}; FD port {fd_p.tolist()} JAX {fd_j.tolist()}; autograd vs FD port "
          f"{(np.abs(gp - fd_p) / np.abs(fd_p)).tolist()} JAX {(np.abs(gj - fd_j) / np.abs(fd_j)).tolist()}; "
          f"{n_ties} threshold ties, FD slack {slack}")
    np.testing.assert_allclose(ep.item(), float(ej), rtol=RTOL)
    np.testing.assert_allclose(gp, gj, rtol=RTOL, atol=1e-7)
    apart_p, apart_j = np.abs(gp - fd_p) > 0.08 * np.abs(fd_p), np.abs(gj - fd_j) > 0.08 * np.abs(fd_j)
    assert apart_p.tolist() == apart_j.tolist()
    np.testing.assert_array_less(np.abs(fd_p - fd_j), np.array(slack) + 1e-7)
