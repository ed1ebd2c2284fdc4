"""The port's differentiable estimator and route optimizer (uvtrace_torch.diff)
against uvtrace.diff on the CPU, and the port's own finite-difference checks.

The same box room (make_box_room(subdivisions=4, clutter=1, seed=11,
floor_y=-1.0), 202 triangles) and the same keys go through both packages.
JAX's CPU default traces shadow rays with its clustered Möller–Trumbore
backend, the port with B2's plain version (brute-force Plücker tests); the
uniforms, keys and source choices are bit-equal, so values and gradients
agree to float rounding. Tolerances: rtol 2e-3 (atol 1e-6 on values) against
JAX's default backend, the tolerance of JAX's own cross-backend test
(tests/test_diff.py:53-63); the same against JAX's mxu backend at precision
"highest" in interpret mode; optimize_route's waypoints within 1e-5 m and
durations within rtol 1e-5 of optax's after 3 steps.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace import diff as J
from uvtrace.geometry.procedural import make_box_room
from uvtrace_torch import diff as P
from uvtrace_torch.diff import estimator as est
from uvtrace_torch.ops import rng

RTOL, ATOL = 2e-3, 1e-6
LAMP = np.array([0.3, -0.4], np.float32)


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)


@pytest.fixture(scope="module")
def scenes(room):
    return J.make_diff_scene(room), P.make_diff_scene(room, device="cpu")


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _port_grad(fn, *args):
    """(value, gradients) of sum(fn(*args)) with respect to every arg."""
    ts = [torch.tensor(np.asarray(a, np.float32), requires_grad=True) for a in args]
    out = fn(*ts)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out.sum(), ts)]


def test_scene_geometry_and_refusals(room, scenes):
    js, ps = scenes
    for name in ("v0", "e1", "e2"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)))
    np.testing.assert_allclose(ps.normal.numpy(), np.asarray(js.normal), atol=1e-6)
    assert ps.trav_scene.tri_idx_flat.shape[0] == ps.trav_scene.n_clusters * 128
    # the clustered shadow rays (once raising naming ROADMAP A4): budget-free
    # by default (every cluster), max_clusters= as given, hits in triangle ids
    cl = P.make_diff_scene(room, backend="clustered", device="cpu")
    assert cl.slot_to_tri is None and cl.extend_fn.keywords["max_clusters"] == cl.trav_scene.n_clusters
    assert P.make_diff_scene(room, max_clusters=8, backend="clustered", device="cpu").extend_fn.keywords[
        "max_clusters"] == 8
    jc = J.make_diff_scene(room, backend="clustered")
    o = np.repeat(np.array([[0.3, -0.2, -0.4]], np.float32), 500, 0)
    d = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jt, jh = jc.extend_fn(jc.trav_scene, jnp.asarray(o), jnp.asarray(d))
    pt, ph = cl.extend_fn(cl.trav_scene, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert (ph.numpy() >= 0).mean() > 0.9
    with pytest.raises(ValueError, match="backend"):
        P.make_diff_scene(room, backend="pallas", device="cpu")
    # shadow rays shard over a 1-D ray mesh (tests/test_torch_parallel.py); a
    # rays x texels mesh is refused, with the function that builds the right one
    two_d = types.SimpleNamespace(mesh_dim_names=("rays", "texels"), size=lambda i: 2)
    with pytest.raises(ValueError, match="make_ray_mesh"):
        P.make_diff_scene(room, device_mesh=two_d, device="cpu")


def test_scene_defaults_to_cuda_and_refuses_without_a_card(room, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_diff_scene(room)


def test_visibility_matches_jax(room, scenes):
    """Binary visibility between the rod and surface samples, and between
    surface points (the bounce term's rays start on triangles): equal bits
    but for at most 0.1% of rays (an f32 t at the threshold)."""
    from uvtrace.diff.estimator import _visibility as jax_visibility

    js, ps = scenes
    g = np.random.default_rng(3)
    t_count = room.triangle_count
    tri = room.tris[g.integers(0, t_count, (6, 64))]
    uv = g.dirichlet(np.ones(3), (6, 64)).astype(np.float32)
    qs = np.einsum("stk,stkc->stc", uv, tri).astype(np.float32)  # points on triangles
    rods = np.array([[[0.3, -0.2, -0.4]], [[0.0, 0.0, 0.0]], [[1.0, 0.5, 1.0]]], np.float32)
    for rod in (rods[[0, 1, 2, 0, 1, 2]], qs[:, :1]):  # from the rod, then from surface points
        vj = np.asarray(jax_visibility(js, jnp.asarray(rod), jnp.asarray(qs)))
        vp = est._visibility(ps, torch.from_numpy(rod), torch.from_numpy(qs)).numpy()
        assert vp.shape == vj.shape and vp.dtype == np.float32
        assert (vp != vj).sum() <= max(1, vp.size // 1000)
        assert 0.05 < vp.mean() < 1.0


def test_irradiance_and_gradient_match_jax(room, scenes):
    js, ps = scenes
    key = jax.random.PRNGKey(5)
    base = room.floor_height + 0.8

    def jf(xz):
        return J.irradiance(js, xz, base, 1.0, 450.0, key, n_samples=4)

    ej, gj = jax.value_and_grad(lambda xz: jnp.sum(jf(xz)))(jnp.asarray(LAMP))
    ep, (gp,) = _port_grad(lambda xz: P.irradiance(ps, xz, base, 1.0, 450.0, _words(key), n_samples=4), LAMP)
    np.testing.assert_allclose(ep, np.asarray(jf(jnp.asarray(LAMP))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ep.sum(), float(ej), rtol=RTOL)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=RTOL, atol=ATOL)
    assert (ep >= 0).all() and (ep > 0).mean() > 0.5


@pytest.mark.parametrize("case", ["direct", "bounce", "image"])
def test_clustered_backend_matches_jax(room, scenes, case, monkeypatch):
    """backend="clustered" (budget-free Möller–Trumbore shadow rays, JAX's
    CPU default) against JAX's default scene: values and gradients with
    respect to the lamp (and the reflectances of the 1-bounce term), and the
    dose image's plan, whose triangle ids need no slot map; both packages on
    the numpy cluster builder, so the plan's ids are bit-equal too."""
    import uvtrace_torch.bvh.native

    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)
    js = scenes[0]
    ps = P.make_diff_scene(room, backend="clustered", device="cpu")
    key = jax.random.PRNGKey(5)
    base = room.floor_height + 0.8
    if case == "direct":
        ej, gj = jax.value_and_grad(lambda xz: jnp.sum(J.irradiance(js, xz, base, 1.0, 450.0, key, n_samples=4)))(
            jnp.asarray(LAMP))
        ep, (gp,) = _port_grad(lambda xz: P.irradiance(ps, xz, base, 1.0, 450.0, _words(key), n_samples=4), LAMP)
        np.testing.assert_allclose(ep.sum(), float(ej), rtol=RTOL)
        np.testing.assert_allclose(gp, np.asarray(gj), rtol=RTOL, atol=ATOL)
        assert (ep > 0).mean() > 0.5
    elif case == "bounce":
        rho = np.full(room.triangle_count, 0.5, np.float32)
        kw = dict(n_samples=2, n_sources=16, n_bounces=1, source_chunk=8)

        def jf(xz, r):
            return jnp.sum(J.bounce_irradiance(js, xz, base, 1.0, 450.0, r, jnp.asarray(room.areas), key, **kw))

        vj, (gxj, grj) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(LAMP), jnp.asarray(rho))
        vp, (gxp, grp) = _port_grad(
            lambda xz, r: P.bounce_irradiance(ps, xz, base, 1.0, 450.0, r, room.areas, _words(key), **kw), LAMP, rho)
        np.testing.assert_allclose(vp.sum(), float(vj), rtol=RTOL)
        np.testing.assert_allclose(gxp, np.asarray(gxj), rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(grp, np.asarray(grj), rtol=RTOL, atol=1e-5)
    else:
        jplan, pplan = J.plan_dose_image(js, res=16), P.plan_dose_image(ps, res=16)
        np.testing.assert_array_equal(pplan.tri.numpy(), np.asarray(jplan.tri))
        np.testing.assert_array_equal(pplan.points.numpy(), np.asarray(jplan.points))
        assert pplan.mask.numpy().mean() > 0.5


def test_irradiance_matches_jax_mxu_highest(room):
    """Once against JAX's own mxu backend at precision "highest" (Pallas
    interpret mode): its Plücker t is the port's plain version's."""
    js = J.make_diff_scene(room, backend="mxu", precision="highest")
    ps = P.make_diff_scene(room, backend="mxu", precision="highest", device="cpu")
    key = jax.random.PRNGKey(3)
    base = room.floor_height + 0.8
    ej, gj = jax.value_and_grad(lambda xz: jnp.mean(J.irradiance(js, xz, base, 1.0, 450.0, key, n_samples=2)))(
        jnp.asarray(LAMP))
    ep, (gp,) = _port_grad(lambda xz: P.irradiance(ps, xz, base, 1.0, 450.0, _words(key), n_samples=2).mean(),
                           LAMP)
    np.testing.assert_allclose(ep, float(ej), rtol=RTOL)
    np.testing.assert_allclose(gp, np.asarray(gj), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_bounce_irradiance_and_gradients_match_jax(room, scenes, n_bounces):
    """Values and gradients with respect to the lamp and every reflectance."""
    js, ps = scenes
    key = jax.random.PRNGKey(4)
    base = room.floor_height + 0.8
    rho = np.full(room.triangle_count, 0.5, np.float32)
    kw = dict(n_samples=2, n_sources=16, n_bounces=n_bounces, source_chunk=8)

    def jf(xz, r):
        return jnp.sum(J.bounce_irradiance(js, xz, base, 1.0, 450.0, r, jnp.asarray(room.areas), key, **kw))

    vj, (gxj, grj) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(LAMP), jnp.asarray(rho))
    vp, (gxp, grp) = _port_grad(
        lambda xz, r: P.bounce_irradiance(ps, xz, base, 1.0, 450.0, r, room.areas, _words(key), **kw), LAMP, rho)
    np.testing.assert_allclose(vp.sum(), float(vj), rtol=RTOL)
    np.testing.assert_allclose(gxp, np.asarray(gxj), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(grp, np.asarray(grj), rtol=RTOL, atol=1e-5)
    assert vp.min() >= 0 and vp.max() > 0


def test_route_dose_and_gradients_match_jax(room, scenes):
    """route_dose over two waypoints, with the 2-bounce term: values and the
    gradients with respect to waypoints and durations."""
    js, ps = scenes
    key = jax.random.PRNGKey(6)
    base = room.floor_height + 0.8
    wp = np.array([[0.0, 0.0], [0.5, 0.5]], np.float32)
    durs = np.array([30.0, 60.0], np.float32)
    rho = np.full(room.triangle_count, 0.3, np.float32)
    kw = dict(n_samples=2, n_sources=8, n_bounces=2)

    def jf(w, d):
        return J.route_dose(js, w, d, base, 1.0, 450.0, key, reflectance=jnp.asarray(rho),
                            areas=jnp.asarray(room.areas), **kw)

    dj = np.asarray(jf(jnp.asarray(wp), jnp.asarray(durs)))
    gwj, gdj = jax.grad(lambda w, d: jnp.mean(jf(w, d)), argnums=(0, 1))(jnp.asarray(wp), jnp.asarray(durs))
    dp, (gwp, gdp) = _port_grad(lambda w, d: P.route_dose(ps, w, d, base, 1.0, 450.0, _words(key),
                                                          reflectance=torch.from_numpy(rho), areas=room.areas,
                                                          **kw) / room.triangle_count, wp, durs)
    np.testing.assert_allclose(dp * room.triangle_count, dj, rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(gwp, np.asarray(gwj), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(gdp, np.asarray(gdj), rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="areas"):
        P.route_dose(ps, wp, durs, base, 1.0, 450.0, _words(key), reflectance=torch.from_numpy(rho))


@pytest.mark.parametrize("case", ["durations", "frozen", "bounds"])
def test_optimize_route_matches_optax(room, scenes, case):
    """Three steps of the hand-written Adam against optax.adam (and
    multi_transform with set_to_zero when the durations are frozen)."""
    js, ps = scenes
    wp = np.array([[0.2, 0.1], [-0.4, 0.3]], np.float32)
    durs = np.array([40.0, 20.0], np.float32)
    kw = dict(steps=3, n_samples=2, optimize_durations=case != "frozen",
              bounds=((-2.0, -2.0), (2.0, 2.0)) if case == "bounds" else None)
    rj = J.optimize_route(js, wp, durs, room.floor_height + 0.8, 1.0, 450.0, **kw)
    rp = P.optimize_route(ps, wp, durs, room.floor_height + 0.8, 1.0, 450.0, **kw)
    np.testing.assert_allclose(rp.history, rj.history, rtol=1e-5)
    np.testing.assert_allclose(rp.waypoints_xz, rj.waypoints_xz, atol=1e-5)
    np.testing.assert_allclose(rp.durations, rj.durations, rtol=1e-5)
    np.testing.assert_allclose(rp.final_dose_masked, rj.final_dose_masked, rtol=RTOL, atol=1e-4)
    assert rp.waypoints_xz.dtype == np.float32 and not np.allclose(rp.waypoints_xz, wp)
    if case == "frozen":
        np.testing.assert_allclose(rp.durations, durs, rtol=1e-5)


def test_optimize_route_with_reflectance_matches_optax(room, scenes):
    js, ps = scenes
    wp = np.array([[1.0, 1.5]], np.float32)
    durs = np.array([60.0], np.float32)
    kw = dict(steps=3, n_samples=2, optimize_durations=False, seed=0, reflectance=0.6, areas=room.areas,
              n_sources=8, n_bounces=2)
    rj = J.optimize_route(js, wp, durs, room.floor_height + 0.8, 1.0, 450.0, **kw)
    rp = P.optimize_route(ps, wp, durs, room.floor_height + 0.8, 1.0, 450.0, **kw)
    np.testing.assert_allclose(rp.history, rj.history, rtol=1e-5)
    np.testing.assert_allclose(rp.waypoints_xz, rj.waypoints_xz, atol=1e-5)
    np.testing.assert_allclose(rp.final_min_dose, rj.final_min_dose, rtol=RTOL, atol=1e-4)


# ---------------------------------------------------- the port's own checks
# (the counterparts of tests/test_diff.py:110-148 and its bounce classes)


def _irr_mean(ps, room, key, n_samples=4):
    base = room.floor_height + 0.8
    return lambda xz: P.irradiance(ps, xz, base, 1.0, 450.0, key, n_samples=n_samples).mean()


def test_gradient_matches_finite_difference(room, scenes):
    """Autograd equals central FD of the same CRN estimator (visibility held
    fixed, geometry differentiated): rtol 0.08, atol 1e-5."""
    ps = scenes[1]
    f = _irr_mean(ps, room, rng.PRNGKey(3))
    x0 = torch.tensor([0.3, -0.2])
    xt = x0.clone().requires_grad_(True)
    g = torch.autograd.grad(f(xt), xt)[0].numpy()
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2)
            e[i] = 1e-3
            fd = (f(x0 + e) - f(x0 - e)).item() / 2e-3
            np.testing.assert_allclose(g[i], fd, rtol=0.08, atol=1e-5)


def test_gradient_wrt_durations(room, scenes):
    """The dose is linear in durations: the gradient is each waypoint's mean
    dose rate, equal to a forward difference."""
    ps = scenes[1]
    wp = torch.tensor([[0.0, 0.0], [0.5, 0.5]])

    def f(durs):
        return P.route_dose(ps, wp, durs, room.floor_height + 0.8, 1.0, 450.0, rng.PRNGKey(4), n_samples=2).mean()

    durs = torch.tensor([30.0, 60.0], requires_grad=True)
    g = torch.autograd.grad(f(durs), durs)[0].numpy()
    assert (g > 0).all()
    with torch.no_grad():
        fd0 = (f(durs + torch.tensor([1.0, 0.0])) - f(durs)).item()
    np.testing.assert_allclose(g[0], fd0, rtol=1e-3)


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_reflectance_gradient_matches_fd(room, scenes, n_bounces):
    """The bounce term is a polynomial of degree n_bounces in reflectance:
    autograd equals central FD to float precision (rtol 1e-3, CRN)."""
    ps = scenes[1]
    t = room.triangle_count
    key = rng.PRNGKey(0)

    def j(rho):
        return P.bounce_irradiance(ps, torch.tensor([0.0, 0.0]), room.floor_height + 0.8, 1.0, 450.0, rho,
                                   room.areas, key, n_samples=2, n_sources=16, n_bounces=n_bounces).sum()

    rho0 = torch.full((t,), 0.4, requires_grad=True)
    g = torch.autograd.grad(j(rho0), rho0)[0].numpy()
    with torch.no_grad():
        for i in (0, t // 2):
            basis = torch.zeros(t)
            basis[i] = 0.05
            fd = (j(rho0 + basis) - j(rho0 - basis)).item() / 0.1
            np.testing.assert_allclose(g[i], fd, rtol=1e-3, atol=1e-7)


def test_lamp_gradient_matches_fd_two_bounce(room, scenes):
    ps = scenes[1]
    rho = torch.full((room.triangle_count,), 0.5)

    def j(xz):
        return P.bounce_irradiance(ps, xz, room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, rng.PRNGKey(3),
                                   n_samples=2, n_sources=16, n_bounces=2).sum()

    x0 = torch.tensor([0.1, -0.2])
    xt = x0.clone().requires_grad_(True)
    g = torch.autograd.grad(j(xt), xt)[0].numpy()
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2)
            e[i] = 1e-3
            fd = (j(x0 + e) - j(x0 - e)).item() / 2e-3
            np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=1e-4)


def test_terms_monotone_chunking_free_and_one_bounce_named(room, scenes):
    """Each bounce level adds energy and the series contracts; the receiver
    pass's source chunks do not change the estimate; one_bounce_irradiance
    is the 1-bounce case."""
    ps = scenes[1]
    rho = torch.full((room.triangle_count,), 0.5)
    args = (ps, torch.tensor([0.0, 0.0]), room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, rng.PRNGKey(0))
    e = [P.bounce_irradiance(*args, n_samples=2, n_sources=24, n_bounces=b).numpy() for b in (1, 2, 3)]
    assert (e[1] >= e[0] - 1e-6).all() and (e[2] >= e[1] - 1e-6).all()
    assert 0 < (e[1] - e[0]).sum() < e[0].sum() and 0 < (e[2] - e[1]).sum() < (e[1] - e[0]).sum()
    a = P.bounce_irradiance(*args, n_samples=2, n_sources=24, n_bounces=2, source_chunk=5).numpy()
    np.testing.assert_allclose(a, e[1], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(P.one_bounce_irradiance(*args, n_samples=2, n_sources=24).numpy(), e[0])


def test_route_optimization_improves_min_dose(room, scenes):
    ps = scenes[1]
    init_wp = np.array([[1.5, 2.5]], np.float32)  # a corner start
    res = P.optimize_route(ps, init_wp, np.array([60.0], np.float32), room.floor_height + 0.8, 1.0, 450.0,
                           steps=25, learning_rate=0.1, n_samples=2, temperature=10.0, optimize_durations=False)
    assert len(res.history) == 25 and res.history[-1] < res.history[0]
    assert np.isfinite(res.final_min_dose)
    assert np.linalg.norm(res.waypoints_xz[0]) < np.linalg.norm(init_wp[0])  # towards the interior


def test_optimize_bounds_start_where_asked(room, scenes):
    """With bounds, zero steps return the requested waypoints (the logit of
    the start), inside the bounds."""
    res = P.optimize_route(scenes[1], np.array([[2.0, 3.0]], np.float32), np.array([60.0], np.float32),
                           room.floor_height + 0.8, 1.0, 450.0, steps=0, n_samples=2,
                           bounds=((0.0, 0.0), (5.0, 5.0)))
    np.testing.assert_allclose(res.waypoints_xz, [[2.0, 3.0]], atol=1e-3)
    assert res.history == []
