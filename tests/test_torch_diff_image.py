"""The port's differentiable dose image (uvtrace_torch.diff.image) against
uvtrace.diff.image on the CPU, and the port's own pixel-gradient checks (the
counterparts of tests/test_diff_image.py:37-92).

The plan's triangle ids equal JAX's but for ties: a probe of the grid that
crosses an edge shared by two floor triangles may name either, and each
differing id is held to such a tie (its hit point lies on both triangles). Images and pixel gradients: rtol 2e-3
against JAX's default CPU backend, the tolerance of JAX's cross-backend
test; the FD checks keep tests/test_diff_image.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace import diff as J
from uvtrace.geometry.procedural import make_box_room
from uvtrace_torch import diff as P
from uvtrace_torch.geometry.procedural import make_single_square
from uvtrace_torch.ops import rng

RES = 24


@pytest.fixture(scope="module")
def setup():
    room = make_box_room(subdivisions=4, clutter=1, seed=11, floor_y=-1.0)
    js, ps = J.make_diff_scene(room), P.make_diff_scene(room, device="cpu")
    return room, js, ps, J.plan_dose_image(js, res=RES), P.plan_dose_image(ps, res=RES)


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _distance_to_triangles(p, tri):
    """Distance of points p[N,3] to triangles tri[N,3,3] (planar distance
    where the projection falls inside, else to the nearest edge), in f64."""
    p, tri = p.astype(np.float64), tri.astype(np.float64)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    plane = np.abs(((p - a) * n).sum(1))
    q = p - ((p - a) * n).sum(1, keepdims=True) * n
    inside = np.ones(len(p), bool)
    edge = np.full(len(p), np.inf)
    for u, v in ((a, b), (b, c), (c, a)):
        inside &= (np.cross(v - u, q - u) * n).sum(1) >= -1e-9
        s = np.clip(((q - u) * (v - u)).sum(1) / ((v - u) ** 2).sum(1), 0, 1)
        edge = np.minimum(edge, np.linalg.norm(q - (u + s[:, None] * (v - u)), axis=1))
    return np.hypot(plane, np.where(inside, 0.0, edge))


def test_plan_matches_jax(setup):
    room, js, ps, jplan, pplan = setup
    mask_j, mask_p = np.asarray(jplan.mask), pplan.mask.numpy()
    tri_j, tri_p = np.asarray(jplan.tri), pplan.tri.numpy()
    assert pplan.res == RES and tri_p.dtype == np.int32 and pplan.points.shape == (RES * RES, 3)
    np.testing.assert_array_equal(mask_p, mask_j)
    # the probes of a res x res grid over a tessellated floor cross shared
    # edges: a differing id must be a tie, the hit point on both triangles
    same = tri_p == tri_j
    pts = np.asarray(jplan.points)[~same] - np.array([0.0, 1e-4, 0.0], np.float32)
    for ids in (tri_p[~same], tri_j[~same]):
        assert (_distance_to_triangles(pts, room.tris[ids]) < 1e-5).all()
    np.testing.assert_allclose(pplan.points.numpy()[mask_p], np.asarray(jplan.points)[mask_j], atol=1e-5)
    np.testing.assert_array_equal(pplan.normals.numpy()[same], np.asarray(jplan.normals)[same])
    assert mask_p.mean() > 0.95  # a closed box: nearly every probe lands
    verts = room.tris.reshape(-1, 3)
    assert pplan.points.numpy()[mask_p][:, 1].max() < verts[:, 1].max() - 0.04  # the ceiling is skipped


def test_image_and_pixel_gradients_match_jax(setup):
    """The image over two waypoints with the 2-bounce term, and the gradient
    of a worst-pixel softmin with respect to waypoints and durations."""
    room, js, ps, jplan, pplan = setup
    key = jax.random.PRNGKey(3)
    base = room.floor_height + 0.8
    wp = np.array([[0.1, 0.2], [-0.5, 0.4]], np.float32)
    durs = np.array([45.0, 30.0], np.float32)
    kw = dict(n_samples=2, reflectance=0.5, n_sources=8, n_bounces=2)

    def jf(w, d):
        img = J.dose_image(js, jplan, w, d, base, 1.0, 450.0, key, areas=jnp.asarray(room.areas), **kw)
        return img, J.optimize.softmin(jnp.where(img > 0, img, 1e9), 5.0)

    img_j = np.asarray(jf(jnp.asarray(wp), jnp.asarray(durs))[0])
    gwj, gdj = jax.grad(lambda w, d: jf(w, d)[1], argnums=(0, 1))(jnp.asarray(wp), jnp.asarray(durs))
    w_t = torch.tensor(wp, requires_grad=True)
    d_t = torch.tensor(durs, requires_grad=True)
    img_p = P.dose_image(ps, pplan, w_t, d_t, base, 1.0, 450.0, _words(key), areas=room.areas, **kw)
    gwp, gdp = torch.autograd.grad(P.optimize.softmin(torch.where(img_p > 0, img_p, 1e9), 5.0), (w_t, d_t))
    assert img_p.shape == (RES, RES)
    same = (pplan.tri.numpy() == np.asarray(jplan.tri)).reshape(RES, RES)
    np.testing.assert_allclose(img_p.detach().numpy()[same], img_j[same], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(gwp.numpy(), np.asarray(gwj), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(gdp.numpy(), np.asarray(gdj), rtol=2e-3, atol=1e-6)


def test_pixel_gradients_match_fd(setup):
    """Autograd of single pixels with respect to the lamp's x and z equals
    central FD of the same CRN estimator (rtol 0.08, atol 1e-5)."""
    room, _, ps, _, plan = setup
    key = rng.PRNGKey(7)
    base = room.floor_height + 0.8
    durs = torch.tensor([60.0])

    def image(xz):
        return P.dose_image(ps, plan, xz[None, :], durs, base, 1.0, 450.0, key, n_samples=4)

    x0 = torch.tensor([0.3, -0.2])
    img0 = image(x0).numpy()
    lit = np.argwhere(img0 > np.percentile(img0[img0 > 0], 60))
    for i, j in lit[:: max(1, len(lit) // 3)][:3]:
        xt = x0.clone().requires_grad_(True)
        g = torch.autograd.grad(image(xt)[i, j], xt)[0].numpy()
        with torch.no_grad():
            for ax in range(2):
                e = torch.zeros(2)
                e[ax] = 1e-3
                fd = (image(x0 + e)[i, j] - image(x0 - e)[i, j]).item() / 2e-3
                np.testing.assert_allclose(g[ax], fd, rtol=0.08, atol=1e-5)


def test_duration_and_reflectance_gradients_exact(setup):
    """The image is linear in durations and a polynomial in reflectance:
    autograd equals finite differences to float precision."""
    room, _, ps, _, plan = setup
    base = room.floor_height + 0.8
    wp = torch.tensor([[0.0, 0.0], [0.6, 0.4]])

    def f(durs):
        return P.dose_image(ps, plan, wp, durs, base, 1.0, 450.0, rng.PRNGKey(2), n_samples=2).sum()

    durs = torch.tensor([30.0, 50.0], requires_grad=True)
    g = torch.autograd.grad(f(durs), durs)[0].numpy()
    assert (g > 0).all()
    with torch.no_grad():
        fd = (f(durs + torch.tensor([1.0, 0.0])) - f(durs)).item()
    np.testing.assert_allclose(g[0], fd, rtol=1e-3)

    def h(rho):
        return P.dose_image(ps, plan, wp[:1], torch.tensor([60.0]), base, 1.0, 450.0, rng.PRNGKey(9), n_samples=2,
                            reflectance=rho, areas=room.areas, n_sources=8, n_bounces=2).sum()

    rho = torch.tensor(0.4, requires_grad=True)
    g = torch.autograd.grad(h(rho), rho)[0].item()
    with torch.no_grad():
        fd = (h(torch.tensor(0.45)) - h(torch.tensor(0.35))).item() / 0.1
    np.testing.assert_allclose(g, fd, rtol=1e-3)
    with torch.no_grad():
        base_img = P.dose_image(ps, plan, wp[:1], torch.tensor([60.0]), base, 1.0, 450.0, rng.PRNGKey(9),
                                n_samples=2)
        assert (P.dose_image(ps, plan, wp[:1], torch.tensor([60.0]), base, 1.0, 450.0, rng.PRNGKey(9), n_samples=2,
                             reflectance=0.5, areas=room.areas, n_sources=8, n_bounces=2)
                >= base_img - 1e-6).all()


def test_plan_on_flat_scene():
    """A roofless floor: the ceiling skip turns itself off and every probe
    lands; directly under the lamp beats the corners."""
    floor = make_single_square(center=(0.0, 0.0, 0.0), half_width=2.0, axis="y")
    scene = P.make_diff_scene(floor, device="cpu")
    plan = P.plan_dose_image(scene, res=8)
    assert bool(plan.mask.all())
    img = P.dose_image(scene, plan, [[0.0, 0.0]], [60.0], 0.5, 1.0, 450.0, rng.PRNGKey(0), n_samples=4).numpy()
    assert np.isfinite(img).all() and (img > 0).all() and img[4, 4] > img[0, 0]
