"""Texel-resolution dose maps of the port (uvtrace_torch/ops/texel.py, the
atlas path of sim/launch.py and sim/simulator.py) against the JAX package on
the same inputs, on the CPU.

The JAX side runs traversal="mxu" (precision "highest", Pallas interpret
mode); the port's "mxu" and "pallas" run the plain versions of B2 and B3.
Both draw the same photons. A ray whose closest hit differs (a tie or an
edge flip, tests/test_torch_traverse_mxu.py) moves one count between two
triangles, and a hit whose barycentrics sit on a cell boundary can land in
the neighbouring texel when the two t values differ by an ulp. Within one
port launch every texel count belongs to its triangle's count exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvtrace.bvh.native
import uvtrace_torch.bvh.native
from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.ops import texel as jax_texel
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace.sim import ViewMode as JaxViewMode
from uvtrace.sim.launch import launch_counts as jax_launch_counts
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import texel
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.sim import SimParams, Simulator, ViewMode
from uvtrace_torch.sim.launch import launch_counts
from uvtrace_torch.sim.simulator import from_jax_state

N = 1 << 13  # photons per launch: 8 chunks of 1024
DENSITY = 32.0
LAMP = [0.2, None, -0.3]  # y: the floor + 0.8
TEXEL_SHARE = 2e-3  # texel counts that may differ from JAX's, as a share of the hits


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


def _lamp(room):
    return [LAMP[0], room.floor_height + 0.8, LAMP[2]]


@pytest.fixture(scope="module")
def jax_sims(room):
    """JAX Simulators with an atlas (traversal "mxu"), one per bounce depth,
    on the numpy cluster builder so both packages index the same slots."""
    sims = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(uvtrace.bvh.native, "available", lambda: False)
        for b in (0, 1):
            params = JaxSimParams(photon_count=N, max_iterations=1, texel_density=DENSITY, traversal="mxu",
                                  precision="highest", max_bounces=b, reflectance=0.5, seed=3)
            sims[b] = JaxSimulator(room, params, route=[JaxLightPos(0.2, -0.3, 1.0)], ray_chunk=1024)
    return sims


def _jax_launch(js, n, chunk_offset=0, key=5):
    b = js.params.max_bounces
    out = jax_launch_counts(
        js.scene, jax.random.PRNGKey(key), jnp.asarray(_lamp(js.mesh), jnp.float32), jnp.float32(1.0),
        t_count=js.triangle_count, n=n, chunk=1024, sampler="stratified", method="segment",
        extend_fn=js._extend, max_bounces=b, normals=js._normals_launch if b else None,
        reflectance=js._reflectance_launch() if b else None, atlas=js._atlas_launch, n_texels=js._n_texels,
        tri_v0=js._tri_v0, tri_e1=js._tri_e1, tri_e2=js._tri_e2, slot_map=js._slot_map,
        extend_counts_fn=js._extend_counts, fused_counts_fn=js._fused_counts,
        extend_bounce_fn=js._extend_bounce if b else None, chunk_offset=chunk_offset)
    return tuple(np.asarray(a) for a in out)


@pytest.fixture(scope="module")
def jax_launches(jax_sims):
    cache = {}

    def get(b, n=N, chunk_offset=0):
        if (b, n, chunk_offset) not in cache:
            cache[b, n, chunk_offset] = _jax_launch(jax_sims[b], n, chunk_offset)
        return cache[b, n, chunk_offset]

    return get


def _port_sim(room, traversal="mxu", bounces=0, **kw):
    params = SimParams(photon_count=N, max_iterations=1, texel_density=DENSITY, traversal=traversal,
                       max_bounces=bounces, reflectance=0.5, seed=3, **kw)
    return Simulator(room, params, route=[LightPos(0.2, -0.3, 1.0)], ray_chunk=1024, device="cpu")


def _port_launch(ps, n, chunk_offset=0, key=5):
    b = ps.params.max_bounces
    return launch_counts(
        ps.scene, rng.PRNGKey(key), _lamp(ps.mesh), np.float32(1.0), t_count=ps.triangle_count, n=n,
        chunk=1024, max_bounces=b, normals=ps._normals_launch if b else None,
        reflectance=ps._reflectance_launch() if b else None, atlas=ps._atlas_launch, n_texels=ps._n_texels,
        tri_v0=ps._tri_v0, tri_e1=ps._tri_e1, tri_e2=ps._tri_e2, slot_map=ps._slot_map,
        chunk_offset=chunk_offset, **ps._trace)


def _per_triangle(ps, tex_counts):
    tri_of = texel.slot_triangles(ps.atlas).long()
    return torch.zeros(ps.triangle_count, dtype=torch.int64).index_add_(0, tri_of, tex_counts.long())


# ---------------------------------------------------------------- the atlas


@pytest.mark.parametrize("areas,density,max_slots", [
    ("mixed", 4.0, 1 << 22), ("room", 16.0, 1 << 22), ("room", 64.0, 5000),
    ("random", 64.0, 6000), ("uniform", 64.0, 5000)])
def test_build_atlas_equal(room, areas, density, max_slots):
    """Field for field, including the budget-cap cases (the k >= 1 floor
    fighting the scale-down)."""
    if areas == "mixed":
        areas = np.array([1.0, 0.25, 4.0, 1e-8])
    elif areas == "room":
        areas = room.areas
    elif areas == "random":
        areas = np.random.default_rng(3).uniform(0.001, 4.0, size=5000)
    else:
        areas = np.full(1000, 100.0)
    want = jax_texel.build_atlas(areas, density=density, max_slots=max_slots)
    got = texel.build_atlas(areas, density=density, max_slots=max_slots)
    assert got.n_slots == want.n_slots <= max_slots
    for f in ("base", "k", "cell_area"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_build_atlas_budget_below_triangle_count_raises():
    areas = np.ones(5000)
    with pytest.raises(ValueError, match="triangle count"):
        jax_texel.build_atlas(areas, density=1.0, max_slots=4999)
    with pytest.raises(ValueError, match="triangle count"):
        texel.build_atlas(areas, density=1.0, max_slots=4999)


def test_barycentrics_within_1e5():
    g = np.random.default_rng(0)
    v0, e1, e2 = (g.normal(size=(4096, 3)).astype(np.float32) for _ in range(3))
    u, v = g.uniform(0, 0.5, (2, 4096)).astype(np.float32)
    d = g.normal(size=(4096, 3)).astype(np.float32)
    t = g.uniform(0.5, 3.0, 4096).astype(np.float32)
    orig = (v0 + u[:, None] * e1 + v[:, None] * e2 - t[:, None] * d).astype(np.float32)
    want = jax_texel.barycentrics(*(jnp.asarray(a) for a in (orig, d, t, v0, e1, e2)))
    got = texel.barycentrics(*(torch.from_numpy(a) for a in (orig, d, t, v0, e1, e2)))
    for a, b, exact in zip(got, want, (u, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
        np.testing.assert_allclose(a.numpy(), exact, atol=2e-3)


def test_texel_ids_equal_but_on_cell_boundaries():
    """Equal slot for every hit but where u k or v k lies within 4 ulp of an
    integer (the f32 product may round either way there)."""
    g = np.random.default_rng(1)
    areas = g.uniform(0.01, 2.0, 50)
    jatlas = jax_texel.build_atlas(areas, density=8.0)
    patlas = texel.build_atlas(areas, density=8.0)
    hits = g.integers(-1, 50, 20000).astype(np.int32)
    u, v = g.uniform(-0.1, 1.1, (2, 20000)).astype(np.float32)
    u[:500] = np.float32(0.25)  # exact cell edges for even k
    want = np.asarray(jax_texel.texel_ids(jatlas, jnp.asarray(hits), jnp.asarray(u), jnp.asarray(v)))
    got = texel.texel_ids(patlas, torch.from_numpy(hits), torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert got.dtype == np.int32
    k = np.asarray(jatlas.k, np.float32)[np.maximum(hits, 0)]

    def near_int(x):
        x = np.clip(x, 0, 1)
        return np.abs(x * k - np.round(x * k)) <= 4 * np.spacing(np.float32(np.maximum(x * k, 1)))

    fold = np.clip(u, 0, 1) + np.clip(v, 0, 1) > 1
    boundary = near_int(u) | near_int(v) | near_int(1 - np.clip(u, 0, 1)) | near_int(1 - np.clip(v, 0, 1))
    differ = got != want
    assert not (differ & ~boundary).any() and differ.mean() < 1e-3
    assert (got[hits < 0] == -1).all() and (fold.any())
    tri_of = texel.slot_triangles(patlas).numpy()
    np.testing.assert_array_equal(tri_of[got[hits >= 0]], hits[hits >= 0])


def test_slot_triangles_slot_areas_and_texel_dose_equal(room):
    jatlas = jax_texel.build_atlas(room.areas, density=16.0)
    patlas = texel.build_atlas(room.areas, density=16.0)
    got = texel.slot_triangles(patlas)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_texel.slot_triangles(jatlas)))
    np.testing.assert_array_equal(texel.slot_areas(patlas).numpy(), np.asarray(jax_texel.slot_areas(jatlas)))
    counts = np.random.default_rng(2).integers(0, 50, patlas.n_slots).astype(np.float32)
    want = np.asarray(jax_texel.texel_dose(jatlas, jnp.asarray(counts), 3072, 45.0))
    np.testing.assert_array_equal(texel.texel_dose(patlas, torch.from_numpy(counts), 3072, 45.0).numpy(), want)


# --------------------------------------------------------------- launches


@pytest.mark.parametrize("traversal,bounces", [("mxu", 0), ("mxu", 1), ("pallas", 0), ("pallas", 1)])
def test_texel_launch_matches_jax(room, jax_launches, traversal, bounces):
    """One launch with an atlas: (1) each triangle's texel counts sum exactly
    to its count in the same port launch; (2) the triangle counts match
    JAX's within the flip rule (2 counts per flipped ray, at most 0.1% of
    the rays of each segment); (3) the texel counts differ from JAX's in at
    most TEXEL_SHARE of the hits (measured: 0 in all four cases)."""
    ps = _port_sim(room, traversal, bounces)
    counts, tex, overflow = _port_launch(ps, N)
    assert counts.dtype == tex.dtype == overflow.dtype == torch.int32 and int(overflow) == 0
    assert tex.shape == (ps.atlas.n_slots,) and counts.shape == (room.triangle_count,)
    np.testing.assert_array_equal(_per_triangle(ps, tex).numpy(), counts.numpy())
    jc, jt, jo = jax_launches(bounces)
    np.testing.assert_array_equal(jc, _per_triangle(ps, torch.from_numpy(jt.copy())).numpy())  # JAX's own rule
    hits = int(counts.sum())
    assert abs(hits - int(jc.sum())) <= (1 + bounces) * N // 1000
    assert np.abs(counts.numpy().astype(np.int64) - jc).sum() <= 2 * (1 + bounces) * N // 1000
    tex_diff = np.abs(tex.numpy().astype(np.int64) - jt).sum() / 2
    assert tex_diff <= TEXEL_SHARE * hits, tex_diff / hits
    if bounces == 0:
        assert hits == N  # a closed room
    else:
        assert hits > N


def test_fused_mode_is_off_with_an_atlas(room):
    """traversal="auto" with an atlas runs B2 in counts mode, never B1's
    fused generator, and gives the "mxu" launch's counts."""
    ps = _port_sim(room, "auto")
    assert ps._trace["fused_counts_fn"] is tm.fused_trace_counts

    def fused(*args, **kwargs):
        raise AssertionError("the fused kernel ran on a texel launch")

    ps._trace["fused_counts_fn"] = fused
    got = _port_launch(ps, N)
    want = _port_launch(_port_sim(room, "mxu"), N)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [2, 5])
def test_chunk_offset(room, jax_launches, k):
    """chunk_offset=k runs chunks k.. of a longer launch (global keys), and
    equals JAX's launch_counts(chunk_offset=k) within the launch rules."""
    ps = _port_sim(room, "mxu", 1)
    tail = _port_launch(ps, 2048, chunk_offset=k)
    head = _port_launch(ps, 1024 * k)
    whole = _port_launch(ps, 1024 * (k + 2))
    for t_, h, w in zip(tail[:2], head[:2], whole[:2]):
        assert torch.equal(t_ + h, w)
    jc, jt, _ = jax_launches(1, 2048, k)
    assert np.abs(tail[0].numpy().astype(np.int64) - jc).sum() <= 2 * 2 * 2048 // 1000
    assert np.abs(tail[1].numpy().astype(np.int64) - jt).sum() / 2 <= TEXEL_SHARE * int(tail[0].sum())


def test_masked_tail_bins_no_texel_past_n(room):
    """The iid samplers mask the last chunk's lanes past n: their hits are
    neither counted nor binned into texels."""
    ps = _port_sim(room, "pallas", sampler="native")
    kw = dict(t_count=room.triangle_count, chunk=1024, sampler="native", atlas=ps._atlas_launch,
              n_texels=ps._n_texels, tri_v0=ps._tri_v0, tri_e1=ps._tri_e1, tri_e2=ps._tri_e2, **ps._trace)
    counts, tex, _ = launch_counts(ps.scene, rng.PRNGKey(1), _lamp(room), 1.0, n=1500, **kw)
    assert int(counts.sum()) == int(tex.sum()) == 1500
    np.testing.assert_array_equal(_per_triangle(ps, tex).numpy(), counts.numpy())


# ------------------------------------------------------------- the session


@pytest.fixture(scope="module")
def jax_run(jax_sims):
    js = jax_sims[0]
    js.reset()
    js.run_iteration()
    return js


def _jax_state(js):
    return dict(photon_map=np.asarray(js.photon_map), max_photon_map=np.asarray(js.max_photon_map),
                photon_map_size=js.photon_map_size, _launch_n=js._launch_n, curr_iterations=js.curr_iterations,
                key=np.asarray(jax.random.key_data(js.key)).astype(np.uint32), global_seed=int(js.global_seed),
                photon_map_tex=np.asarray(js.photon_map_tex), max_photon_map_tex=np.asarray(js.max_photon_map_tex))


@pytest.mark.parametrize("traversal", ["mxu", "pallas"])
def test_session_texel_maps_match_jax(room, jax_run, traversal):
    """One iteration of the Simulator: the texel accumulators conserve the
    triangle accumulators' counts, match JAX's within the rules above, and
    dosage_map_texels of JAX's own state equals JAX's."""
    ps = _port_sim(room, traversal)
    ps.run_iteration()
    assert float(ps.photon_map_tex.sum()) == float(ps.photon_map.sum()) == N
    np.testing.assert_array_equal(_per_triangle(ps, ps.photon_map_tex.long()).numpy(), ps.photon_map.numpy())
    jt = np.asarray(jax_run.photon_map_tex)
    assert np.abs(ps.photon_map_tex.numpy() - jt).sum() / 2 <= TEXEL_SHARE * N
    assert ps._launch_n == jax_run._launch_n and ps.photon_map_size == jax_run.photon_map_size
    same = from_jax_state(_port_sim(room, traversal), _jax_state(jax_run))
    for jv, pv in [(JaxViewMode.DOSAGE, ViewMode.DOSAGE), (JaxViewMode.MAX_POWER, ViewMode.MAX_POWER)]:
        np.testing.assert_allclose(same.dosage_map_texels(pv).numpy(), np.asarray(jax_run.dosage_map_texels(jv)),
                                   rtol=1e-6)
    dose = ps.dosage_map_texels()
    assert dose.shape == (ps.atlas.n_slots,) and torch.isfinite(dose).all() and dose.max() > 0


@pytest.mark.parametrize("traversal", ["mxu", "pallas"])
def test_dose_grid_texels_match_jax(room, jax_run, traversal, monkeypatch):
    """dose_grid(texels=True|None|False) from JAX's state: equal but on
    probes whose first hit is a t-tie between triangles (the box room's
    probes run along shared edges; the gen-1 DFS keeps the first triangle
    it visits, JAX's split kernel the lowest slot), or whose barycentrics
    sit on a cell boundary: at most 2% of the 48^2 probes (measured: none
    through "mxu", 1.4% through "pallas"). The port is held to the numpy
    cluster builder, as the JAX side is (jax_sims): the gen-1 DFS's visit
    order, and with it its ties, follows the clusters."""
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)
    ps = from_jax_state(_port_sim(room, traversal), _jax_state(jax_run))
    grids = {}
    for texels in (True, None, False):
        jg = jax_run.dose_grid(res=48, texels=texels)
        grids[texels] = pg = ps.dose_grid(res=48, texels=texels)
        assert pg.shape == (48, 48) and pg.dtype == np.float32 and np.isfinite(pg).all()
        assert (pg != jg).mean() <= 0.02 and (pg > 0).mean() > 0.05
    np.testing.assert_array_equal(grids[True], grids[None])
    assert (grids[True] != grids[False]).mean() > 0.1  # texel doses, not the triangle averages
    with pytest.raises(ValueError, match="texel_density"):
        Simulator(room, SimParams(photon_count=N, max_iterations=1), device="cpu").dose_grid(8, texels=True)
