"""The reference sampler's RNG streams, both iid samplers and the launch in
triangle-id space (the gen-1 DFS path) against the JAX package.

Inputs are made with numpy from a seed and given to both packages.
Tolerances, with their reasons:
  - wang_hash, xorshift32, random_float, f32_to_u32_sat, photon_seeds,
    advance_global_seed and generate_reference are integer streams and f32
    steps taken one at a time: bit-equal;
  - generate_native: origins and dir.y come from threefry bits and f32
    arithmetic: bit-equal; dir.x/z go through cos/sin, whose XLA:CPU and
    torch versions differ by an ulp: within 2 ulp of 1;
  - launch_counts against JAX's launch_counts with the Pallas kernel in
    interpret mode (one run per case, in a module fixture): the same photons
    and the same closest hits (tests/test_torch_pallas.py), so counts are
    expected equal and were equal on every case here; the test allows the
    flip bound, one count moved between two triangles for each of at most
    n/1000 flipped rays in each traced segment.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops import generate as jax_generate
from uvtrace.ops import rng as jax_rng
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.traverse_pallas import build_pallas_scene as jax_build_pallas_scene
from uvtrace.ops.traverse_pallas import traverse_pallas as jax_traverse_pallas
from uvtrace.sim.launch import launch_counts as jax_launch_counts
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import traverse_pallas as tp
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.generate import generate_native, generate_reference
from uvtrace_torch.sim.launch import launch_counts
from uvtrace_torch.utils import timing

TWO_ULP_OF_ONE = 2 * float(np.spacing(np.float32(1)))
EDGE_U32 = [0, 1, 2, 61, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]


def _u32(seed: int, n: int = 5000) -> np.ndarray:
    return np.concatenate([np.array(EDGE_U32, np.uint32),
                           np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)])


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_wang_hash_xorshift_random_float_match_jax(seed):
    s = _u32(seed)
    np.testing.assert_array_equal(rng.wang_hash(_t(s)).numpy(), np.asarray(jax_rng.wang_hash(s)).astype(np.int64))
    np.testing.assert_array_equal(rng.xorshift32(_t(s)).numpy(),
                                  np.asarray(jax_rng.xorshift32(jnp.asarray(s))).astype(np.int64))
    ps, pf = rng.random_float(_t(s))
    js, jf = jax_rng.random_float(jnp.asarray(s))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert pf.dtype == torch.float32 and float(pf.min()) >= 0.0 and float(pf.max()) <= 1.0


def test_f32_to_u32_sat_matches_jax():
    """Saturation at both ends, NaN to 0, truncation toward 0, and the clip's
    upper end f32(2^32 - 1), which is 2^32: JAX's convert gives 2^32 - 1."""
    x = np.array([-5.0, -0.5, 0.0, 0.99, 1.7, 16777217.0, 2.0**31, 4294967040.0, 4294967295.0, 2.0**32, 5e9,
                  np.inf, -np.inf, np.nan], np.float32)
    x = np.concatenate([x, np.random.default_rng(4).uniform(-1e3, 5e9, 3000).astype(np.float32)])
    got = rng.f32_to_u32_sat(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_rng.f32_to_u32_sat(x)).astype(np.int64))
    assert got[9] == 0xFFFFFFFF and got[13] == 0


@pytest.mark.parametrize("start", [0, 2**24 - 1, 2**24 + 5, 3 * 2**20, 2**31 - 1500])
@pytest.mark.parametrize("lamp,global_seed", [((0.3, -0.45, 1.1), 0), ((-2.5, -1.2, -3.75), 3458748736),
                                              ((1.0, 0.8, -0.1), 0xFFFFFFFF)])
def test_photon_seeds_match_jax(start, lamp, global_seed):
    """Thread ids past 2^24 lose precision in f32 and ids past 2^31 wrap in
    int32, in both packages alike; negative lamp coordinates are clipped at
    0 by the saturating convert."""
    want = jax_rng.photon_seeds(3000, np.array(lamp, np.float32), np.uint32(global_seed), start=start)
    got = rng.photon_seeds(3000, lamp, global_seed, start=start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lamp", [(0.3, -0.45, 1.1), (-2.5, -1.2, -3.75), (1.25, 0.3, 0.0)])
def test_advance_global_seed_matches_jax(lamp):
    """A chain of 12 launches, as one iteration of a 12-waypoint route."""
    seed, jseed = 0, np.uint32(0)
    for i in range(12):
        lp = (lamp[0] + 0.1 * i, lamp[1], lamp[2] - 0.2 * i)
        seed = rng.advance_global_seed(lp, seed)
        jseed = np.uint32(jax_rng.advance_global_seed(jnp.asarray(np.array(lp, np.float32)), jnp.uint32(jseed)))
        assert seed == int(jseed)


@pytest.mark.parametrize("global_seed,start,n", [(0, 0, 4096), (123456789, 3 * 2**20, 5000),
                                                 (2**32 - 1, 2**24 - 1, 3000), (77, 2**31 - 1000, 3000),
                                                 (3458748736, 2**31 - 511, 1023), (5, 0, 1)])
def test_generate_reference_matches_jax(global_seed, start, n):
    lamp = (0.3, -0.45, 1.1)
    j = jax_generate.generate_reference(n, np.array(lamp, np.float32), 1.0, global_seed=np.uint32(global_seed),
                                        start=start)
    p = generate_reference(n, lamp, 1.0, global_seed, start)
    assert p.count == n and p.dir.dtype == torch.float32
    np.testing.assert_array_equal(p.orig.numpy(), np.asarray(j.orig))
    np.testing.assert_array_equal(p.dir.numpy(), np.asarray(j.dir))


@pytest.mark.parametrize("seed,gi,n", [(3, 5, 5000), (0, 2**31 + 7, 4096)])
def test_generate_native_matches_jax(seed, gi, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gi)
    lamp = (-1.5, 0.4, 2.0)
    j = jax_generate.generate_native(key, n, np.array(lamp, np.float32), 0.7)
    p = generate_native(np.asarray(jax.random.key_data(key)).astype(np.uint32), n, lamp, 0.7)
    jo, jd = np.asarray(j.orig), np.asarray(j.dir)
    np.testing.assert_array_equal(p.orig.numpy(), jo)
    np.testing.assert_array_equal(p.dir.numpy()[:, 1], jd[:, 1])
    np.testing.assert_allclose(p.dir.numpy(), jd, rtol=0, atol=TWO_ULP_OF_ONE)


LAUNCHES = {  # (sampler, n, bounces): masked tails of 3000 = 2 x 1024 + 952
    "native_tail": ("native", 3000, 0),
    "reference_tail": ("reference", 3000, 0),
    "native_2_bounces": ("native", 2048, 2),
}


@pytest.fixture(scope="module")
def launches():
    """The box room of tests/test_traverse_pallas.py, and JAX's counts of each
    launch with the Pallas kernel in interpret mode."""
    room = make_box_room(subdivisions=6, clutter=3, seed=2)
    jscene = jax_build_pallas_scene(jax_build_clusters(room.tris, cluster_size=128))
    lamp = np.array([0.2, room.floor_height + 0.8, -0.3], np.float32)
    out = {}
    for name, (sampler, n, bounces) in LAUNCHES.items():
        rng_in = jnp.uint32(12345) if sampler == "reference" else jax.random.PRNGKey(5)
        counts = jax_launch_counts(
            jscene, rng_in, jnp.asarray(lamp), jnp.float32(1.0), t_count=room.triangle_count, n=n, chunk=1024,
            sampler=sampler, method="segment", extend_fn=functools.partial(jax_traverse_pallas, interpret=True),
            max_bounces=bounces, normals=jnp.asarray(room.normals) if bounces else None,
            reflectance=jnp.full((room.triangle_count,), 0.5, jnp.float32) if bounces else None)[0]
        out[name] = np.asarray(counts)
    return room, lamp, out


@pytest.mark.parametrize("name", list(LAUNCHES))
def test_launch_counts_in_triangle_space_matches_jax(launches, name):
    room, lamp, jax_counts = launches
    sampler, n, bounces = LAUNCHES[name]
    rng_in = 12345 if sampler == "reference" else rng.PRNGKey(5)
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cpu")
    before = timing.counters()["launches.traverse_pallas_launch"]
    got = launch_counts(scene, rng_in, lamp.tolist(), np.float32(1.0), t_count=room.triangle_count, n=n,
                        chunk=1024, sampler=sampler, extend_fn=tp.traverse_pallas, max_bounces=bounces,
                        normals=torch.from_numpy(room.normals) if bounces else None,
                        reflectance=torch.full((room.triangle_count,), 0.5) if bounces else None)[0].numpy()
    assert timing.counters()["launches.traverse_pallas_launch"] == before  # CPU tensors: the plain version
    want = jax_counts[name]
    assert got.dtype == np.int32 and got.shape == (room.triangle_count,)
    assert np.abs(got.astype(np.int64) - want).sum() <= 2 * (1 + bounces) * (n // 1000)
    if bounces == 0:
        assert got.sum() == n  # a closed room: every photon within n hits once
    else:
        assert got.sum() > n  # bounce deposits on top of the primaries
