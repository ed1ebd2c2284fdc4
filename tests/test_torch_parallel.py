"""Multi-device runs of the port (uvtrace_torch/parallel, Simulator(
device_mesh=), make_diff_scene(device_mesh=)) on four gloo ranks on the CPU,
against the same runs on one device: bit for bit.

Every rank scans its own range of GLOBAL chunk indices and the integer
counts are summed exactly, so the maps of a sharded run equal a one-device
run of the same launches whatever the mesh's factorization (the patterns of
tests/test_parallel.py and tests/test_parallel_texel.py). The sharded
Simulator is also held to the JAX package's sharded Simulator (4 of
conftest's 8 virtual devices) under the rules test_torch_simulator.py and
test_torch_texel.py use between the two packages.

The ranks come from torch.multiprocessing (spawn) and meet through a
file:// store under tmp_path; one spawn runs every case, under a timeout
that kills the ranks. The plain versions' matrix products on the CPU can
round a few entries differently when the BLAS library splits them over
threads (and under load), which moves a few closest hits: the ranks and
the one-device references run on one thread each.
"""

import contextlib
import os
import queue
import time
import traceback
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.sim import SimParams, Simulator, ViewMode

ROUTE = [(0.0, 0.0, 1.0), (1.0, -1.5, 2.0)]
N = 1 << 13  # photons per lamp: 8 chunks of 1024, whole chunks on 4 ranks
DENSITY = 20.0
SPAWN_TIMEOUT = 240  # seconds for a whole spawn, start-up included

# case -> (mesh shape, SimParams fields); (0, 0): a 1-D ray mesh of 4 ranks
CASES = {
    "fused": ((0, 0), dict(max_iterations=2)),
    "split": ((4, 1), dict(traversal="mxu")),
    "pallas": ((4, 1), dict(traversal="pallas", sampler="native")),
    "bounces": ((4, 1), dict(traversal="mxu", max_bounces=2, reflectance=0.5)),
    "native": ((4, 1), dict(traversal="mxu", sampler="native")),
    "reference": ((4, 1), dict(traversal="pallas", sampler="reference", max_iterations=2)),
    "texels_2x2": ((2, 2), dict(traversal="mxu", texel_density=DENSITY)),
    "texels_4x1": ((4, 1), dict(traversal="mxu", texel_density=DENSITY)),
    "texels_1x4": ((1, 4), dict(traversal="pallas", texel_density=DENSITY, max_bounces=1, reflectance=0.5)),
}


def room_mesh():
    return make_box_room(subdivisions=4, clutter=2, seed=5)


def spawn_ranks(fn, world: int, tmp_path, *args, timeout: float = SPAWN_TIMEOUT) -> list:
    """fn(rank, world, *args) on `world` spawned ranks of a gloo process
    group; returns their results by rank. A rank that raises, or a spawn
    that outlives `timeout`, fails the calling test and kills every rank."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp_path / f'store_{fn.__name__}_{os.getpid()}'}"
    procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, init, args, results), daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = [None] * world
    try:
        for _ in procs:
            rank, ok, value = results.get(timeout=max(1.0, deadline - time.monotonic()))
            if not ok:
                pytest.fail(f"rank {rank} failed:\n{value}")
            out[rank] = value
    except queue.Empty:
        pytest.fail(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    return out


@contextlib.contextmanager
def one_thread():
    """torch's CPU operations on one thread, as on the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _rank_main(fn, rank, world, init, args, results):
    import torch.distributed as dist

    from uvtrace_torch.parallel import initialize

    torch.set_num_threads(1)
    try:
        initialize("gloo", init, world, rank)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sim(room, fields, device_mesh=None):
    params = SimParams(**{**dict(photon_count=N * len(ROUTE), max_iterations=1, seed=3), **fields})
    return Simulator(room, params, route=[LightPos(*w) for w in ROUTE], ray_chunk=1024, device_mesh=device_mesh,
                     device="cpu")


def _state(sim) -> dict:
    out = dict(photon_map=sim.photon_map.numpy().copy(), max_photon_map=sim.max_photon_map.numpy().copy(),
               photon_map_size=sim.photon_map_size, launch_n=sim._launch_n, key=np.asarray(sim.key).copy(),
               global_seed=int(sim.global_seed))
    if sim.atlas is not None:
        out.update(tex_counts=sim.full_texel_map(sim.photon_map_tex).numpy(),
                   tex=sim.dosage_map_texels(ViewMode.DOSAGE).numpy(),
                   tex_max=sim.dosage_map_texels(ViewMode.MAX_POWER).numpy(),
                   own_slots=sim.photon_map_tex.shape[0], n_slots=sim.atlas.n_slots)
    return out


def _diff_runs(room, device_mesh):
    """Two optimizer steps of the direct objective and one gradient of the
    one-bounce objective through `make_diff_scene(device_mesh=)`."""
    from uvtrace_torch.diff import make_diff_scene, optimize_route, route_dose
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.ops import rng

    scene = make_diff_scene(room, device_mesh=device_mesh, device="cpu")
    wp0 = np.array([w[:2] for w in ROUTE], np.float32)
    durs0 = np.array([w[2] for w in ROUTE], np.float32)
    rod_y = room.floor_height + 0.8
    res = optimize_route(scene, wp0, durs0, rod_y, 1.0, 50.0, steps=2, n_samples=2)
    wp = torch.tensor(wp0, requires_grad=True)
    durs = torch.tensor(durs0, requires_grad=True)
    dose = route_dose(scene, wp, durs, rod_y, 1.0, 50.0, rng.PRNGKey(4), n_samples=2,
                      reflectance=np.full(room.triangle_count, 0.4, np.float32),
                      areas=room.areas, n_sources=16)
    loss = softmin(dose, 5.0)
    g_wp, g_durs = torch.autograd.grad(loss, (wp, durs))
    return dict(history=np.array(res.history), waypoints=res.waypoints_xz, durations=res.durations,
                bounce_loss=loss.item(), g_wp=g_wp.numpy(), g_durs=g_durs.numpy())


def run_cases(mesh_of) -> dict:
    """Every case on the meshes that mesh_of(shape) gives (None: one device)."""
    room = room_mesh()
    out = {}
    for name, (shape, fields) in CASES.items():
        sim = _sim(room, fields, mesh_of(shape))
        sim.compute()
        out[name] = _state(sim)
    grid_sim = _sim(room, CASES["texels_2x2"][1], mesh_of((2, 2)))
    grid_sim.compute()
    out["grid"] = {t: grid_sim.dose_grid(res=40, texels=t) for t in (True, False)}
    out["calibrate"] = grid_sim.calibrate_power(2909.0, 0.8, 0.5)
    out["diff"] = _diff_runs(room, mesh_of((0, 0)))
    return out


def _four_rank_cases(rank, world):
    from uvtrace_torch.parallel import initialize, make_2d_mesh, make_ray_mesh, process_info

    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_ray_mesh() if shape == (0, 0) else make_2d_mesh(*shape)
        return meshes[shape]

    out = run_cases(mesh_of)
    initialize("gloo")  # a second initialization is a no-op
    out["info"] = process_info()
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    t0 = time.perf_counter()
    out = spawn_ranks(_four_rank_cases, 4, tmp_path_factory.mktemp("ranks"))
    out[0]["seconds"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def single():
    with one_thread():
        return run_cases(lambda shape: None)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_run_is_bit_identical_to_one_device(sharded, single, case):
    """Every rank ends with the one-device maps, photon count, key and seed
    (the texel maps gathered from the ranks' slot ranges)."""
    want = single[case]
    assert want["photon_map"].sum() > 0
    for rank_out in sharded:
        got = dict(rank_out[case])
        own = got.pop("own_slots", None)
        want_cmp = {k: v for k, v in want.items() if k != "own_slots"}
        _assert_same(got, want_cmp, case)
        if own is not None:  # each rank keeps n_texels / texel_shards slots
            tex_shards = CASES[case][0][1]
            assert own == -(-want["n_slots"] // tex_shards)


def test_texel_slots_are_sharded(sharded):
    """On 1x4 each rank holds a quarter of the (padded) slots; on 4x1 all."""
    n_slots = sharded[0]["texels_1x4"]["n_slots"]
    assert sharded[0]["texels_1x4"]["own_slots"] == -(-n_slots // 4) < n_slots
    assert sharded[0]["texels_4x1"]["own_slots"] == n_slots


def test_factorizations_agree(sharded):
    """2x2, 4x1 and 1x4 give the same per-triangle maps of the same photons
    (the 1x4 case runs another traversal and one bounce, so it is held to
    its own one-device run above)."""
    for rank_out in sharded:
        _assert_same(rank_out["texels_2x2"]["photon_map"], rank_out["texels_4x1"]["photon_map"])
        _assert_same(rank_out["texels_2x2"]["tex"], rank_out["texels_4x1"]["tex"])


@pytest.mark.parametrize("texels", [True, False])
def test_sharded_dose_grid(sharded, single, texels):
    """dose_grid on a 2x2 mesh (probes padded to 1024 x 2, each ray rank
    traces its slice): every rank gets the one-device image, in both views."""
    want = single["grid"][texels]
    assert want.shape == (40, 40) and (want > 0).mean() > 0.3
    for rank_out in sharded:
        np.testing.assert_array_equal(rank_out["grid"][texels], want)


def test_sharded_calibration(sharded, single):
    """calibrate_power on a 2x2 session flattens to a 4-rank ray mesh; every
    rank stops after the same launch with the one-device wattage."""
    assert np.isfinite(single["calibrate"]) and single["calibrate"] > 0
    assert {r["calibrate"] for r in sharded} == {single["calibrate"]}


@pytest.mark.parametrize("what", ["history", "waypoints", "durations", "bounce_loss", "g_wp", "g_durs"])
def test_sharded_diff_scene(sharded, single, what):
    """make_diff_scene(device_mesh=) on a 4-rank ray mesh: two optimizer
    steps (losses, waypoints, durations) and the one-bounce gradient equal
    the one-device scene's."""
    want = single["diff"][what]
    assert np.isfinite(want).all() and np.any(np.asarray(want) != 0)
    for rank_out in sharded:
        np.testing.assert_array_equal(rank_out["diff"][what], want)


def test_process_info(sharded):
    assert [r["info"]["rank"] for r in sharded] == [0, 1, 2, 3]
    assert {r["info"]["world_size"] for r in sharded} == {4}


def test_spawn_time(sharded):
    """The four ranks finish well inside the spawn's timeout."""
    assert sharded[0]["seconds"] < SPAWN_TIMEOUT / 2


def test_mesh_shape_and_argument_checks():
    """The JAX module's errors: axis names, whole chunks per device, a texel
    axis without texels (no process group needed to check arguments)."""
    from uvtrace_torch.parallel import mesh_shape, sharded_launch_fn

    def fake(names, sizes):
        return types.SimpleNamespace(mesh_dim_names=names, size=lambda i: sizes[i])

    assert mesh_shape(fake(("rays",), (4,))) == (4, 1)
    assert mesh_shape(fake(("rays", "texels"), (2, 2))) == (2, 2)
    with pytest.raises(ValueError, match="axis names"):
        mesh_shape(fake(("data",), (4,)))
    kw = dict(t_count=10, chunk=1024, sampler="stratified", extend_fn=None)
    with pytest.raises(ValueError, match="multiple of n_devices"):
        sharded_launch_fn(fake(("rays",), (4,)), n_total=3 * 1024, **kw)
    with pytest.raises(ValueError, match="n_texels"):
        sharded_launch_fn(fake(("rays", "texels"), (2, 2)), n_total=4 * 1024, n_texels=3, **kw)
    room = room_mesh()
    with pytest.raises(ValueError, match="texel_density"):
        _sim(room, {}, fake(("rays", "texels"), (2, 2)))


@pytest.mark.parametrize("case", ["fused", "texels_2x2"])
def test_sharded_simulator_matches_jax(sharded, case):
    """The JAX sharded Simulator on 4 of conftest's 8 virtual devices (a
    1-D ray mesh through "mxu-fused", or a 2x2 rays x texels mesh through
    "mxu", precision "highest") against rank 0 of the port's run: the same
    photons, so the per-triangle maps differ only by rays whose closest hit
    flips (at most 2 x duration per flip, flips at most 0.1% of the rays,
    test_torch_simulator.py) and the texel counts by at most 0.2% of the
    duration-weighted hits (test_torch_texel.py)."""
    import jax

    from uvtrace.io.routexml import LightPos as JaxLightPos
    from uvtrace.parallel import make_2d_mesh as jax_make_2d_mesh
    from uvtrace.parallel import make_ray_mesh as jax_make_ray_mesh
    from uvtrace.sim import SimParams as JaxSimParams
    from uvtrace.sim import Simulator as JaxSimulator

    shape, fields = CASES[case]
    traversal = fields.get("traversal", "mxu-fused")
    devices = jax.devices()[:4]
    mesh = (jax_make_ray_mesh(devices=devices) if shape == (0, 0)
            else jax_make_2d_mesh(*shape, devices=devices))
    params = JaxSimParams(**{**dict(photon_count=N * len(ROUTE), max_iterations=1, seed=3), **fields,
                             "traversal": traversal, "precision": "highest"})
    js = JaxSimulator(room_mesh(), params, route=[JaxLightPos(*w) for w in ROUTE], ray_chunk=1024,
                      device_mesh=mesh)
    js.compute()
    got = sharded[0][case]
    assert got["photon_map_size"] == js.photon_map_size and got["launch_n"] == js._launch_n
    np.testing.assert_array_equal(got["key"], np.asarray(jax.random.key_data(js.key)).astype(np.uint32))
    jmap = np.asarray(js.photon_map)
    flips = 2 * max(w[2] for w in ROUTE) * 1e-3 * js.photon_map_size
    assert np.abs(got["photon_map"] - jmap).sum() <= flips
    assert (got["photon_map"] == jmap).mean() > 0.9
    if "tex_counts" in got:
        jtex = np.asarray(js.photon_map_tex)[: got["n_slots"]]
        assert np.abs(got["tex_counts"] - jtex).sum() / 2 <= 2e-3 * jmap.sum()
        assert jtex.sum() == jmap.sum() == got["tex_counts"].sum()
