"""Texel dose maps sharded over a rays x texels mesh of two gloo ranks on the
CPU (BASELINE config 5's layout at 1x2 and 2x1), and checkpoints across
topologies: a run saved on 1x2 resumes on one device, and a one-device
checkpoint resumes on 1x2, both bit-identical to a straight one-device run
(uvtrace/io/checkpoint.py:24-45,108-135: the real slots are saved, and the
resuming Simulator re-pads them for its own texel shards).
"""

import numpy as np
import pytest

from test_torch_parallel import one_thread, spawn_ranks
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.checkpoint import load_checkpoint, save_checkpoint
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.sim import SimParams, Simulator, ViewMode

N = 1 << 13  # photons per lamp: 8 chunks of 1024
DENSITY = 25.0  # 116,104 slots on this room (the 1x4 case of test_torch_parallel.py pads its slots)


def _room():
    return make_box_room(subdivisions=3, clutter=2, seed=7)


def _sim(iterations: int, device_mesh=None) -> Simulator:
    params = SimParams(photon_count=N, max_iterations=iterations, seed=11, texel_density=DENSITY,
                       traversal="mxu", max_bounces=1, reflectance=0.5)
    return Simulator(_room(), params, route=[LightPos(0.3, -0.2, 1.5)], ray_chunk=1024, device_mesh=device_mesh,
                     device="cpu")


def _maps(sim) -> dict:
    return dict(photon_map=sim.photon_map.numpy().copy(), max_photon_map=sim.max_photon_map.numpy().copy(),
                tex=sim.full_texel_map(sim.photon_map_tex).numpy(),
                tex_max=sim.full_texel_map(sim.max_photon_map_tex).numpy(),
                dose_tex=sim.dosage_map_texels(ViewMode.MAX_POWER).numpy(), photon_map_size=sim.photon_map_size,
                key=np.asarray(sim.key).copy(), own_slots=sim.photon_map_tex.shape[0])


def _two_rank_cases(rank, world, tmp):
    from uvtrace_torch.parallel import make_2d_mesh

    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_2d_mesh(*shape)
        sim = _sim(2, mesh)
        sim.compute()
        out[shape] = _maps(sim)
        out[shape, "grid"] = sim.dose_grid(res=24)
        if shape == (1, 2):
            half = _sim(1, mesh)
            half.compute()
            save_checkpoint(f"{tmp}/saved_1x2.npz", half)  # rank 0 writes
            resumed = _sim(1, mesh)
            load_checkpoint(f"{tmp}/saved_1x1.npz", resumed)
            resumed.resume(extra_iterations=1)
            out["resumed_on_1x2"] = _maps(resumed)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("texel_ranks")
    with one_thread():  # as on the ranks (test_torch_parallel.py)
        straight = _sim(2)
        straight.compute()
        half = _sim(1)
        half.compute()
        save_checkpoint(tmp / "saved_1x1.npz", half)
        sharded = spawn_ranks(_two_rank_cases, 2, tmp, str(tmp))
        resumed = _sim(1)
        load_checkpoint(tmp / "saved_1x2.npz", resumed)
        resumed.resume(extra_iterations=1)
        return dict(straight=_maps(straight), grid=straight.dose_grid(res=24), sharded=sharded, tmp=tmp,
                    resumed_on_1x1=_maps(resumed), n_slots=straight.atlas.n_slots)


def _assert_maps_equal(got: dict, want: dict):
    for k in want:
        if k != "own_slots":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_texel_maps_bit_identical_on_two_ranks(runs, shape):
    want = runs["straight"]
    assert want["tex"].sum() == want["photon_map"].sum() > 0
    for rank_out in runs["sharded"]:
        _assert_maps_equal(rank_out[shape], want)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_each_rank_keeps_its_slot_range(runs, shape):
    """1x2: half the slots per rank; 2x1: all of them."""
    n_slots = runs["n_slots"]
    want = n_slots // 2 if shape == (1, 2) else n_slots
    assert all(r[shape]["own_slots"] == want for r in runs["sharded"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_sharded_texel_dose_grid(runs, shape):
    for rank_out in runs["sharded"]:
        np.testing.assert_array_equal(rank_out[shape, "grid"], runs["grid"])


def test_checkpoint_saved_on_1x2_resumes_on_one_device(runs):
    saved = np.load(runs["tmp"] / "saved_1x2.npz")
    assert saved["photon_map_tex"].shape == (runs["n_slots"],)  # the real slots, gathered
    _assert_maps_equal(runs["resumed_on_1x1"], runs["straight"])


def test_checkpoint_saved_on_one_device_resumes_on_1x2(runs):
    for rank_out in runs["sharded"]:
        _assert_maps_equal(rank_out["resumed_on_1x2"], runs["straight"])
        assert rank_out["resumed_on_1x2"]["own_slots"] == runs["n_slots"] // 2
