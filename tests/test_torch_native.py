"""The port's native SAH builder (uvtrace_torch/bvh/native.py, its copy of
builder.cpp) against uvtrace.bvh.native on the same triangles.

The C++ builder hands out node ids in OpenMP task order, so the JAX
binding's cluster order changes from build to build; every node's range of
tri_idx does not. The port orders clusters by that range's start and fine
BVH nodes level by level, so its builds are identical, and equal to JAX's
as a set of leaves (clusters compared sorted by their first triangle).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from uvtrace.bvh import native as jax_native
from uvtrace.geometry.gltf import load_glb
from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace_torch.bvh import native
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.sim import SimParams, Simulator

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def testroom():
    return load_glb(os.path.join(REPO, "assets", "testroomopt.glb"))


def _by_start(cs):
    """A cluster set's arrays with the clusters in the order of their first
    triangle id (a leaf's triangles are a fixed range of tri_idx)."""
    order = np.argsort(cs.tri_idx[:, 0], kind="stable")
    return cs.tris[order], cs.tri_idx[order], cs.box_min[order], cs.box_max[order]


def test_available_here():
    assert native.available() and jax_native.available()


def test_five_builds_are_identical(testroom):
    builds = [native.build_clusters_native(testroom.tris) for _ in range(5)]
    first = builds[0]
    first.validate(testroom.tris)
    assert first.n_clusters == 525 and first.cluster_size == 128
    for cs in builds[1:]:
        for a, b in ((cs.tris, first.tris), (cs.tri_idx, first.tri_idx), (cs.box_min, first.box_min),
                     (cs.box_max, first.box_max)):
            np.testing.assert_array_equal(a, b)


def test_clusters_equal_jax_as_a_set(testroom):
    port = native.build_clusters_native(testroom.tris)
    ref = jax_native.build_clusters_native(testroom.tris)
    for a, b in zip(_by_start(port), _by_start(ref)):
        np.testing.assert_array_equal(a, b)
    starts = port.tri_idx[:, 0]
    assert len(np.unique(starts)) == port.n_clusters


@pytest.mark.parametrize("max_leaf_size", [4, 8])
def test_fine_bvh_is_deterministic_and_jax_s_tree(testroom, max_leaf_size):
    """build_bvh_native: the same arrays in every build, a valid tree, and
    JAX's nodes and leaf ranges up to the order of node ids."""
    a = native.build_bvh_native(testroom.tris, max_leaf_size=max_leaf_size)
    b = native.build_bvh_native(testroom.tris, max_leaf_size=max_leaf_size)
    a.validate(testroom.tris)
    for name in ("node_min", "node_max", "left_first", "tri_count", "tri_idx", "sorted_tris"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    ref = jax_native.build_bvh_native(testroom.tris, max_leaf_size=max_leaf_size)
    np.testing.assert_array_equal(a.tri_idx, ref.tri_idx)
    assert a.n_nodes == ref.n_nodes and a.max_depth == ref.max_depth

    def leaves(bvh):
        leaf = bvh.tri_count > 0
        rows = np.concatenate([bvh.left_first[leaf, None], bvh.tri_count[leaf, None], bvh.node_min[leaf],
                               bvh.node_max[leaf]], 1)
        return rows[np.lexsort(rows.T[::-1])]

    np.testing.assert_array_equal(leaves(a), leaves(ref))


def test_simulator_clusters_equal_jax_s(monkeypatch):
    """The port's Simulator builds its clusters natively, as the JAX
    Simulator does: the same clusters as a set, in one fixed order."""
    room = make_box_room(subdivisions=6, clutter=4, seed=2)
    ps = Simulator(room, SimParams(photon_count=1024), route=[LightPos(0.0, 0.0, 1.0)], device="cpu")
    js = JaxSimulator(room, JaxSimParams(photon_count=1024, traversal="mxu"), route=[JaxLightPos(0.0, 0.0, 1.0)])
    port = native.build_clusters_native(room.tris)
    for a, b in zip(_by_start(port), _by_start(js.clusters)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ps.scene.tri_idx_flat.numpy(), port.tri_idx.reshape(-1))
    monkeypatch.setattr(native, "available", lambda: False)  # no g++: the numpy builder
    numpy_sim = Simulator(room, SimParams(photon_count=1024), device="cpu")
    from uvtrace_torch.ops.cluster import build_clusters

    np.testing.assert_array_equal(numpy_sim.scene.tri_idx_flat.numpy(),
                                  build_clusters(room.tris, cluster_size=128).tri_idx.reshape(-1))


_BUILD = """
import sys
from pathlib import Path
from uvtrace_torch.bvh import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available()
print(native.build_clusters_native(native.np.random.default_rng(0).random((500, 3, 3), dtype="float32")).n_clusters)
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes that build the library into the same empty directory at
    the same time both load a whole library (a temporary file, then
    os.replace), and leave no temporary file behind."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    assert outs[0][0] == outs[1][0]
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]


def test_unavailable_without_a_compiler(tmp_path, monkeypatch):
    """available() is false when g++ cannot build the library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    native._load.cache_clear()
    try:
        assert not native.available()
    finally:
        native._load.cache_clear()
