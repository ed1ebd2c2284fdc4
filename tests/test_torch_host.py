"""The port's host-side numpy copies equal the JAX package's originals, and
the port imports no JAX.

uvtrace_torch carries its own copies of the glTF loader, the procedural room,
the SAH cluster and BVH builders, the gen-1 kernel's scene layout, the route
XML and SimParams, because any
`import uvtrace.*` imports jax (uvtrace/__init__.py -> uvtrace.sim ->
Simulator), which the machine with the card does not have. These tests hold
each copy equal to its original on the same inputs.
"""

import dataclasses
import os
import subprocess
import sys

import jax  # noqa: F401  (pins the JAX side of the comparison to the CPU via conftest)
import numpy as np
import pytest
import torch

from uvtrace.bvh import builder as jax_builder
from uvtrace.geometry.gltf import load_glb as jax_load_glb
from uvtrace.geometry.procedural import make_box_room as jax_box_room
from uvtrace.io import routexml as jax_routexml
from uvtrace.ops.cluster import build_clusters as jax_build_clusters
from uvtrace.ops.generate import _stratum_grid as jax_stratum_grid
from uvtrace.ops.traverse_mxu import build_mxu_scene as jax_build_mxu_scene
from uvtrace.ops.traverse_pallas import build_pallas_scene as jax_build_pallas_scene
from uvtrace.sim.params import SimParams as JaxSimParams
from uvtrace_torch.bvh import builder as pt_builder
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io import routexml
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.generate import _stratum_grid
from uvtrace_torch.ops.traverse_mxu import build_mxu_scene, scene_from_numpy
from uvtrace_torch.ops.traverse_pallas import build_pallas_scene
from uvtrace_torch.sim.params import SimParams

REPO = os.path.join(os.path.dirname(__file__), "..")
TESTROOM = os.path.join(REPO, "assets", "testroomopt.glb")


@pytest.fixture(scope="module")
def testroom_pair():
    return jax_load_glb(TESTROOM), load_glb(TESTROOM)


def test_load_glb_equal(testroom_pair):
    ref, port = testroom_pair
    np.testing.assert_array_equal(port.tris, ref.tris)
    np.testing.assert_array_equal(port.uvs, ref.uvs)
    np.testing.assert_array_equal(port.areas, ref.areas)
    np.testing.assert_array_equal(port.normals, ref.normals)
    assert port.floor_height == ref.floor_height
    assert port.triangle_count == ref.triangle_count == 44866
    assert port.name == ref.name


@pytest.mark.parametrize("subdivisions,clutter,seed", [(1, 0, 0), (4, 2, 5), (6, 3, 1)])
def test_make_box_room_equal(subdivisions, clutter, seed):
    ref = jax_box_room(subdivisions=subdivisions, clutter=clutter, seed=seed)
    port = make_box_room(subdivisions=subdivisions, clutter=clutter, seed=seed)
    np.testing.assert_array_equal(port.tris, ref.tris)
    assert port.floor_height == ref.floor_height and port.name == ref.name


def test_sah_best_split_equal():
    rng = np.random.default_rng(7)
    assert pt_builder.BINS == jax_builder.BINS
    for n in (2, 17, 300):
        c = rng.normal(size=(n, 3))
        vmin, vmax = c - rng.uniform(0, 0.3, (n, 3)), c + rng.uniform(0, 0.3, (n, 3))
        args = (c.min(0), c.max(0), c, vmin, vmax)
        assert pt_builder._sah_best_split(*args) == jax_builder._sah_best_split(*args)


@pytest.mark.parametrize("scene,cluster_size", [("box", 64), ("box", 128), ("testroom", 128)])
def test_build_clusters_and_mxu_scene_equal(scene, cluster_size, testroom_pair):
    if scene == "testroom":
        tris = testroom_pair[0].tris
    else:
        tris = jax_box_room(subdivisions=4, clutter=2, seed=5).tris
    ref = jax_build_clusters(tris, cluster_size=cluster_size)
    port = build_clusters(tris, cluster_size=cluster_size)
    for f in ("tris", "box_min", "box_max", "tri_idx"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    jscene = jax_build_mxu_scene(ref)
    pscene = build_mxu_scene(port, device="cpu")
    np.testing.assert_array_equal(pscene.boxes.numpy(), np.asarray(jscene.boxes))
    np.testing.assert_array_equal(pscene.feat.numpy(), np.asarray(jscene.feat))
    np.testing.assert_array_equal(pscene.tri_idx_flat.numpy(), np.asarray(jscene.tri_idx_flat))
    # the kernel's repacked copies are the same numbers in another layout
    np.testing.assert_array_equal(pscene.feat10.numpy(), np.asarray(jscene.feat)[:, :10])
    np.testing.assert_array_equal(pscene.box6.numpy()[:, :3], port.box_min)
    np.testing.assert_array_equal(pscene.box6.numpy()[:, 3:], port.box_max)
    again = scene_from_numpy(np.asarray(jscene.boxes), np.asarray(jscene.feat),
                             np.asarray(jscene.tri_idx_flat), device="cpu")
    # the split kernel's walk tree: sub-trees over the clusters' triangles
    # from the clusters' vertices, one leaf a cluster from the arrays alone;
    # the same real slots either way
    walk = ("walk_box", "walk_meta", "leaf_feat", "leaf_slot", "walk_depth")
    for name, a, b in zip(pscene._fields, again, pscene):
        if name not in walk:
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name
    assert torch.equal(again.leaf_slot.sort().values, pscene.leaf_slot.sort().values)
    assert torch.equal(again.walk_box[:pscene.node_box.numel()], pscene.walk_box[:pscene.node_box.numel()])


def _assert_bvh_equal(port, ref):
    for f in ("node_min", "node_max", "left_first", "tri_count", "tri_idx", "sorted_tris"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.max_depth == ref.max_depth and port.n_nodes == ref.n_nodes


@pytest.mark.parametrize("tris,max_leaf_size", [("random", None), ("random", 1), ("box", None), ("box", 4),
                                                ("testroom_clusters", 1)])
def test_build_bvh_equal(tris, max_leaf_size, testroom_pair):
    """Node arrays equal on random triangles, on the box room, and on
    testroomopt's cluster AABBs as the gen-1 top tree encodes them."""
    if tris == "random":
        g = np.random.default_rng(11)
        tris = (g.normal(size=(300, 1, 3)) + 0.2 * g.normal(size=(300, 3, 3))).astype(np.float32)
    elif tris == "box":
        tris = jax_box_room(subdivisions=4, clutter=2, seed=5).tris
    else:
        cs = build_clusters(testroom_pair[1].tris, cluster_size=128)
        tris = np.stack([cs.box_min, cs.box_max, 0.5 * (cs.box_min + cs.box_max)], axis=1).astype(np.float32)
    port = pt_builder.build_bvh(tris, max_leaf_size=max_leaf_size)
    _assert_bvh_equal(port, jax_builder.build_bvh(tris, max_leaf_size=max_leaf_size))
    port.validate(tris)
    if max_leaf_size:
        assert port.max_leaf_size <= max_leaf_size
    _assert_bvh_equal(pt_builder.single_leaf_bvh(tris), jax_builder.single_leaf_bvh(tris))


@pytest.mark.parametrize("scene", ["box_4_clusters", "testroom"])
def test_build_pallas_scene_equal(scene, testroom_pair):
    """The gen-1 kernel's scene arrays, array for array, from the same
    clusters (the numpy cluster builder on both sides)."""
    if scene == "testroom":
        tris = testroom_pair[0].tris
    else:
        tris = jax_box_room(subdivisions=6, clutter=3, seed=2).tris
    ref = jax_build_pallas_scene(jax_build_clusters(tris, cluster_size=128))
    port = build_pallas_scene(build_clusters(tris, cluster_size=128), device="cpu")
    for f in ("node_box", "node_meta", "tri", "tri_idx_flat", "box_min", "box_max"):
        a, b = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if scene == "testroom":
        assert port.n_clusters == 525 and port.node_meta.shape[0] // 2 == 1049 and port.depth == 13
    else:
        assert port.n_clusters == 4


@pytest.mark.parametrize("builder", ["build_mxu_scene", "build_pallas_scene", "scene_from_numpy"])
def test_scene_builders_default_to_cuda_and_raise_without_a_card(builder, monkeypatch):
    """The public scene builders default to the card, as the Simulator does:
    without one they raise instead of handing the trace functions CPU
    tensors (which would run the plain versions unannounced)."""
    cs = build_clusters(make_box_room(subdivisions=2, clutter=1, seed=4).tris, cluster_size=128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"build_mxu_scene": lambda: build_mxu_scene(cs), "build_pallas_scene": lambda: build_pallas_scene(cs),
            "scene_from_numpy": lambda: scene_from_numpy(*_scene_arrays(cs))}[builder]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert build_mxu_scene(cs, device="cpu").feat.device.type == "cpu"  # device="cpu" asks for the CPU


def _scene_arrays(cs):
    """(boxes, feat, tri_idx_flat) of the port's CPU scene: scene_from_numpy's inputs."""
    s = build_mxu_scene(cs, device="cpu")
    return s.boxes.numpy(), s.feat.numpy(), s.tri_idx_flat.numpy()


def test_route_xml_roundtrip(tmp_path):
    path = os.path.join(REPO, "assets", "route.xml")
    ref, port = jax_routexml.load_route_xml(path), routexml.load_route_xml(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert len(port.waypoints) == 12
    routexml.save_route_xml(tmp_path / "r.xml", port)
    assert dataclasses.asdict(jax_routexml.load_route_xml(tmp_path / "r.xml")) == dataclasses.asdict(ref)
    assert port.apply_to(SimParams()) == SimParams(**dataclasses.asdict(ref.apply_to(JaxSimParams())))


def test_simparams_defaults_equal():
    assert dataclasses.asdict(SimParams()) == dataclasses.asdict(JaxSimParams())
    assert SimParams().photon_count == 1 << 25 and SimParams().precision == "high"
    for k in (1, 3, 12, 7):
        assert SimParams().photons_per_light(k) == JaxSimParams().photons_per_light(k)


def test_stratum_grid_equal():
    for g in list(range(1, 300)) + [1024, 3072, 4096, 1 << 14]:
        for hb in (1, 2, 4):
            assert _stratum_grid(g, height_bands=hb) == jax_stratum_grid(g, height_bands=hb)


_BLOCK_JAX = """
import importlib.abc, pkgutil, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "uvtrace"):
            raise ImportError("blocked import of " + name)
sys.meta_path.insert(0, _Block())
import uvtrace_torch
for m in pkgutil.walk_packages(uvtrace_torch.__path__, "uvtrace_torch."):
    __import__(m.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "uvtrace")]
assert not bad, bad
from uvtrace_torch import cli
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.gltf_export import export_glb
out = sys.argv[2]
export_glb(out + "/room.glb", make_box_room(subdivisions=2, clutter=1, seed=4).tris)
assert cli.main(["compute", out + "/room.glb", "--photon-count", "2048", "--iterations", "1", "--texel-density",
                 "64", "--export-glb", "--checkpoint", "--dose-grid", "8", "--output", out + "/o",
                 "--device", "cpu"]) == 0
assert cli.main(["render", out + "/room.glb", "--checkpoint", out + "/o/checkpoint.npz", "--output",
                 out + "/r.png", "--device", "cpu"]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "uvtrace")]
assert not bad, bad
sys.argv = ["uvtrace_torch", "info", sys.argv[1]]
runpy.run_module("uvtrace_torch", run_name="__main__")
"""


def test_port_imports_no_jax(tmp_path):
    """Every uvtrace_torch module and chip_smoke.py import, a tiny texel
    `compute --export-glb --checkpoint` and a `render` of its checkpoint
    run, and `python -m uvtrace_torch info` runs, with jax and uvtrace
    blocked by an import hook (so no function-level import of the
    reference hides in the new command paths)."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX, TESTROOM, str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "triangles: 44866" in proc.stdout
    for name in ("dose_texels.png", "dose_texels.glb", "dose.glb", "checkpoint.npz", "texel_atlas.npz"):
        assert (tmp_path / "o" / name).stat().st_size > 100, name
    assert (tmp_path / "o" / "dose_grid.png").exists()
    assert (tmp_path / "r.png").stat().st_size > 100


def test_kernel_build_digest_covers_headers(tmp_path):
    """The library's name is a digest of every .cu and .cuh file: an edit to a
    shared header rebuilds, instead of loading a stale library."""
    from uvtrace_torch import _build

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int K = 10;\n")
    (tmp_path / "notes.txt").write_text("not a source")
    first = _build.source_digest(tmp_path)
    (tmp_path / "notes.txt").write_text("still not a source")
    assert _build.source_digest(tmp_path) == first
    (tmp_path / "common.cuh").write_text("constexpr int K = 11;\n")
    second = _build.source_digest(tmp_path)
    assert second != first
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.source_digest(tmp_path) not in (first, second)
    assert len(_build.source_digest()) == 16  # the package's own csrc/


@pytest.mark.parametrize("module", ["io/png.py", "io/jpeg.py", "io/gltf_export.py", "viz/camera.py", "i18n.py",
                                    "geometry/mesh.py", "geometry/gltf.py", "bvh/cpp/builder.cpp"])
def test_numpy_copies_are_the_reference_code(module):
    """The port's copies of uvtrace's modules that import no JAX are the
    same code: equal to the original but for the module docstring and the
    package name in imports. The native builder's C++ source is a
    byte-identical copy."""
    import ast

    if module.endswith(".cpp"):
        with open(os.path.join(REPO, "uvtrace_torch", module), "rb") as port, \
                open(os.path.join(REPO, "uvtrace", module), "rb") as ref:
            assert port.read() == ref.read()
        return

    def body(path):
        tree = ast.parse(open(path).read())
        if ast.get_docstring(tree) is not None:
            tree.body = tree.body[1:]
        return ast.dump(tree).replace("uvtrace_torch", "uvtrace")

    assert body(os.path.join(REPO, "uvtrace_torch", module)) == body(os.path.join(REPO, "uvtrace", module))
