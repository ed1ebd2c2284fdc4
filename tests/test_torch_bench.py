"""The port's benchmark (uvtrace_torch/bench.py) against the JAX package's
bench.py, on the CPU.

The headline's counts on a small box room come from the port's pipeline for
each backend (on the CPU the kernels' plain versions) and from the JAX
pipeline built here out of the functions bench.py:87-112 calls, with the
same keys fold_in(PRNGKey(0), i), the same lamp and the same numpy clusters;
the JAX kernels run in interpret mode at precision "highest" (f32), as the
JAX package's own tests run them on the CPU. Tolerances, with their reasons:
  - the clustered backend is the same arithmetic on the same rays: its
    counts are equal;
  - the kernel backends may flip a hit on a tie or an edge, where the f32
    sums run in another order, or where generate_stratified's dir.x/z differ
    from XLA-CPU's by up to 2 ulp (cos/sin): at most 0.1% of the rays, each
    moving two triangle counts by one, so the per-triangle |diff| is at most
    2 x ceil(rays / 1000).
The rest holds the port's flags, JSON keys, pin gate and multi-device rows
to bench.py's.
"""

import json
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uvtrace.geometry.procedural import make_box_room
from uvtrace.ops import accumulate as jax_acc
from uvtrace.ops import generate as jax_gen
from uvtrace.ops.cluster import build_clusters
from uvtrace_torch import bench
from uvtrace_torch import cli

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import bench as jax_bench  # noqa: E402  the repo root's module

N, ITERS = 4096, 2
JAX_BENCH_SRC = open(os.path.join(ROOT, "bench.py")).read()
# bench.py:282-289
SCALING_KEYS = {"devices", "rays_per_sec", "rays_per_sec_per_device", "efficiency", "backend", "platform"}


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=6, clutter=4, seed=2)


@pytest.fixture
def bench_env(monkeypatch):
    """No UVTRACE_BENCH_* variable but those a test sets."""
    for k in ("BACKEND", "RAYS", "ITERS", "PRECISION"):
        monkeypatch.delenv(f"UVTRACE_BENCH_{k}", raising=False)
    return monkeypatch


def _jax_headline_counts(room, backend: str) -> np.ndarray:
    """bench.py's one_iter summed over ITERS launches, then slots_to_tri."""
    cs = build_clusters(room.tris, cluster_size=128)
    lamp = jnp.array([0.0, room.floor_height + 0.8, 0.0], jnp.float32)
    t_count = room.triangle_count
    if backend in ("mxu", "mxu-fused"):
        from uvtrace.ops.traverse_mxu import build_mxu_scene, fused_trace_counts, traverse_mxu_counts

        scene = build_mxu_scene(cs)
    elif backend == "pallas":
        from uvtrace.ops.traverse_pallas import build_pallas_scene, traverse_pallas

        scene = build_pallas_scene(cs)
    else:
        from uvtrace.ops.traverse_clustered import cluster_arrays, traverse_clustered

        scene = cluster_arrays(cs)
    total = 0
    for i in range(ITERS):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        if backend == "mxu-fused":
            counts = fused_trace_counts(scene, key, lamp, 1.0, N, interpret=True, precision="highest")[2]
        else:
            rays = jax_gen.generate_stratified(key, N, lamp, 1.0, packet=1024)
            if backend == "mxu":
                counts = traverse_mxu_counts(scene, rays.orig, rays.dir, interpret=True, precision="highest")[2]
            elif backend == "pallas":
                hit = traverse_pallas(scene, rays.orig, rays.dir, interpret=True)[1]
                counts = jax_acc.hit_counts(hit, t_count, "segment")
            else:
                hit = traverse_clustered(scene, rays.orig, rays.dir, max_clusters=bench.CLUSTERED_BUDGET)[1]
                counts = jax_acc.hit_counts(hit, t_count, "segment")
        total = total + counts
    if backend in ("mxu", "mxu-fused"):
        total = jax_acc.slots_to_tri(total, scene.tri_idx_flat, t_count)
    return np.asarray(total)


@pytest.mark.parametrize("backend", bench.BACKENDS)
def test_headline_counts_match_jax(room, backend):
    counts, dose, overflow = bench.headline_pipeline(room, backend, N, device="cpu")(ITERS)
    got, want = counts.numpy().astype(np.int64), _jax_headline_counts(room, backend).astype(np.int64)
    assert got.shape == want.shape == (room.triangle_count,)
    if backend == "clustered":
        np.testing.assert_array_equal(got, want)
        assert int(overflow) >= 0
    else:
        assert overflow is None
        assert np.abs(got - want).sum() <= 2 * math.ceil(N * ITERS / 1000)
    areas = np.asarray(room.areas, np.float32)
    np.testing.assert_allclose(dose.numpy(), got.astype(np.float32) * 45.0 / (areas * (N * ITERS)), rtol=1e-6)


def test_pins_are_bench_pys():
    """The four pins and the tolerance are bench.py:146-164's."""
    pins = {(k == "True", int(i)): int(v.replace("_", ""))
            for k, i, v in re.findall(r"\((True|False), (5|20)\): ([\d_]+)", JAX_BENCH_SRC)}
    assert pins == bench.PINNED_TOTALS
    assert "tol = 64 * (iters // 5)" in JAX_BENCH_SRC and bench.PIN_TOLERANCE == 64


@pytest.mark.parametrize("fused,iters", sorted(bench.PINNED_TOTALS))
def test_pin_gate(fused, iters):
    pin, tol = bench.PINNED_TOTALS[(fused, iters)], 64 * iters // 5
    for total in (pin - tol, pin, pin + tol):
        assert bench.check_pinned_total(total, fused, iters) == (pin, tol)
    for total in (pin - tol - 1, pin + tol + 1, 0):
        with pytest.raises(RuntimeError, match="invariant violated"):
            bench.check_pinned_total(total, fused, iters)


def test_main_gates_its_total(room, bench_env, capsys):
    """main() holds its total to the pin where bench.py would (the scene,
    the rays and the iterations of a pin, no UVTRACE_BENCH_PRECISION): here
    the small room stands in for testroomopt."""
    bench_env.setenv("UVTRACE_BENCH_RAYS", "2048")
    bench_env.setenv("UVTRACE_BENCH_ITERS", "5")
    bench_env.setattr(bench, "PIN_TRIANGLES", room.triangle_count)
    bench_env.setattr(bench, "PIN_RAYS", 2048)
    total = 5 * 2048  # a closed room: every ray hits
    bench_env.setitem(bench.PINNED_TOTALS, (True, 5), total + 64)
    assert bench.main(device="cpu", scene_mesh=room)["hit_total"] == total
    bench_env.setitem(bench.PINNED_TOTALS, (True, 5), total + 65)
    with pytest.raises(RuntimeError, match="invariant violated"):
        bench.main(device="cpu", scene_mesh=room)
    bench_env.setenv("UVTRACE_BENCH_PRECISION", "high")  # bench.py turns the gate off then
    assert bench.main(device="cpu", scene_mesh=room)["hit_total"] == total
    capsys.readouterr()


def test_headline_json_line(room, bench_env, capsys):
    bench_env.setenv("UVTRACE_BENCH_RAYS", "2048")
    bench_env.setenv("UVTRACE_BENCH_ITERS", "1")
    bench_env.setenv("UVTRACE_BENCH_BACKEND", "clustered")
    row = bench.main(device="cpu", scene_mesh=room)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == row
    assert {"metric", "value", "unit", "vs_baseline"} <= row.keys()
    assert f'"metric": "{row["metric"]}"' in JAX_BENCH_SRC
    assert row["unit"] == "rays/s" and row["value"] > 0
    assert row["vs_baseline"] == round(row["value"] / jax_bench.REQUIREMENT_RAYS_PER_SEC, 3)
    assert bench.REQUIREMENT_RAYS_PER_SEC == jax_bench.REQUIREMENT_RAYS_PER_SEC
    assert (row["device"], row["backend"], row["overflow"]) == ("cpu", "clustered", 0)


def test_unknown_backend_raises(room):
    with pytest.raises(ValueError, match="backend must be one of"):
        bench.headline_pipeline(room, "mxu-fast", N, device="cpu")


@pytest.mark.parametrize("argv", [
    [],
    ["--scaling", "--devices", "1", "2", "--iters", "1"],
    ["--bounce", "--rays", "4096", "--iters", "2", "--platform", "cpu"],
    ["--scaling", "--devices", "--rays", "8"],
])
def test_parse_args_matches_bench_py(argv):
    port, ref = vars(bench.parse_args(argv)), vars(jax_bench.parse_args(argv))
    assert port.keys() == ref.keys()
    # --platform: the port's cuda is bench.py's tpu, and is the default
    assert port.pop("platform") == (ref.pop("platform") or "cuda")
    assert port == ref


def test_bounce_row(room):
    row = bench.bounce_row(n=4096, iters=1, scene_mesh=room, device="cpu")
    assert row["segments_per_photon"] == 5
    assert row["value"] > 0 and row["unit"] == "rays/s" and row["device"] == "cpu"
    assert json.loads(json.dumps(row)) == row


def test_scaling_rows_on_gloo_ranks(room):
    rows = bench.scaling_rows(device_counts=[1, 2], rays_per_device=2048, iters=1, scene_mesh=room, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert SCALING_KEYS <= r.keys() and json.loads(json.dumps(r)) == r
        assert r["rays_per_sec"] > 0 and r["efficiency"] > 0 and r["platform"] == "cpu"
    assert rows[0]["efficiency"] == 1.0


def test_scaling_refuses_more_devices_than_exist():
    with pytest.raises(SystemExit, match="9 devices requested, 8 visible"):
        bench.scaling_rows(device_counts=[9], device="cpu")


def test_cli_bench_bounce_prints_one_json_line(room, monkeypatch, capsys):
    """`python -m uvtrace_torch bench --bounce` through cli.main (the small
    room in place of testroomopt, whose plain-version bounces take tens of
    seconds on the CPU)."""
    monkeypatch.setattr(bench, "_load_scene_mesh", lambda: room)
    assert cli.main(["bench", "--platform", "cpu", "--bounce", "--rays", "4096", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["segments_per_photon"] == 5 and row["value"] > 0


def test_cli_bench_without_a_card_says_so(capsys):
    """Without a card, `bench` (which runs on cuda unless given --platform
    cpu) exits 2 with one line, as the other commands do without --device
    cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert cli.main(["bench", "--bounce"]) == 2
    assert "--platform cpu" in capsys.readouterr().err
