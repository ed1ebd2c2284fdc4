"""`python -m uvtrace_torch` at a small size on the CPU."""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (conftest pins the JAX side to the CPU)
import numpy as np
import pytest

from uvtrace.geometry.procedural import make_box_room
from uvtrace.io.gltf_export import export_glb
from uvtrace_torch import cli

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def small_glb(tmp_path_factory):
    room = make_box_room(subdivisions=3, clutter=2, seed=4)
    path = tmp_path_factory.mktemp("scene") / "box.glb"
    export_glb(path, room.tris)
    return path, room.triangle_count


def test_compute_writes_dose_arrays(small_glb, tmp_path):
    scene, t_count = small_glb
    route = os.path.join(REPO, "assets", "route.xml")
    proc = subprocess.run(
        [sys.executable, "-m", "uvtrace_torch", "compute", str(scene), "--route", route,
         "--photon-count", str(12 * 1024), "--iterations", "2", "--output", str(tmp_path / "out"),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["photons"] == 2 * 12 * 1024 and summary["device"] == "cpu"
    for name in ("dose_mJ_cm2.npy", "irradiance_uW_cm2.npy"):
        arr = np.load(tmp_path / "out" / name)
        assert arr.shape == (t_count,) and arr.dtype == np.float32
        assert np.isfinite(arr).all() and arr.max() > 0
    assert (tmp_path / "out" / "route_used.xml").exists()


def test_compute_with_bounces_and_dose_grid(small_glb, tmp_path):
    scene, t_count = small_glb
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "uvtrace_torch", "compute", str(scene), "--photon-count", "4096",
         "--iterations", "1", "--bounces", "2", "--reflectance", "0.5", "--dose-grid", "16",
         "--output", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["photons"] == 4096 and summary["bounces"] == 2
    grid = np.load(out / "dose_grid.npy")
    assert grid.shape == (16, 16) and grid.dtype == np.float32 and np.isfinite(grid).all() and grid.max() > 0
    for name in ("dose_mJ_cm2.npy", "irradiance_uW_cm2.npy"):
        arr = np.load(out / name)
        assert arr.shape == (t_count,) and np.isfinite(arr).all() and arr.max() > 0


def test_compute_pallas_with_the_reference_sampler(small_glb, tmp_path):
    """--traversal pallas --sampler reference: 3000 photons, not rounded up
    to whole chunks (the last chunk's tail is masked)."""
    scene, t_count = small_glb
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "uvtrace_torch", "compute", str(scene), "--photon-count", "3000",
         "--iterations", "1", "--traversal", "pallas", "--sampler", "reference", "--output", str(out),
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["photons"] == 3000
    assert summary["sampler"] == "reference" and summary["traversal"] == "pallas"
    dose = np.load(out / "dose_mJ_cm2.npy")
    assert dose.shape == (t_count,) and np.isfinite(dose).all() and dose.max() > 0


@pytest.mark.parametrize("sampler", ["stratified", "native"])
def test_calibrate_prints_a_wattage(small_glb, capsys, sampler):
    rc = cli.main(["calibrate", str(small_glb[0]), "--measure-power", "2909", "--measure-dist", "0.5",
                   "--photon-count", "4096", "--iterations", "2", "--sampler", sampler, "--traversal", "pallas",
                   "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and np.isfinite(out["calibrated_power_W"]) and out["calibrated_power_W"] > 0


def test_calibrate_needs_a_reading(small_glb, capsys):
    with pytest.raises(SystemExit):
        cli.main(["calibrate", str(small_glb[0]), "--device", "cpu"])
    assert "--measure-power" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--texel-density", "50"]])
def test_unported_flags_exit_with_a_message(small_glb, tmp_path, capsys, flag):
    rc = cli.main(["compute", str(small_glb[0]), "--output", str(tmp_path), *flag])
    assert rc == 2
    assert "not ported yet" in capsys.readouterr().err


def test_compute_defaults_to_cuda_and_refuses_without_a_card(small_glb, tmp_path, capsys, monkeypatch):
    """No silent CPU run: without --device cpu, a missing card is an error."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["compute", str(small_glb[0]), "--output", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "dose_mJ_cm2.npy").exists()


def test_missing_scene_is_a_clear_error(tmp_path, capsys):
    assert cli.main(["info", str(tmp_path / "nope.glb")]) == 2
    assert "scene not found" in capsys.readouterr().err
