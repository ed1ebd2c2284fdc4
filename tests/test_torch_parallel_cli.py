"""`python -m uvtrace_torch` on two ranks under torchrun
(`python -m torch.distributed.run --standalone --nproc-per-node 2`), on the
CPU over gloo: `compute --shards -1 --texel-shards 2` writes the maps of the
one-process run bit for bit, rank 0 alone prints the JSON line, and a shard
count the launch cannot give exits 2 on every rank with the line to launch
it. `optimize-route --shards -1` writes the one-process route. torchrun
runs each rank on one CPU thread; the one-process runs here do too
(test_torch_parallel.py says why).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import one_thread
from uvtrace_torch import cli
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.gltf_export import export_glb

REPO = os.path.join(os.path.dirname(__file__), "..")
PHOTONS = 1 << 21  # two chunks of 2^20: one per rank
TIMEOUT = 240


def _torchrun(args, nproc: int = 2):
    """(returncode, stdout, stderr) of the CLI on `nproc` torchrun ranks; the
    whole process group is killed if it outlives TIMEOUT."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}",
           "-m", "uvtrace_torch", *args]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"torchrun did not finish within {TIMEOUT} s")
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "box.glb"
    export_glb(path, make_box_room(subdivisions=3, clutter=2, seed=4).tris)
    return str(path)


COMPUTE = ["--photon-count", str(PHOTONS), "--iterations", "1", "--texel-density", "24", "--dose-grid", "32",
           "--no-render", "--checkpoint", "--device", "cpu"]


@pytest.fixture(scope="module")
def compute_runs(scene, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compute")
    with one_thread():
        assert cli.main(["compute", scene, *COMPUTE, "--output", str(tmp / "one")]) == 0
    rc, out, err = _torchrun(["compute", scene, *COMPUTE, "--shards", "-1", "--texel-shards", "2",
                              "--output", str(tmp / "two")])
    return dict(tmp=tmp, rc=rc, out=out, err=err)


def test_torchrun_compute_exits_0_with_one_json_line(compute_runs):
    assert compute_runs["rc"] == 0, compute_runs["err"][-3000:]
    lines = [json.loads(line) for line in compute_runs["out"].splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 alone
    assert lines[0]["photons"] == PHOTONS and lines[0]["device"] == "cpu" and lines[0]["texels"] > 0


@pytest.mark.parametrize("name", ["dose_mJ_cm2.npy", "irradiance_uW_cm2.npy", "dose_texels.npy",
                                  "irradiance_texels.npy", "dose_grid.npy"])
def test_torchrun_maps_equal_one_process(compute_runs, name):
    one = np.load(compute_runs["tmp"] / "one" / name)
    two = np.load(compute_runs["tmp"] / "two" / name)
    assert one.shape == two.shape and np.isfinite(one).all() and one.max() > 0
    np.testing.assert_array_equal(two, one)


def test_torchrun_checkpoint_equals_one_process(compute_runs):
    """The checkpoint of the 1x2 run holds the gathered real texel slots and
    every field of the one-process checkpoint."""
    one = np.load(compute_runs["tmp"] / "one" / "checkpoint.npz")
    two = np.load(compute_runs["tmp"] / "two" / "checkpoint.npz")
    assert one.files == two.files
    for k in one.files:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)


def test_torchrun_wrong_shard_count_exits_2(scene, tmp_path):
    """--shards 4 on 2 ranks: every rank exits 2 with one line that says how
    to launch, before anything is written."""
    rc, out, err = _torchrun(["compute", scene, "--photon-count", "4096", "--device", "cpu", "--shards", "4",
                              "--output", str(tmp_path / "o")])
    assert rc != 0 and "exitcode  : 2" in err
    assert err.count("--shards 4 needs 4 ranks but 2 were launched") == 2
    assert "--nproc-per-node 4" in err and not (tmp_path / "o").exists()


def test_shards_under_a_torchrun_environment_exit_2(scene, tmp_path, capsys, monkeypatch):
    """What each rank does with --shards 4 when torchrun says the world is 2
    (WORLD_SIZE), and with --texel-shards 3, which does not divide it; ranks
    launched without --shards are told to pass --shards -1."""
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "2")
    base = ["compute", scene, "--device", "cpu", "--output", str(tmp_path / "o")]
    assert cli.main([*base, "--shards", "4"]) == 2
    assert "--nproc-per-node 4" in capsys.readouterr().err
    assert cli.main([*base, "--shards", "-1", "--texel-shards", "3", "--texel-density", "24"]) == 2
    assert "--texel-shards 3 does not divide the 2 launched ranks" in capsys.readouterr().err
    assert cli.main(base) == 2
    assert "--shards -1" in capsys.readouterr().err
    assert not dist.is_initialized() and not (tmp_path / "o").exists()


def test_shards_without_torchrun_run_one_rank(scene, tmp_path, capsys):
    """--shards -1 outside torchrun is one rank on a 1 x 1 mesh: the maps of
    the run without --shards, and the process group ends with the command."""
    import torch.distributed as dist

    args = ["compute", scene, "--photon-count", "8192", "--iterations", "1", "--texel-density", "24",
            "--no-render", "--device", "cpu"]
    assert cli.main([*args, "--output", str(tmp_path / "a")]) == 0
    assert cli.main([*args, "--shards", "-1", "--texel-shards", "1", "--output", str(tmp_path / "b")]) == 0
    assert not dist.is_initialized()
    for name in ("dose_mJ_cm2.npy", "dose_texels.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "b" / name), np.load(tmp_path / "a" / name))
    capsys.readouterr()


def test_torchrun_optimize_route_equals_one_process(scene, tmp_path):
    """optimize-route --shards -1 on 2 ranks (shadow rays sharded over a
    2-rank ray mesh) writes the one-process route, byte for byte."""
    route = os.path.join(REPO, "assets", "route.xml")
    args = ["optimize-route", scene, "--route", route, "--steps", "2", "--samples", "2", "--device", "cpu"]
    with one_thread():
        assert cli.main([*args, "--output", str(tmp_path / "one.xml")]) == 0
    rc, out, err = _torchrun([*args, "--shards", "-1", "--output", str(tmp_path / "two.xml")])
    assert rc == 0, err[-3000:]
    assert sum(line.startswith("{") for line in out.splitlines()) == 1
    assert (tmp_path / "two.xml").read_bytes() == (tmp_path / "one.xml").read_bytes()
