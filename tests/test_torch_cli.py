"""`python -m uvtrace_torch` at a small size on the CPU, and against
`python -m uvtrace` on the same scene and flags (JAX on traversal="mxu",
precision "highest", Pallas interpret mode)."""

import contextlib
import io
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


@pytest.mark.parametrize("flag", [["--shards", "4"], ["--texel-shards", "2"]])
def test_unported_flags_exit_with_a_message(small_glb, tmp_path, capsys, flag):
    """--shards and --texel-shards run under torchrun
    (tests/test_torch_parallel_cli.py); in one process, a shard count that
    the one rank cannot give exits 2 with one line that says how to launch,
    before any process group starts or any file is written."""
    import torch.distributed as dist

    rc = cli.main(["compute", str(small_glb[0]), "--output", str(tmp_path / "o"), "--device", "cpu", *flag])
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "python -m torch.distributed.run --nproc-per-node" in err
    assert ("needs 4 ranks but 1 were launched" if flag[0] == "--shards" else "does not divide the 1") in err
    assert not dist.is_initialized() and not (tmp_path / "o").exists()


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


# ------------------------------------------------ against `python -m uvtrace`


@pytest.mark.parametrize("traversal", ["clustered", "jax"])
def test_compute_plain_traversals_match_jax(small_glb, tmp_path, traversal, monkeypatch):
    """--traversal clustered and jax through both command lines (the numpy
    builders on both sides): the same dose and irradiance arrays bit for
    bit, the JSON line's traversal field the one asked for. 3000 native
    photons a lamp, so the clustered budget starts at 512 (capped at the
    cluster count)."""
    import uvtrace.bvh.native
    import uvtrace_torch.bvh.native
    from uvtrace.cli import main as jax_main

    monkeypatch.setattr(uvtrace.bvh.native, "available", lambda: False)
    monkeypatch.setattr(uvtrace_torch.bvh.native, "available", lambda: False)
    monkeypatch.setenv("UVTRACE_NO_CACHE", "1")
    scene, t_count = small_glb
    run = ["compute", str(scene), "--photon-count", "3000", "--iterations", "1", "--sampler", "native",
           "--traversal", traversal, "--no-render"]
    out = {}
    for name, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([*run, "--output", str(tmp_path / name), *extra]) == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["port"]["traversal"] == traversal and out["port"]["photons"] == out["jax"]["photons"]
    for f in ("dose_mJ_cm2.npy", "irradiance_uW_cm2.npy"):
        port, ref = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert port.shape == (t_count,) and port.max() > 0
        np.testing.assert_array_equal(port, ref)

TEXEL_RUN = ["--photon-count", "4096", "--iterations", "1", "--texel-density", "16", "--power", "30",
             "--lamp-height", "0.7", "--min-dosage", "0.5", "--min-power", "20", "--traversal", "mxu",
             "--precision", "highest", "--export-glb", "--checkpoint", "--dose-grid", "16"]


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def texel_runs(tmp_path_factory):
    """`compute` with texels, every export, a checkpoint and the dose grid,
    by each package on the same tiny room (58 triangles)."""
    from uvtrace.cli import main as jax_main

    room = make_box_room(subdivisions=2, clutter=1, seed=4)
    root = tmp_path_factory.mktemp("texel_runs")
    scene = root / "room.glb"
    export_glb(scene, room.tris)
    summaries = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UVTRACE_NO_CACHE", "1")  # no persistent XLA cache outside the test's files
        for name, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["compute", str(scene), *TEXEL_RUN, "--output", str(root / name), *extra]) == 0
            summaries[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return scene, room, root, summaries


def test_compute_texel_run_writes_the_reference_files(texel_runs):
    """The same file set as uvtrace's compute; the .npy contents within the
    launch rules of tests/test_torch_texel.py (the same photons: equal but
    for flipped rays), the atlas equal, the PNGs of the same sizes, the
    legend equal byte for byte; the JSON line carries uvtrace's fields."""
    from uvtrace_torch.io.png import read_png

    scene, room, root, summaries = texel_runs
    jax_dir, port_dir = root / "jax", root / "port"
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for name in ("dose_texels.png", "dose_texels.glb", "dose.glb", "checkpoint.npz", "texel_atlas.npz",
                 "legend.png", "dose_grid.png", "dose.png", "irradiance.png"):
        assert (port_dir / name).stat().st_size > 100, name
    js, ps = summaries["jax"], summaries["port"]
    assert set(js) <= set(ps) and ps["device"] == "cpu"
    assert ps["photons"] == js["photons"] == 4096 and ps["texels"] == js["texels"] > room.triangle_count
    for key in ("dose_max", "dose_mean", "tex_dose_max", "tex_dose_mean"):
        np.testing.assert_allclose(ps[key], js[key], rtol=1e-3)
    for name, share in (("dose_mJ_cm2.npy", 0.0), ("irradiance_uW_cm2.npy", 0.0), ("dose_texels.npy", 2e-3),
                        ("irradiance_texels.npy", 2e-3), ("dose_grid.npy", 0.02)):
        got, want = np.load(port_dir / name), np.load(jax_dir / name)
        assert got.dtype == np.float32 and got.shape == want.shape, name
        assert (~np.isclose(got, want, rtol=1e-6, atol=0)).mean() <= share, name
    ja, pa = np.load(jax_dir / "texel_atlas.npz"), np.load(port_dir / "texel_atlas.npz")
    for f in ("base", "k", "cell_area"):
        np.testing.assert_array_equal(pa[f], ja[f])
    assert (port_dir / "legend.png").read_bytes() == (jax_dir / "legend.png").read_bytes()
    for name, shape in (("dose.png", (720, 960, 3)), ("irradiance.png", (720, 960, 3)),
                        ("dose_texels.png", (720, 960, 3)), ("dose_grid.png", (16, 16, 3))):
        got, want = read_png(port_dir / name), read_png(jax_dir / name)
        assert got.shape == want.shape == shape, name
        assert (got != want).any(-1).mean() <= 0.02, name
    jc, pc = np.load(jax_dir / "checkpoint.npz"), np.load(port_dir / "checkpoint.npz")
    assert sorted(pc.files) == sorted(jc.files)


@pytest.mark.parametrize("ckpt", ["port", "jax"])
def test_render_from_checkpoint(texel_runs, tmp_path, capsys, ckpt):
    """`render` of a texel checkpoint written by either package draws the
    texel-resolution view at 960x720, within 0.5% of the pixels of
    uvtrace's render of the same checkpoint; the texture view and a
    per-triangle checkpoint render too."""
    from uvtrace.cli import main as jax_main
    from uvtrace_torch.io.png import read_png

    scene, room, root, _ = texel_runs
    ck = str(root / ckpt / "checkpoint.npz")
    assert cli.main(["render", str(scene), "--checkpoint", ck, "--output", str(tmp_path / "p.png"),
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["output"] == str(tmp_path / "p.png")
    assert jax_main(["render", str(scene), "--checkpoint", ck, "--output", str(tmp_path / "j.png")]) == 0
    got, want = read_png(tmp_path / "p.png"), read_png(tmp_path / "j.png")
    assert got.shape == want.shape == (720, 960, 3) and got.max() > 0
    assert (got != want).any(-1).mean() <= 0.005
    for view, shape in (("maxpower", (720, 960, 3)), ("texture", (480, 640, 3))):
        assert cli.main(["render", str(scene), "--checkpoint", ck, "--view", view, "--threshold-view",
                         "--output", str(tmp_path / f"{view}.png"), "--device", "cpu"]) == 0
        assert read_png(tmp_path / f"{view}.png").shape == shape


@pytest.mark.parametrize("ckpt", ["port", "jax"])
def test_compute_resume_extends(texel_runs, tmp_path, capsys, ckpt):
    """--resume continues a checkpoint of either package: flags override its
    parameters (--iterations 2 adds one iteration), the texel maps carry
    on, and the result equals the port's own two-iteration run within the
    launch rules (a JAX checkpoint's first iteration came from JAX)."""
    scene, room, root, _ = texel_runs
    run = ["compute", str(scene), *TEXEL_RUN[:2], "--texel-density", "16", "--power", "30", "--lamp-height", "0.7",
           "--traversal", "mxu", "--no-render", "--device", "cpu"]
    assert cli.main([*run, "--iterations", "2", "--output", str(tmp_path / "resumed"),
                     "--resume", str(root / ckpt / "checkpoint.npz")]) == 0
    resumed = _summary(capsys)
    assert cli.main([*run, "--iterations", "2", "--output", str(tmp_path / "whole")]) == 0
    whole = _summary(capsys)
    assert resumed["photons"] == whole["photons"] == 8192
    tex_r, tex_w = np.load(tmp_path / "resumed" / "dose_texels.npy"), np.load(tmp_path / "whole" / "dose_texels.npy")
    assert (~np.isclose(tex_r, tex_w, rtol=1e-6, atol=0)).mean() <= 2e-3
    # a texel checkpoint resumed without its density is refused, not zeroed
    assert cli.main(["compute", str(scene), "--resume", str(root / ckpt / "checkpoint.npz"), "--no-render",
                     "--output", str(tmp_path / "x"), "--device", "cpu"]) == 2
    assert "texel" in capsys.readouterr().err


def test_info_texel_stats_match_jax(capsys):
    from uvtrace.cli import main as jax_main

    testroom = os.path.join(REPO, "assets", "testroomopt.glb")
    outs = []
    for main in (jax_main, cli.main):
        assert main(["info", testroom, "--texel-density", "16", "--texel-max-slots", "200000"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "texel atlas @ 16.0/m: " in outs[1] and "triangles: 44866" in outs[1]
    assert cli.main(["info", testroom, "--texel-max-slots", "100"]) == 2
    assert "requires --texel-density" in capsys.readouterr().err


def test_param_flags_reach_the_run(small_glb, tmp_path, capsys):
    """--power, --lamp-length/height, --min-dosage/power and --precision are
    uvtrace's flags: they reach the parameters and route_used.xml, and
    --lang nl prints the Dutch strings."""
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.i18n import set_language

    try:
        assert cli.main(["--lang", "nl", "compute", str(small_glb[0]), "--photon-count", "2048", "--iterations",
                         "1", "--power", "333.0", "--lamp-length", "1.2", "--lamp-height", "0.6", "--min-dosage",
                         "250", "--min-power", "900", "--precision", "fast", "--no-render",
                         "--output", str(tmp_path / "o"), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "UV straling berekenen: klaar" in out
        assert cli.main(["--lang", "nl", "info", str(tmp_path / "nope.glb")]) == 2
        assert "uvtrace_torch: fout:" in capsys.readouterr().err
    finally:
        set_language("en")
    r = load_route_xml(tmp_path / "o" / "route_used.xml")
    assert (r.light_intensity, r.light_length, r.light_height, r.min_dosage, r.min_power) == (
        333.0, 1.2, 0.6, 250.0, 900.0)


def test_watch_and_profile(small_glb, tmp_path, capsys):
    """--watch redraws dose_live.png after each iteration; --profile writes a
    torch.profiler Chrome trace."""
    assert cli.main(["compute", str(small_glb[0]), "--photon-count", "2048", "--iterations", "2", "--watch",
                     "--no-markers", "--gamma", "--threshold-view", "--profile", str(tmp_path / "prof"),
                     "--output", str(tmp_path / "o"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("Progress: ") == 2 and "Progress: 100%" in out
    assert (tmp_path / "o" / "dose_live.png").stat().st_size > 100
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


# ------------------------------------ optimize-route and dose-image (config 4)


@pytest.fixture(scope="module")
def diff_runs(tmp_path_factory):
    """`optimize-route` and `dose-image` by each package on the same tiny
    room (58 triangles) and a 3-waypoint route, with the 2-bounce term."""
    from uvtrace.cli import main as jax_main
    from uvtrace_torch.io.routexml import LightPos, Route, save_route_xml

    room = make_box_room(subdivisions=2, clutter=1, seed=4)
    root = tmp_path_factory.mktemp("diff_runs")
    scene, route = root / "room.glb", root / "route.xml"
    export_glb(scene, room.tris)
    save_route_xml(route, Route(waypoints=[LightPos(0.3, -0.2, 40.0), LightPos(-0.5, 0.4, 20.0),
                                           LightPos(9.0, 0.1, 30.0)]))
    common = ["--route", str(route), "--reflectance", "0.3", "--bounces", "2", "--sources", "8", "--samples", "2"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UVTRACE_NO_CACHE", "1")
        for name, main, extra in (("jax", jax_main, []), ("port", cli.main, ["--device", "cpu"])):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                assert main(["optimize-route", str(scene), *common, "--steps", "2", "--exclude-ceiling",
                             "--output", str(root / f"{name}.xml"), *extra]) == 0
                assert main(["dose-image", str(scene), *common, "--res", "12", "--threshold-view",
                             "--output", str(root / name), *extra]) == 0
            lines = out.getvalue().strip().splitlines()
            runs[name] = dict(opt=json.loads(lines[-2]), img=json.loads(lines[-1]), err=err.getvalue())
    return root, room, runs


def test_optimize_route_matches_jax(diff_runs):
    """The same route XML (waypoints within 1e-4 m, durations within rtol
    1e-4, the total kept), the same JSON fields plus the port's `seconds`
    and `device`, and uvtrace's notes on stderr."""
    from uvtrace.io.routexml import load_route_xml

    root, room, runs = diff_runs
    jr, pr = load_route_xml(root / "jax.xml"), load_route_xml(root / "port.xml")
    assert len(pr.waypoints) == 3
    np.testing.assert_allclose([(w.x, w.y) for w in pr.waypoints], [(w.x, w.y) for w in jr.waypoints], atol=1e-4)
    np.testing.assert_allclose([w.duration for w in pr.waypoints], [w.duration for w in jr.waypoints], rtol=1e-4)
    np.testing.assert_allclose(sum(w.duration for w in pr.waypoints), 90.0, rtol=1e-5)
    j, p = runs["jax"]["opt"], runs["port"]["opt"]
    assert set(p) == set(j) | {"seconds", "device"} and p["device"] == "cpu"
    for k in ("final_min_dose", "final_p05_dose", "final_median_dose", "coverage_above_min"):
        np.testing.assert_allclose(p[k], j[k], rtol=2e-3, atol=1e-4)
    for note in ("clipped waypoint(s) 2 into the scene footprint", "ceiling-band triangles from the objective",
                 "step 1: loss"):
        assert note in runs["jax"]["err"] and note in runs["port"]["err"]


def test_dose_image_matches_jax(diff_runs):
    """dose_image.npy within rtol 2e-3 but on tie pixels, a PNG of the same
    size, and gradients.npz with the same arrays and shapes."""
    from uvtrace_torch.io.png import read_png

    root, room, runs = diff_runs
    img_j, img_p = np.load(root / "jax" / "dose_image.npy"), np.load(root / "port" / "dose_image.npy")
    assert img_p.shape == (12, 12) and img_p.dtype == np.float32 and np.isfinite(img_p).all()
    close = np.isclose(img_p, img_j, rtol=2e-3, atol=1e-4)
    assert (~close).sum() <= 2  # probes on an edge shared by two triangles may take either
    assert read_png(root / "port" / "dose_image.png").shape == read_png(root / "jax" / "dose_image.png").shape
    gj, gp = np.load(root / "jax" / "gradients.npz"), np.load(root / "port" / "gradients.npz")
    assert sorted(gp.files) == sorted(gj.files) == ["d_worstdose_d_durations", "d_worstdose_d_waypoints"]
    assert gp["d_worstdose_d_waypoints"].shape == (3, 2) and gp["d_worstdose_d_durations"].shape == (3,)
    np.testing.assert_allclose(gp["d_worstdose_d_durations"], gj["d_worstdose_d_durations"], rtol=1e-2, atol=1e-6)
    j, p = runs["jax"]["img"], runs["port"]["img"]
    assert set(p) == set(j) | {"seconds", "device"} and p["res"] == 12
    np.testing.assert_allclose(p["dose_max"], j["dose_max"], rtol=2e-3)
    assert "--reflectance without --bounces" not in runs["port"]["err"]


@pytest.mark.parametrize("command", ["optimize-route", "dose-image"])
def test_diff_commands_refuse_shards_and_default_to_cuda(small_glb, tmp_path, capsys, monkeypatch, command):
    """--shards 2 in one process exits 2 with the torchrun line to launch
    (the sharded runs: tests/test_torch_parallel_cli.py), and so does
    --texel-shards, which shards texel maps these commands do not make;
    without --device cpu a missing card is an error, not a quiet CPU run;
    --route is required."""
    import torch

    route = os.path.join(REPO, "assets", "route.xml")
    scene = str(small_glb[0])
    assert cli.main([command, scene, "--route", route, "--shards", "2", "--device", "cpu"]) == 2
    assert "--nproc-per-node 2" in capsys.readouterr().err
    assert cli.main([command, scene, "--route", route, "--shards", "-1", "--texel-shards", "2", "--device",
                     "cpu"]) == 2
    assert "only compute makes" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([command, scene, "--route", route, "--output", str(tmp_path / "o")]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()
    assert cli.main([command, scene, "--device", "cpu"]) == 2
    assert "needs --route" in capsys.readouterr().err
