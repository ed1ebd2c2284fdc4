"""BENCHMARK.json and the files the harness finds by name."""

import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmarks.harness import core

SPEC = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    for entry in SPEC[kind]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in entry:
                assert NAME.match(entry[key])
        for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    run = core.Run(cell, 1, 1.0, False, 0.0)
    assert run.cell["driver"] and run.config and run.traffic is not None
    importlib.import_module(f"benchmarks.drivers.{run.cell['driver']}")
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in run.metric_names(kind)]
        assert names, (cell, kind)
        for name in names:
            assert callable(core._load_metric(name))


def test_every_metric_reports_in_a_cell_and_moves_one():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for cell in CELLS:
        assert any(m["name"] != "setup_s" for m in core.Run(cell, 1, 1.0, False, 0.0).metric_names("end_to_end"))


def test_config_files_are_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmarks/") and json.loads((core.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    """A later change adds a cell as files: its entry, its cell file, its
    traffic file. The harness finds them with no edit to its code."""
    copy = tmp_path / "repo"
    (copy / "benchmarks").mkdir(parents=True)
    for sub in ("harness", "drivers", "metrics", "configs", "traffic", "workloads", "reference", "rooflines"):
        shutil.copytree(core.BENCH / sub, copy / "benchmarks" / sub)
    shutil.copy(core.BENCH / "__init__.py", copy / "benchmarks" / "__init__.py")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "dose.later", "config": "testroom_dose", "traffic": "later", "chips": 1,
                              "why": "added as files alone"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    (copy / "benchmarks" / "traffic" / "later.json").write_text(json.dumps({"lamps": [[0, 0, 1]],
                                                                            "photon_count": 1 << 20}))
    (copy / "benchmarks" / "workloads" / "dose.later.json").write_text(
        (core.BENCH / "workloads" / "dose.route_direct.json").read_text())
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmarks.harness import core; "
            "r = core.Run('dose.later', 1, 1.0, False, 0.0); "
            "print(r.cell['driver'], r.traffic['photon_count'], [m['name'] for m in r.metric_names('end_to_end')])")
    out = subprocess.run([sys.executable, "-c", code, str(copy)], capture_output=True, text=True, check=True)
    assert out.stdout.split()[:2] == ["dose_iterations", str(1 << 20)]
    assert "'setup_s'" in out.stdout


def test_a_metric_without_a_file_reads_its_family():
    """A new cell's member of a metric family (idle_share.<cell>) needs its
    entry alone: the harness reads the family's file."""
    from benchmarks.harness import readers

    assert core._load_metric("idle_share.later") is readers.idle_share
    assert core._load_metric("b2_roofline.later").__module__ == "benchmarks_metric_b2_roofline.later"
    with pytest.raises(FileNotFoundError):
        core._load_metric("no_such_metric.later")


def test_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmarks.reference.tracer, benchmarks.reference.dose, benchmarks.reference.routeopt, "
            "benchmarks.reference.threefry, benchmarks.rooflines.work; "
            "from benchmarks.harness.core import forbidden_modules; "
            "bad = forbidden_modules() + sorted(m for m in sys.modules if m.split('.')[0] == 'uvtrace_torch'); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(core.ROOT)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "uvtrace_torch_like", sys)
    monkeypatch.setitem(sys.modules, "uvtraceX.sub", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "uvtrace.sim", sys)
    assert core.forbidden_modules() == ["uvtrace"]


def test_run_refuses_without_a_card_and_prints_no_result():
    """Without CUDA the run exits non-zero and prints nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(core.BENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=core.ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
