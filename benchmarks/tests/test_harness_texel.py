"""The texel cell (dose.texel4k) on the CPU at a CPU's size: the reference's
atlas against the program's, the port's texel path and probe grid against
reference/texel.py, the whole runs of the window, a sound run read correct,
faults planted in the port read not correct, the controls."""

import subprocess
import sys
import time

import pytest
import torch

from benchmarks.drivers import texel_runs
from benchmarks.harness import core
from benchmarks.harness import scene as scene_io
from benchmarks.reference import texel as ref_texel

CELL = "dose.texel4k"
# the cell at a CPU's size: the box room, a coarse atlas, few photons, a 64^2 grid
SMALL = {"config": {"texel_density": 16.0, "texel_max_slots": 1 << 16},
         "traffic": {"photon_count": 1 << 14, "iterations": 3, "dose_grid": 64},
         "cell": {"warmup_runs": 1, "grid_rows": 16, "work_sample_every": 4}}


@pytest.fixture
def texel_run(box_glb):
    """texel_run(seed, trace=False, seconds=0.5, **more) -> a Run of the cell
    on the CPU at a CPU's size; `more` updates its overrides."""
    def make(seed=2 ** 31 + 7, trace=False, seconds=0.5, **more):
        over = {k: dict(v) for k, v in SMALL.items()}
        over["config"]["scene"] = box_glb
        for key, value in more.items():
            over[key].update(value)
        return core.Run(CELL, seed, seconds, trace, time.perf_counter(), device="cpu", overrides=over)

    return make


def _limits_hold(run, readings: dict) -> bool:
    return all(value <= run.cell["limits"][name] for name, value in readings.items())


@pytest.mark.parametrize("scene, density, max_slots", [
    ("data/testroomopt.glb", 2048.0, 1 << 25),  # the cell's own: 32,484,139 slots
    ("data/testroomopt.glb", 64.0, 1 << 16),  # a cap that shrinks the grids to one cell and below
    (None, 16.0, 1 << 16),
])
def test_the_reference_atlas_is_the_programs(box_glb, scene, density, max_slots):
    from uvtrace_torch.ops.texel import build_atlas

    tris = scene_io.load_triangles(core.BENCH / scene if scene else box_glb)
    areas = scene_io.areas(tris)
    ref = ref_texel.atlas(tris, areas, density, max_slots, "cpu")
    prog = build_atlas(areas, density=density, max_slots=max_slots)
    assert ref.n_slots == prog.n_slots <= max_slots
    assert torch.equal(ref.base, prog.base.long()) and torch.equal(ref.k, prog.k.long())
    assert torch.equal(ref.cell_area.float(), prog.cell_area)
    if scene and density == 2048.0:
        assert ref.n_slots == 32484139


def test_the_ports_texel_path_and_grid_agree_with_the_reference(texel_run):
    """One run of the port's CPU path, its whole 64^2 grid compared."""
    run = texel_run(cell={"grid_rows": 64})
    state = texel_runs.setup(run)
    record = texel_runs.traced(run, state)
    checks = dict((name, value) for name, value, _ in texel_runs.check(run, record))
    assert record["row0"] == 0 and checks["photons_gap"] == 0
    assert _limits_hold(run, checks), checks
    ref = texel_runs.Reference(run, record["sample"], 0)
    inc = torch.as_tensor(record["after"] - record["before"]).double()
    assert float(inc.sum()) == float(ref.hists["sound"].sum()) == float(ref.tri_hits.sum()) > 0


def test_the_window_counts_whole_runs_only(texel_run):
    run = texel_run(seconds=1.5)
    state = texel_runs.setup(run)
    record = texel_runs.window(run, state)
    per_run = int(run.traffic["iterations"])
    assert len(record["items"]) == record["runs"] * per_run >= per_run
    assert record["attempted"] >= len(record["items"])
    ends = [b for _, b, _ in record["items"]]
    assert ends[-1] <= record["end"] and record["end"] - record["start"] >= sum(b - a for a, b, _ in record["items"])


def test_a_sound_run_is_correct_and_reads_its_spans(texel_run):
    out = core.execute(texel_run())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"photons_per_s", "setup_s"}
    run = texel_run(trace=True)
    out = core.execute(run)
    assert out["correct"], out["checks"]
    assert out["metrics"]["grid_ms.texel4k"]["value"] > 0  # the host span; the device readings need a card
    assert run.work["k6_bytes"] > 0 and run.work["segments"] > 0


def _texel_ids(fold: bool, mirror: bool):
    """ops/texel.texel_ids with its fold left out, or with every hit's (u, v)
    mirrored to (1 - u, 1 - v) after it."""
    def texel_ids(atlas, hit_ids, u, v):
        safe = hit_ids.clamp_min(0).long()
        k_i = atlas.k[safe]
        k = k_i.to(torch.float32)
        uu, vv = u.clamp(0.0, 1.0), v.clamp(0.0, 1.0)
        if fold:
            over = uu + vv > 1.0
            uu, vv = torch.where(over, 1.0 - uu, uu), torch.where(over, 1.0 - vv, vv)
        if mirror:
            uu, vv = 1.0 - uu, 1.0 - vv
        ix = torch.minimum((uu * k).to(torch.int32), k_i - 1)
        iy = torch.minimum((vv * k).to(torch.int32), k_i - 1)
        return torch.where(hit_ids >= 0, atlas.base[safe] + iy * k_i + ix, -1)

    return texel_ids


def _mirrored(monkeypatch):
    from uvtrace_torch.ops import texel

    monkeypatch.setattr(texel, "texel_ids", _texel_ids(fold=True, mirror=True))


def _off_by_one(monkeypatch):
    from uvtrace_torch.ops import texel

    real = texel.texel_ids

    def texel_ids(atlas, hit_ids, u, v):  # every slot one further on
        slot = real(atlas, hit_ids, u, v)
        return torch.where(slot >= 0, (slot + 1).clamp_max(atlas.n_slots - 1), slot)

    monkeypatch.setattr(texel, "texel_ids", texel_ids)


def _triangle_grid(monkeypatch):
    from uvtrace_torch.sim import simulator

    real = simulator.Simulator.dose_grid

    def dose_grid(self, res=256, view=simulator.ViewMode.DOSAGE, texels=None, **kw):  # read at triangle dose
        return real(self, res, view, texels=False, **kw)

    monkeypatch.setattr(simulator.Simulator, "dose_grid", dose_grid)


@pytest.mark.parametrize("fault", [_mirrored, _off_by_one, _triangle_grid])
def test_faults_planted_in_the_port_are_not_correct(texel_run, monkeypatch, fault):
    fault(monkeypatch)
    assert not core.execute(texel_run())["correct"]


def test_leaving_out_the_fold_changes_no_count(texel_run, monkeypatch):
    """The fold (u + v > 1 onto the lower half) acts on no hit: a hit inside
    its triangle has u + v <= 1. So the fault of leaving it out cannot be
    seen, and the controls read it as sound."""
    from uvtrace_torch.ops import texel

    counts = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(texel, "texel_ids", _texel_ids(fold=False, mirror=False))
        run = texel_run()
        state = texel_runs.setup(run)
        counts.append(texel_runs.traced(run, state)["final"])
    assert torch.equal(counts[0], counts[1]) and counts[0].sum() > 0


def test_the_controls_fail_at_a_cpus_size(texel_run):
    run = texel_run(seed=2 ** 31 + 11)
    out = texel_runs.control(run)
    assert set(out) == {"lower", "no_fold", "mirrored", "off_by_one", "triangle_grid"}
    for name, readings in out.items():
        assert set(readings) == {"texel_gap", "tri_gap", "grid_gap"}
        assert _limits_hold(run, readings) == (name == "no_fold"), (name, readings)


def test_the_texel_reference_imports_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmarks.reference.texel, benchmarks.rooflines.texel, benchmarks.drivers.texel_runs; "
            "from benchmarks.harness.core import forbidden_modules; "
            "bad = forbidden_modules() + sorted(m for m in sys.modules if m.split('.')[0] == 'uvtrace_torch'); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(core.ROOT)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_k6_bytes_count_lanes_hits_triangles_and_texels():
    from benchmarks.rooflines.texel import k6_bytes

    assert k6_bytes(lanes=1024, hits=1000, triangles=10, texels=900) == 1024 * 8 + 1000 * 24 + 10 * 44 + 900 * 8
