"""Each cell's comparison, driven through the rest of a run on the CPU with
the timed path broken underneath, comes out as not correct."""

import pytest
import torch

from benchmarks.harness import core


def _correct(run) -> bool:
    out = core.execute(run)
    return out["correct"]


def test_sound_runs_are_correct(small_run):
    for cell in ("dose.route_direct", "dose.bounce4", "routeopt.direct", "routeopt.bounce2"):
        assert _correct(small_run(cell)), cell


# --- the dose simulator -------------------------------------------------------


def _unchanged(monkeypatch):
    from uvtrace_torch.sim import simulator

    def run_iteration(self):  # the step returns its state unchanged
        self.curr_iterations += 1

    monkeypatch.setattr(simulator.Simulator, "run_iteration", run_iteration)


def _half_batch(monkeypatch):
    from uvtrace_torch.sim import simulator

    real = simulator.launch_counts

    def launch_counts(*args, n, chunk, **kw):  # half the chunks traced, their counts doubled
        counts, tex, overflow = real(*args, n=max(chunk, n // 2), chunk=chunk, **kw)
        return counts * 2, tex, overflow

    monkeypatch.setattr(simulator, "launch_counts", launch_counts)


def _altered(monkeypatch):
    from uvtrace_torch.sim import launch

    real = launch.acc_ops.slots_to_tri

    def slots_to_tri(counts, slot_map, t_count):  # each triangle's count lands on the next triangle
        return torch.roll(real(counts, slot_map, t_count), 1)

    monkeypatch.setattr(launch.acc_ops, "slots_to_tri", slots_to_tri)


@pytest.mark.parametrize("cell", ["dose.route_direct", "dose.bounce4"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_dose_faults_are_not_correct(small_run, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not _correct(small_run(cell))


# --- the route planner ---------------------------------------------------------


def _adam_unchanged(monkeypatch):
    from uvtrace_torch.diff import optimize

    monkeypatch.setattr(optimize, "_adam_step", lambda *a, **k: None)


def _waypoints_halved(monkeypatch):
    from uvtrace_torch.diff import optimize

    real = optimize.route_dose

    def route_dose(scene, waypoints_xz, durations, *args, **kw):  # half the waypoints, the sum doubled
        half = waypoints_xz.shape[0] // 2
        kw.pop("transfer", None)  # the route's plan holds every waypoint and refuses half: trace them unplanned
        return 2.0 * real(scene, waypoints_xz[:half], durations[:half], *args, **kw)

    monkeypatch.setattr(optimize, "route_dose", route_dose)


def _loss_altered(monkeypatch):
    from uvtrace_torch.diff import optimize

    real = optimize.softmin

    def softmin(x, temperature):  # each step's loss 1% off where it is produced
        return 1.01 * real(x, temperature)

    monkeypatch.setattr(optimize, "softmin", softmin)


@pytest.mark.parametrize("cell", ["routeopt.direct", "routeopt.bounce2"])
@pytest.mark.parametrize("fault", [_adam_unchanged, _waypoints_halved, _loss_altered])
def test_route_faults_are_not_correct(small_run, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not _correct(small_run(cell))
