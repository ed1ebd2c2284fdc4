"""The controls fail the limits that decide `correct`: the reference one
precision below the configuration's, and for the route planner the
training faults planted in the reference put in the program's place
(tests/control.py)."""

import pytest
import torch

from benchmarks.tests import control


def _fails(run, readings: dict) -> bool:
    limits = run.cell["limits"]
    return any(value > limits[name] for name, value in readings.items())


@pytest.mark.parametrize("cell", ["dose.route_direct", "dose.bounce4", "routeopt.direct", "routeopt.bounce2"])
def test_controls_fail_at_a_cpus_size(small_run, cell):
    run = small_run(cell, seed=2 ** 31 + 11)
    out = control.control(run)
    assert set(out) >= {"lower"}
    for name, readings in out.items():
        assert _fails(run, readings), (name, readings)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dose.route_direct", "routeopt.direct"])
def test_controls_fail_on_the_card_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    import time

    from benchmarks.harness import core

    run = core.Run(cell, 2 ** 31 + 12, 1.0, False, time.perf_counter())
    for name, readings in control.control(run).items():
        assert _fails(run, readings), (name, readings)
