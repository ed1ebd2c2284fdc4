"""The route cells' window reading (metrics/opt_step_ms.py through
harness/readers.step_ms): whole routes only. On records assembled by hand,
then on runs of a route cell shrunk to a CPU's size through core.Run's
overrides."""

import types

import pytest

from benchmarks.harness import core

READ = core._load_metric("opt_step_ms.bounce2")


def _window(route_ends, start=10.0, steps=14):
    """A window's record of `steps` steps of 20 ms from `start`, with the
    given whole routes' (end, steps done by then)."""
    items = [(start + 0.02 * i, start + 0.02 * (i + 1), 1) for i in range(steps)]
    record = {"unit": "steps", "start": start, "end": items[-1][1], "items": items, "attempted": steps,
              "route_ends": route_ends}
    return types.SimpleNamespace(trace=False, record=record)


def test_a_partial_last_route_is_not_counted():
    # two whole routes of 5 steps, each 20 ms a step and 50 ms of its own
    # set-up and final evaluation, then 4 steps of a route the window stops in
    run = _window([(10.15, 5), (10.30, 10)])
    assert READ(run) == pytest.approx(300.0 / 10)
    # the whole window over every step would read 280 ms / 14
    assert READ(run) != pytest.approx((run.record["end"] - run.record["start"]) * 1e3 / 14)


def test_a_window_with_no_whole_route_reads_none():
    assert READ(_window([])) is None
    assert READ(types.SimpleNamespace(trace=True, record=_window([(10.15, 5)]).record)) is None  # a traced slice


def test_a_route_cell_counts_whole_routes_and_attempts_every_step(small_run):
    """routeopt.direct at a CPU's size (5-step routes): the window stops
    inside a route; the reading is the whole routes' time over their steps,
    and `attempted` counts every step."""
    run = small_run("routeopt.direct", seconds=3.0)
    out = core.execute(run)
    rec = run.record
    end, steps = rec["route_ends"][-1]
    assert out["correct"] and len(rec["route_ends"]) >= 1
    assert steps == 5 * len(rec["route_ends"]) and rec["attempted"] == len(rec["items"]) > steps
    assert out["attempted"] == rec["attempted"]
    assert out["metrics"]["opt_step_ms.direct"]["value"] == pytest.approx((end - rec["start"]) * 1e3 / steps)


def test_a_route_cell_whose_window_holds_no_whole_route_leaves_the_metric_out(small_run):
    """A window that closes inside the first route: opt_step_ms is left out
    of the result line, setup_s is still there, and the run is still
    judged."""
    run = small_run("routeopt.direct", seconds=0.0)
    out = core.execute(run)
    assert run.record["route_ends"] == [] and run.record["attempted"] >= 3
    assert "opt_step_ms.direct" not in out["metrics"] and "setup_s" in out["metrics"]
    assert out["correct"]
