"""What the metric files under metrics/ read. A dose record's unit is
photons (one item an iteration), a route record's is steps (one item a
step). Each returns None where the run has nothing for it: a run of the
other mode, or a window of the other kind of record."""

from __future__ import annotations

import numpy as np

from benchmarks.harness.profile import device_time_s, launches

B2 = ("traverse_mxu_kernel",)


def window(run, unit: str):
    """The window's record, or None in a traced run or another kind."""
    return None if run.trace or run.record.get("unit") != unit else run.record


def traced(run):
    """The traced slice's record, or None."""
    return run.record if run.trace else None


def photons_per_s(run):
    rec = window(run, "photons")
    return None if rec is None else sum(n for _, _, n in rec["items"]) / (rec["end"] - rec["start"])


def iter_p95_ms(run):
    rec = window(run, "photons")
    return None if rec is None else float(np.percentile([(b - a) * 1e3 for a, b, _ in rec["items"]], 95))


def step_ms(run):
    """Over whole routes: the window's start to the end of the last route
    that ended in it, over those routes' steps; None without one."""
    rec = window(run, "steps")
    if rec is None or not rec["route_ends"]:
        return None
    end, steps = rec["route_ends"][-1]
    return (end - rec["start"]) * 1e3 / steps


def idle_share(run):
    if traced(run) is None:
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])


def launches_per_item(run):
    rec = traced(run)
    return None if rec is None else launches(run.profile) / len(rec["items"])


def outside_b2_ms(run):
    rec = traced(run)
    if rec is None:
        return None
    total = sum(b - a for _, a, b in run.profile["kernels"]) * 1e-6
    return (total - device_time_s(run.profile, B2)) * 1e3 / len(rec["items"])


def roofline(run, kernels):
    from benchmarks.rooflines.work import roofline as share

    return None if traced(run) is None else share(run, kernels)
