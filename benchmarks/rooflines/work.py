"""Work counts of the trace kernels, from the cell's inputs alone.

A ray's work is the real triangles of the clusters (rooflines/clusters.py,
128 a cluster) whose box its segment enters before its closest hit, each
tested at FLOPS_PER_TEST f32 operations (the Pluecker edge and distance
tests of csrc/trace_common.cuh). The reference counts it (reference/
tracer.py `work=True`) on a fixed sample of every batch of rays it traces,
scaled to the batch: every segment of a bounce path, a dead lane (which
needs none) included. Bytes: each live ray segment (origin, direction) and
its hit (t, id) once, plus the scene's triangles once. The drivers scale
the reference's count to the traced slice: the dose per iteration; the
route planner's rays that do not depend on the lamp once a route, as the
reference traces them, and the rest once an evaluation of the objective.

A kernel's roofline share is the least time the card could take, the larger
of bytes / peak bytes/s and operations / peak f32 FLOP/s, over the kernel's
device time. The count is per ray, not per packet: a kernel that tests a
packet's union of clusters does more than it, and reads below 100%; so
does a program that traces again what a route needs once.
"""

from __future__ import annotations

import json
from pathlib import Path

FLOPS_PER_TEST = 80
RAY_BYTES, HIT_BYTES = 24, 8
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def roofline(run, kernels) -> float | None:
    """Percent of the card's roofline that the kernels named `kernels`
    reached over the traced slice, or None where there is nothing to read."""
    from benchmarks.harness.profile import device_time_s

    peak = PEAKS.get(run.device_kind)
    work = run.work
    if peak is None or not work.get("segments") or run.profile is None:
        return None
    seconds = device_time_s(run.profile, kernels)
    if seconds <= 0:
        return None
    flops = work["tests"] * FLOPS_PER_TEST
    n_bytes = work["segments"] * (RAY_BYTES + HIT_BYTES) + work.get("scene_bytes", 0)
    least = max(n_bytes / peak["bytes_per_s"], flops / peak["f32_flops_per_s"])
    return 100.0 * least / seconds
