"""The controls of the comparisons that decide `correct`: the plain
reference, put in the program's place and computed one precision below the
configuration's (bfloat16 for its float32), read by the same numbers as the
program. A control has to come out as not correct.

    python3 benchmarks/tests/control.py --workload dose.route_direct --seed 1 --seed 2 --seed 3

prints one JSON line a seed with each number's reading under each control
("lower", and for a training-like cell its planted faults).
test_control.py runs it at a CPU's size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.harness import core  # noqa: E402
from benchmarks.harness import scene as scene_io  # noqa: E402

LOWER = torch.bfloat16


def dose_control(run) -> dict:
    """{"lower": the readings of dose_iterations' numbers with the reference
    at LOWER in the program's place, on the iteration the cell's window
    samples}."""
    from benchmarks.drivers.dose_iterations import _lamps, bounce_args
    from benchmarks.reference import dose as ref_dose
    from benchmarks.reference.tracer import scene_of

    c, t = run.config, run.traffic
    tris = scene_io.load_triangles(run.data(c["scene"]))
    floor = scene_io.floor_height(tris)
    lamps, route = _lamps(run)
    get = lambda k: float(route.get(k, c[k]))  # noqa: E731
    sample = int(np.random.default_rng(run.seed).integers(run.cell["sample_first"]))
    scene = scene_of(tris, run.device)
    args = (scene, tris.shape[0], lamps, floor, get("light_height"), get("light_length"), int(t["photon_count"]),
            run.seed, int(run.cell["warmup"]) + sample, run.device)
    more = bounce_args(run, tris)
    ref = ref_dose.iteration_hits(*args, **more)[0].cpu().numpy()
    low = ref_dose.iteration_hits(*args, dtype=LOWER, **more)[0].cpu().numpy()
    area = scene_io.areas(tris).astype(np.float64)
    ok = area > 0
    gap = np.abs(low[ok] - ref[ok]) / area[ok]
    return {"lower": {"dose_gap": float(gap.sum() / (ref[ok] / area[ok]).sum()),
                      "session_hits_gap": float(abs(low.sum() - ref.sum()) / ref.sum())}}


def routeopt_control(run) -> dict:
    """The readings of route_opt_steps' numbers with the reference at LOWER
    in the program's place (its losses, first gradients and parameters
    after the followed steps), and with training faults planted in the
    reference put in its place: half of the waypoints left out and the dose
    of the rest doubled ("half_batch"), each step's loss 1% off where it is
    produced ("altered"), and each waypoint's direct irradiance 1% off, the
    estimator's own error ("irradiance")."""
    from benchmarks.drivers.route_opt_steps import _inputs, readings
    from benchmarks.reference.routeopt import RouteProblem
    from benchmarks.reference.tracer import scene_of

    tris, floor, route = _inputs(run)
    follow = int(run.cell["follow"])
    scene = scene_of(tris, run.device)
    ref = RouteProblem(scene, tris, floor, route, run.config, run.traffic, run.seed, run.device)
    losses, first, params = ref.follow(follow)

    def read(problem):
        l_p, f_p, p_p = problem.follow(follow)
        prog = {"losses": l_p, "first_grads": [g.cpu() for g in f_p], "params": [p.cpu() for p in p_p]}
        return {name: value for name, value, _ in readings(run, prog, losses, first, params, ref)}

    out = {"lower": read(RouteProblem(scene, tris, floor, route, run.config, run.traffic, run.seed, run.device,
                                      dtype=LOWER))}
    dose, loss, direct, n_way = ref.dose, ref.loss, ref._direct, ref.n_way

    def half_dose(raw, logits):
        ref.n_way = n_way // 2
        try:
            return 2.0 * dose(raw, logits)
        finally:
            ref.n_way = n_way

    ref.dose = half_dose
    out["half_batch"] = read(ref)
    ref.dose = dose
    ref.loss = lambda *a: 1.01 * loss(*a)
    out["altered"] = read(ref)
    ref.loss = loss
    ref._direct = lambda *a: 1.01 * direct(*a)
    out["irradiance"] = read(ref)
    ref._direct = direct
    return out


def control(run) -> dict:
    return {"dose_iterations": dose_control, "route_opt_steps": routeopt_control}[run.cell["driver"]](run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        t0 = time.perf_counter()
        run = core.Run(args.workload, seed, 0.0, False, t0)
        readings = control(run)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": str(LOWER), "readings": readings,
                          "seconds": time.perf_counter() - t0, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
