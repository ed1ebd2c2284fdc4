"""One run of one cell: find the cell, its configuration, its traffic, its
driver and its metrics by name; set up; measure a window (or trace a fixed
slice of one); compare what the window produced with the plain reference;
print the result line.

Files, all found by name under benchmarks/:
  workloads/<cell>.json     the cell: its driver, its limits, its traced slice
  configs/<config>.json     the deployment (BENCHMARK.json names the file)
  traffic/<traffic>.json    the traffic mix's parameters
  drivers/<driver>.py       setup(run), window(run, state), traced(run, state),
                            release(run, state), check(run, state, record)
  metrics/<metric>.py       read(run) -> number or None; a metric without a
                            file of its own reads metrics/<family>.py, its name
                            up to the first dot (idle_share.dose: idle_share.py)
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uvtrace")  # compared with whole top-level module names


class RunError(RuntimeError):
    """A run that cannot give a result."""


class Run:
    """What a run knows: its cell, files, seed and window, and what it
    measured. Drivers and metric readers read and fill it."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
                 overrides: dict | None = None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), bool(trace)
        self.t_start, self.device = t_start, device
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise RunError(f"no workload {name!r} in BENCHMARK.json")
        self.spec, self.entry = spec, cells[name]
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        self.cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        self.config = json.loads((ROOT / config["file"]).read_text())
        self.traffic = json.loads((BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        for key, value in (overrides or {}).items():  # tests shrink a cell to a CPU's size
            getattr(self, key).update(value)
        self.setup_s = self.scene_build_s = None
        self.record = None  # the window's or the traced slice's record (drivers)
        self.profile = None  # harness/profile.py's reading of the traced slice
        self.work = {}  # work counts the reference gathered (rooflines/work.py)
        self.checks = []  # (name, value, limit)
        self.memory_peak_bytes = 0
        self.device_kind = None

    def data(self, rel: str) -> Path:
        """A data file named in a configuration or traffic file, relative to
        benchmarks/."""
        return BENCH / rel

    def metric_names(self, kind: str) -> list[dict]:
        return [m for m in self.spec[kind] if "workloads" not in m or self.name in m["workloads"]]


def _load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    info = {"platform": "gpu", "kind": name, "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def execute(run: Run) -> dict:
    """Set up, measure or trace, check; returns the result object. Raises
    RunError where no result can be given."""
    import torch

    from benchmarks.harness import profile

    torch.set_num_threads(1)  # one process, one host thread for its CPU ops: steadier host-bound steps
    if run.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < run.entry["chips"]:
            raise RunError(f"needs {run.entry['chips']} CUDA device(s); torch sees "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = _card(torch)
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1}
    run.device_kind = device["kind"]
    driver = importlib.import_module(f"benchmarks.drivers.{run.cell['driver']}")
    state = driver.setup(run)
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - run.t_start
    if run.trace:
        run.record, run.profile = profile.traced(lambda: driver.traced(run, state), run.device)
    else:
        run.record = driver.window(run, state)
    if run.device == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    driver.release(run, state)
    del state
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    run.checks = driver.check(run, run.record)
    print(f"benchmarks/run.py: set-up {run.setup_s:.1f} s, window {run.record['end'] - run.record['start']:.1f} s, "
          f"reference {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(_within(v, limit) for _, v, limit in run.checks)
    metrics = {}
    for m in run.metric_names("per_layer" if run.trace else "end_to_end"):
        value = _load_metric(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device["memory_peak_bytes"] = run.memory_peak_bytes
    out = {"correct": correct, "attempted": run.record["attempted"],
           "failed": 0 if correct else 1, "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"], device["window_s"] = run.profile["busy_s"], run.profile["window_s"]
        out["breakdown"] = run.profile["breakdown"]
    out["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in run.checks}
    return out


def _within(value, limit) -> bool:
    return value is not None and not (isinstance(value, float) and math.isnan(value)) and value <= limit


def main(argv: list[str], t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="benchmarks/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        run = Run(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
        result = execute(run)
    except RunError as e:
        print(f"benchmarks/run.py: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmarks/run.py: the run loaded {', '.join(found)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
