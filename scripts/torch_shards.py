"""Config 5's command line on several GPUs of one host, against one GPU.

    python3 scripts/torch_shards.py --layout 1x4 --layout 2x2 --layout 4x1
    python3 scripts/torch_shards.py --device cpu --scene room.glb --photons 2097152 \
        --density 24 --grid 32 --layout 1x2          # a rehearsal on CPU ranks over gloo

Runs `python -m uvtrace_torch compute` of config 5 (CONFIGS.md §5:
testroomopt, texel density 2048 capped at 2^25 slots, --dose-grid 4096,
--no-render; 2^25 photons and 3 iterations here) once in one process
without --shards, then for each layout R x T under
`python -m torch.distributed.run --standalone --nproc-per-node R*T` with
`--shards -1 --texel-shards T` (NCCL, one rank per GPU). Every layout must
write the one-process run's maps bit for bit (dose, irradiance, both texel
maps, the grid). Prints one JSON line per run: the layout, the CLI's own
seconds of compute() over the iterations (up to the dose map on the host),
the wall seconds of the command (start-up, files and grid included),
whether the maps are equal, and the cards' names and power limits
(nvidia-smi). Files go to build/torch_shards/ (git-ignored), removed after.
Imports nothing of JAX. Exits 1 if a layout's maps differ or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ("dose_mJ_cm2.npy", "irradiance_uW_cm2.npy", "dose_texels.npy", "irradiance_texels.npy", "dose_grid.npy")


def cards() -> list:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True)
    except FileNotFoundError:
        return ["nvidia-smi unavailable"]
    return smi.stdout.strip().splitlines() if smi.returncode == 0 else ["nvidia-smi unavailable"]


def run(cmd, timeout: float) -> tuple:
    """(seconds, the JSON lines of stdout) of a command in the checkout's
    root, on one CPU thread a process as torchrun gives its ranks (the plain
    versions' CPU matrix products may round otherwise on more threads);
    exits 1 when it fails or outlives timeout."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{' '.join(cmd[:8])} exited {proc.returncode}")
    return wall, [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--layout", action="append", required=True, help="R x T ranks: rays x texels, e.g. 2x2")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--scene", default=os.path.join(ROOT, "assets", "testroomopt.glb"))
    p.add_argument("--photons", type=int, default=1 << 25)
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--density", default="2048")
    p.add_argument("--grid", default="4096")
    args = p.parse_args()
    out = os.path.join(ROOT, "build", "torch_shards")
    shutil.rmtree(out, ignore_errors=True)
    compute = ["-m", "uvtrace_torch", "compute", args.scene, "--photon-count", str(args.photons), "--iterations",
               str(args.iterations), "--texel-density", args.density, "--texel-max-slots", str(1 << 25),
               "--dose-grid", args.grid, "--no-render", "--device", args.device]
    card = cards()
    wall, lines = run([sys.executable, *compute, "--output", os.path.join(out, "one")], timeout=900)
    print(json.dumps({"layout": "1 process", "seconds": lines[-1]["seconds"], "wall_s": wall,
                      "photons": lines[-1]["photons"], "texels": lines[-1]["texels"], "cards": card}), flush=True)
    ok = True
    for layout in args.layout:
        r, t = (int(v) for v in layout.lower().split("x"))
        d = os.path.join(out, layout)
        wall, lines = run([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={r * t}",
                           *compute, "--shards", "-1", "--texel-shards", str(t), "--output", d], timeout=900)
        equal = len(lines) == 1 and all(
            np.array_equal(np.load(os.path.join(out, "one", m)), np.load(os.path.join(d, m))) for m in MAPS)
        ok &= equal
        print(json.dumps({"layout": layout, "ranks": r * t, "seconds": lines[-1]["seconds"], "wall_s": wall,
                          "json_lines": len(lines), "maps_equal": equal, "cards": card}), flush=True)
        shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
