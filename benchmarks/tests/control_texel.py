"""The controls of a texel cell's comparison on the card: the reference in
the program's place at bfloat16, and with the planted faults
(drivers/texel_runs.py `control`).

    python3 benchmarks/tests/control_texel.py --workload dose.texel4k --seed 1 --seed 2 --seed 3

prints one JSON line a seed with each number's reading under each control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmarks.drivers import texel_runs  # noqa: E402
from benchmarks.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="dose.texel4k")
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_texel.py: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seed:
        t0 = time.perf_counter()
        readings = texel_runs.control(core.Run(args.workload, seed, 0.0, False, t0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": str(texel_runs.LOWER),
                          "readings": readings, "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
