"""The benchmark of the PyTorch and CUDA port (uvtrace_torch) on one cell:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the numbers it compared, each beside its
limit, as the last lines of standard error, and one JSON object as the last
line of standard output. See benchmarks/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the run writes stays at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmarks", ".cache", "triton")
sys.path.insert(0, ROOT)

from benchmarks.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
