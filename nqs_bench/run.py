"""Runs one cell of BENCHMARK.json once, from the root of a checkout:

    python3 nqs_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's JSON result; the numbers that
decide `correct` are the last lines of standard error. See README.md."""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one host thread for OpenMP, BLAS and torch's CPU ops: one caller drives the
# card, and idle worker threads only take cores from it
os.environ["OMP_NUM_THREADS"] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT     # the checkout, not this folder, is the import root

from nqs_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.run(sys.argv[1:], ROOT, T_PROCESS))
