"""Run one cell of the benchmark and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with a CUDA card. The kernels' build and cache
directories are fixed under ``build/`` in the checkout.
"""
import time

T_START = time.perf_counter()   # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT          # the checkout, not benchmark/ itself

from benchmark import harness  # noqa: E402

harness.environment(ROOT)

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
