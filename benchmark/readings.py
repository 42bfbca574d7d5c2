"""The readings that the limits of a cell's comparison are set from, read on
the card in one process (set-up paid once for the kernels' build):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault half_batch --fault-seeds 1,2,3] \
        [--seconds 2] [--out FILE]

For each seed, a whole run of the cell (set-up, a short window, the
comparison) with the program as it is, with the program's lower-precision
path in its place (the control), or with a fault of ``faults.py`` planted.
Prints one JSON line per run: what ran, the seed, each number compared
and whether it came out correct. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import faults, harness  # noqa: E402

harness.environment(ROOT)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None,
                   choices=sorted(faults.FAULTS))
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    runs = ([("program", s, {}) for s in _seeds(a.seeds)]
            + [("control", s, {"control": True})
               for s in _seeds(a.control_seeds)]
            + [(a.fault, s, {"fault": a.fault})
               for s in _seeds(a.fault_seeds)])
    out = open(a.out, "a") if a.out else None
    for kind, seed, kw in runs:
        t0 = time.perf_counter()
        r = harness.run(ROOT, a.workload, seed, a.seconds, False, t0, **kw)
        line = json.dumps({"workload": a.workload, "kind": kind,
                           "seed": seed, "correct": r["correct"],
                           "checks": {k: c["value"]
                                      for k, c in r["checks"].items()},
                           "metrics": {k: m["value"]
                                       for k, m in r["metrics"].items()},
                           "detail": r["detail"],
                           "wall_s": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
