"""The readings that the stage-2b cell's limits are set from, read on the
card in one process:

    python3 benchmark/recon_readings.py --seeds 1,2,... \\
        [--kinds program,control,no_eikonal,fine_no_grad] \\
        [--seconds 2] [--out FILE]

For each kind and seed, a whole run of ``neus_ortho.train`` (set-up, a
short window, the comparison): the program as it is, its control, or one
of the loop's planted faults (``loops/recon_loop.py``'s ``FAULTS``). Prints
one JSON line per run: the kind, the seed, each number compared, whether
it came out correct, and the comparison's detail. The benchmark's own
runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

harness.environment(ROOT)

CELL = "neus_ortho.train"


def main() -> int:
    from benchmark.loops import recon_loop

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="program")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    kinds = a.kinds.split(",")
    unknown = set(kinds) - {"program", "control", *recon_loop.FAULTS}
    if unknown:
        p.error(f"no kind named {sorted(unknown)}")
    for kind in kinds:
        for seed in (int(s) for s in a.seeds.split(",") if s):
            t0 = time.perf_counter()
            mix = {"fault": kind} if kind in recon_loop.FAULTS else None
            r = harness.run(ROOT, CELL, seed, a.seconds, False, t0,
                            control=kind == "control", mix_overrides=mix)
            line = json.dumps({
                "workload": CELL, "kind": kind, "seed": seed,
                "correct": r["correct"],
                "checks": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "detail": r["detail"], "wall_s": time.perf_counter() - t0})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
