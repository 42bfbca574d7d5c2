"""The benchmark's harness: finds a cell, its configuration, its traffic mix
and its per-layer metrics by name from their files, runs set-up, the
measured window and (with ``--trace 1``) the traced window through the
mix's loop, checks the outputs against the plain reference, and prints
the result line.

Layout under ``benchmark/``, each found by the name ``BENCHMARK.json``
gives it; a later cell, configuration, mix or metric is added by adding
files:
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips and
  the limit of each number its comparison reads;
- ``configs/<config>.json``: the configuration's sizes as run;
- ``traffic/<mix>.json``: the mix's parameters and its loop
  (``loops/<loop>.py``: ``Session`` with ``setup``, ``run_units``,
  ``window``, ``free`` and ``check``);
- ``metrics/<metric>.json`` and ``metrics/<metric>.py``: a per-layer
  metric and its reader, ``read(ctx)`` → a number, or None where the run
  gives it nothing to read.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import traceback
from typing import Dict, List, Optional

from benchmark import faults, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drawingspinup_tpu")
BENCH = "benchmark"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def environment(root: str) -> None:
    """Fix the kernels' build and cache directories under ``build/`` in the
    checkout, so that only a checkout's first run builds. Call before
    torch is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(root, "build", sub)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def find(root: str, kind: str, name: str) -> Dict:
    """``benchmark/<kind>/<name>.json``: a cell (``workloads``), a
    configuration (``configs``), a mix (``traffic``) or a metric
    (``metrics``)."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(root, BENCH, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return _json(path)


def reader(root: str, name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, BENCH, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def loop(mix: Dict):
    """The module that runs ``mix``: ``benchmark/loops/<mix["loop"]>.py``."""
    return importlib.import_module(f"benchmark.loops.{mix['loop']}")


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power_limit() -> str:
    """nvidia-smi's name and power limit of card 0, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    return out.stdout.strip() or "not measured"


class Cell:
    """A cell as its files describe it."""

    def __init__(self, root: str, name: str,
                 config_overrides: Optional[Dict] = None,
                 mix_overrides: Optional[Dict] = None):
        self.root, self.name = root, name
        self.bench = spec(root)
        self.cell = find(root, "workloads", name)
        self.config = {**find(root, "configs", self.cell["config"]),
                       **(config_overrides or {})}
        self.mix = {**find(root, "traffic", self.cell["traffic"]),
                    **(mix_overrides or {})}
        self.loop = loop(self.mix)

    def session(self, seed: int, device: str, workdir: str,
                control: bool = False):
        return self.loop.Session(self.config, self.mix, seed, device,
                                   workdir, control)


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", control: bool = False,
        config_overrides: Optional[Dict] = None,
        mix_overrides: Optional[Dict] = None,
        fault: Optional[str] = None) -> Dict:
    """One run of cell ``name``: the result line as a dict. ``control``
    runs the program's lower-precision path in its place; ``fault`` names
    one of ``faults.FAULTS``, planted in the program for the whole run."""
    import torch

    cell = Cell(root, name, config_overrides, mix_overrides)
    workdir = tempfile.mkdtemp(prefix="bench-")
    planted = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    try:
        with planted:
            sess = cell.session(seed, device, workdir, control)
            sess.setup()
            win = sess.window(seconds)
            setup_s = sess.window_start - t_start
            traced = None
            if trace:
                traced = tracing.capture(sess.run_units,
                                         cell.mix["traced_units"], workdir)
        cuda = sess.dev.type == "cuda"
        peak = torch.cuda.max_memory_allocated(sess.dev) if cuda else 0
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"modules loaded that the run may not hold: "
                               f"{', '.join(found)}")
        sess.free()
        readings = sess.check()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    limits = cell.cell["limits"]
    if set(limits) != set(readings):
        raise RuntimeError(f"limits {sorted(limits)} do not name the "
                           f"readings {sorted(readings)}")
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in sorted(readings)}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(sess.dev) if cuda
                   else "cpu",
                   "count": cell.cell["chips"] if cuda else 0,
                   "memory_peak_bytes": peak}
    metrics = {}
    if trace:
        device_info.update(busy_s=traced["busy_s"],
                           window_s=traced["window_s"],
                           card=card_power_limit() if cuda
                           else "not measured")
        ctx = {"config": cell.config, "mix": cell.mix, "cell": cell.cell,
               "unit": cell.loop.UNIT, "window": win, "trace": traced}
        for m in per_layer(cell.bench, name):
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**win["e2e"], "setup_s": setup_s}
        for m in end_to_end(cell.bench, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": win["failed"] == 0
              and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["setup_parts_s"] = sess.phases
    result["detail"] = sess.detail
    result["checks"] = checks
    return result


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json and print its result "
                    "line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], t_start: float, root: str) -> int:
    args = parse(argv)
    try:
        import torch

        chips = find(root, "workloads", args.workload)["chips"]
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if seen < chips:
            print(f"benchmark: cell {args.workload} needs {chips} CUDA "
                  f"device(s); torch sees {seen}", file=sys.stderr)
            return 2
        result = run(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the run may not hold: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
