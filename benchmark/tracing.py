"""The traced window: ``torch.profiler`` over the CPU and the card for a
fixed number of units of a cell's work, exported as a Chrome trace and
reduced to what the per-layer metrics read.

- Device operations: kernels, copies and fills that start inside the
  window's range. Busy time is the union of their intervals, cut at the
  range's end; launches are their count.
- RIC backward: every device operation launched (runtime launch, matched
  by the trace's correlation id) from inside the autograd node
  ``RICConvFunctionBackward`` on its thread.
- RIC forward: the port's forward has no op or range in the trace, so its
  kernels are read by name: the kernels that ``kernels/csrc/ric_conv_*.cu``
  define (``ric_conv_...``) that were not launched from the backward node.
- Idle gaps: each stretch of the window in which no device operation ran,
  named after the host operation open at the gap's middle that started
  last, on any thread (the autograd engine runs the backward on a thread
  of its own while the window's thread waits), "(python)" where none is
  open, summed by that name.
"""
from __future__ import annotations

import bisect
import json
import os
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CUDA_API = "cuda_"      # categories of the CUDA API calls (launches, copies)
RIC_BWD_OP = "RICConvFunctionBackward"
RIC_KERNEL = re.compile(r"\bric_conv_")
TOP = 10


def capture(run_units: Callable[[int], None], units: int,
            workdir: str) -> Dict:
    """Trace ``run_units(units)`` (after one untraced unit under the
    profiler, so that its start-up is not in the window) and reduce it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_units(1)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            run_units(units)
            torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, units)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(host: List[Dict], times: List[float]) -> List[Optional[Dict]]:
    """The innermost host event open at each of the sorted ``times``
    (nested events of one thread), None where none is."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        names.append(stack[-1] if stack else None)
    return names


def summarize(events: List[Dict], units: int) -> Dict:
    """The traced window's figures (seconds unless named otherwise)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in xs if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError("the trace has no window range")
    win = wins[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat", "").startswith(CUDA_API)
                and "correlation" in e.get("args", {})}
    bwd: Dict[object, List[Tuple[float, float]]] = defaultdict(list)
    for e in xs:
        if e.get("cat") == "cpu_op" and RIC_BWD_OP in e.get("name", ""):
            bwd[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    starts = {tid: sorted(v) for tid, v in bwd.items()}

    def in_bwd(launch) -> bool:
        if launch is None or launch["tid"] not in starts:
            return False
        iv = starts[launch["tid"]]
        k = bisect.bisect_right(iv, (launch["ts"], float("inf"))) - 1
        return k >= 0 and iv[k][0] <= launch["ts"] <= iv[k][1]

    by_name: Dict[str, float] = defaultdict(float)
    ric_fwd = ric_bwd = 0.0
    for e in dev:
        dur = e["dur"] * 1e-6
        by_name[e["name"]] += dur
        if in_bwd(launches.get(e.get("args", {}).get("correlation"))):
            ric_bwd += dur
        elif e["cat"] == "kernel" and RIC_KERNEL.search(e["name"]):
            ric_fwd += dur
    busy = _union([(e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev])
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    threads: Dict[object, List[Dict]] = defaultdict(list)
    for e in xs:
        if (e.get("cat") in HOST_CATS
                or e.get("cat", "").startswith(CUDA_API)) and e is not win \
                and e["ts"] < w1 and e["ts"] + e["dur"] > w0:
            threads[e["tid"]].append(e)
    mids = [(a + b) / 2 for a, b in gaps]
    open_at = [_innermost(host, mids) for host in threads.values()]
    idle: Dict[str, float] = defaultdict(float)
    for i, (a, b) in enumerate(gaps):
        found = [o[i] for o in open_at if o[i] is not None]
        name = max(found, key=lambda e: e["ts"])["name"] if found \
            else "(python)"
        idle[name] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"units": units,
            "window_s": win["dur"] * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "launches": len(dev),
            "ric_fwd_s": ric_fwd,
            "ric_bwd_s": ric_bwd,
            "device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]}
