"""Timing and profiling for the port: scoped wall-clock timers with a
report, and a ``torch.profiler`` trace scope (counterpart of
``drawingspinup_tpu/core/profiling.py``, whose trace is ``jax.profiler``'s).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

_TIMINGS: Dict[str, List[float]] = defaultdict(list)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timer(name: str, sync: bool = False) -> Iterator[None]:
    """Time a block under ``name``; ``sync=True`` waits for the card's
    queued work before and after, so that the time covers the device's
    execution of what the block enqueued."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        _TIMINGS[name].append(time.perf_counter() - t0)


def timings() -> Dict[str, Dict[str, float]]:
    """{name: count, total_s, mean_s, last_s} of every timer so far."""
    return {k: {"count": len(v), "total_s": sum(v),
                "mean_s": sum(v) / len(v), "last_s": v[-1]}
            for k, v in _TIMINGS.items()}


def samples(name: str) -> List[float]:
    """Every time (s) recorded under ``name``, in order."""
    return list(_TIMINGS.get(name, ()))


def reset_timings() -> None:
    _TIMINGS.clear()


def report(prefix: str = "") -> str:
    """One line per timer whose name starts with ``prefix``."""
    return "\n".join(
        f"{k:40s} n={st['count']:5d} total={st['total_s']:9.3f}s "
        f"mean={st['mean_s'] * 1e3:9.2f}ms"
        for k, st in sorted(timings().items()) if k.startswith(prefix))


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` scope over the CPU and, where there is one, the
    card, written to ``logdir`` as a Chrome trace; yields the profiler (for
    ``key_averages()``). A no-op yielding None when ``logdir`` is None."""
    if logdir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof
