"""The port's one tracing system: named spans, integer counters and a
``torch.profiler`` trace scope (counterpart of
``drawingspinup_tpu/core/profiling.py``, whose trace is ``jax.profiler``'s).

- ``span(name, sync=False)`` times a block. Every span adds its duration
  to its name's aggregate: count, total, min, max, last and a ring of the
  last ``RING`` durations (``timings``, ``samples``, ``report``, ``total``).
- While a ``torch.profiler`` is recording (checked once per span), a span
  also opens a ``record_function`` range of its name, so that it sits in
  the Chrome trace beside the kernels it launched, and appends a
  ``SpanRecord`` to an in-memory store (``spans``) with its start and end
  on the trace's clock: ``time.time_ns()``, which the exported trace's
  ``ts`` (µs) plus its ``baseTimeNanoseconds`` reads. A record's parent is
  the span open on its thread; its unit is the frame, step or uid open in
  the process (a span its caller opened with ``unit=True``; the outermost
  such span opens it), so that the spans the autograd engine opens on its
  own threads take the step that called ``backward``. With no profiler
  recording, none of this is built.
- ``span(name, device=True)`` also times the card: while a profiler
  records and CUDA is in use, it records a CUDA event pair on the current
  stream around the block, resolved by ``device_times()`` (after a
  synchronise) into the card's seconds by the record's id. Otherwise it
  costs what any span costs.
- Inside ``capturing()`` (around a CUDA graph's capture) a device-timed
  span records its event pair into the graph instead, whether a profiler
  records or not, and lists it with the capture. After each replay of
  the graph, ``replayed`` gives each listed span, while a profiler
  records, a ``SpanRecord`` with the unit and the parent open at the
  replay and, after a synchronise, its seconds on the card of that replay
  (the next replay records the same events again).
- ``count(name, n=1)``: integer counters, always on (``counters``).
- ``reset()`` clears the aggregates, the counters, the store, the events
  and the replays' times.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

RING = 1024                 # durations kept per span name
MAX_RECORDS = 1_000_000     # the store's cap; later records are counted
DROPPED = "profiling.dropped_spans"


class SpanRecord(NamedTuple):
    """One span recorded under a profiler: start and end in ns since the
    epoch (the trace's clock), its id, the id of the span open on its
    thread when it opened, and the id of the unit (the ``unit=True`` span)
    open in the process, None where there was none."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    unit: Optional[int]
    thread: int


class _Stat:
    __slots__ = ("count", "total", "min", "max", "last", "ring")

    def __init__(self) -> None:
        self.count, self.total = 0, 0.0
        self.min, self.max, self.last = float("inf"), 0.0, 0.0
        self.ring: collections.deque = collections.deque(maxlen=RING)

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        if dt < self.min:
            self.min = dt
        if dt > self.max:
            self.max = dt
        self.last = dt
        self.ring.append(dt)


_LOCK = threading.Lock()
_STATS: Dict[str, _Stat] = {}
_COUNTERS: Dict[str, int] = {}
_RECORDS: List[SpanRecord] = []
_EVENTS: List[Tuple[int, object, object]] = []   # (record id, start, end)
_TIMES: Dict[int, float] = {}   # record id → seconds, the replays' spans
_CAPTURE: Optional[List[Tuple[str, object, object]]] = None   # capturing()
_IDS = itertools.count(1)
_THREAD = threading.local()     # .stack: ids of the recorded spans open
_UNIT: Optional[int] = None     # the unit open in the process


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _event():
    """A timing event recorded on the current CUDA stream, or None where
    CUDA is not in use."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _graph_event():
    """A timing event recorded into the CUDA graph that the current stream
    captures: a node of the graph, recorded again by every replay."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


class _Open:
    """A recorded span while it is open: its range and its place."""
    __slots__ = ("rf", "id", "parent", "unit", "opens_unit", "stack",
                 "start_ns", "first")

    def __init__(self, name: str, device: bool, unit: bool) -> None:
        global _UNIT
        # the range's own start is read early in its (first time slow)
        # enter: the store's start is read just before it
        self.start_ns = time.time_ns()
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()
        self.stack = getattr(_THREAD, "stack", None)
        if self.stack is None:
            self.stack = _THREAD.stack = []
        self.id = next(_IDS)
        self.parent = self.stack[-1] if self.stack else None
        self.opens_unit = unit and _UNIT is None
        if self.opens_unit:
            _UNIT = self.id
        self.unit = _UNIT
        self.stack.append(self.id)
        self.first = _event() if device else None

    def close(self, name: str) -> None:
        global _UNIT
        last = _event() if self.first is not None else None
        end_ns = time.time_ns()
        self.stack.pop()
        if self.opens_unit:
            _UNIT = None
        rec = SpanRecord(name, self.start_ns, end_ns, self.id, self.parent,
                         self.unit, threading.get_ident())
        if len(_RECORDS) < MAX_RECORDS:
            _RECORDS.append(rec)
            if last is not None:
                _EVENTS.append((self.id, self.first, last))
        else:
            count(DROPPED)
        self.rf.__exit__(None, None, None)


class _Span:
    __slots__ = ("name", "sync", "device", "unit", "t0", "open", "capture",
                 "first")

    def __init__(self, name: str, sync: bool, device: bool,
                 unit: bool) -> None:
        self.name, self.sync, self.device = name, sync, device
        self.unit = unit

    def __enter__(self) -> "_Span":
        if self.sync:
            _sync()
        self.capture = _CAPTURE if self.device else None
        self.open = _Open(self.name, self.device and self.capture is None,
                          self.unit) \
            if torch.autograd._profiler_enabled() else None
        self.first = _graph_event() if self.capture is not None else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.capture is not None:
            self.capture.append((self.name, self.first, _graph_event()))
        if self.sync:
            _sync()
        dt = time.perf_counter() - self.t0
        if self.open is not None:
            self.open.close(self.name)
        with _LOCK:
            st = _STATS.get(self.name)
            if st is None:
                st = _STATS[self.name] = _Stat()
            st.add(dt)


def span(name: str, sync: bool = False, device: bool = False,
         unit: bool = False) -> _Span:
    """Time a block under ``name``; ``sync=True`` waits for the card's
    queued work before and after, so that the time covers the device's
    execution of what the block enqueued. Under a recording profiler the
    block is also a ``record_function`` range and a ``SpanRecord``, with
    ``device=True`` a pair of CUDA events around the block's work on the
    current stream (``device_times``), and with ``unit=True`` the
    process's unit (a frame, a step, a uid) when none is open."""
    return _Span(name, sync, device, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> collections.Counter:
    """Every counter so far (a copy; a name never counted reads 0)."""
    with _LOCK:
        return collections.Counter(_COUNTERS)


def spans() -> List[SpanRecord]:
    """The store's records, in the order the spans closed."""
    return list(_RECORDS)


def device_times() -> Dict[int, float]:
    """{record id: seconds on the card} of every device-timed span in the
    store: the time between its two events, or for a replayed span what
    ``replayed`` read. Synchronises the card first."""
    _sync()
    times = dict(_TIMES)
    times.update((i, a.elapsed_time(b) * 1e-3) for i, a, b in list(_EVENTS))
    return times


@contextlib.contextmanager
def capturing() -> Iterator[List[Tuple[str, object, object]]]:
    """Around a CUDA graph's capture: yields the list to which each
    device-timed span opened inside adds (name, start event, end event),
    its pair recorded into the graph. Hand it to ``replayed`` after each
    replay."""
    global _CAPTURE
    if _CAPTURE is not None:
        raise RuntimeError("profiling.capturing: a capture is open already")
    _CAPTURE = []
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = None


def replayed(captured: List[Tuple[str, object, object]],
             start_ns: int) -> None:
    """After a replay, launched at ``start_ns`` (``time.time_ns()``), of a
    graph whose capture listed ``captured``: while a profiler records, one
    record per listed span, from ``start_ns`` to the end of this call, with
    the unit and the parent open now, and, after a synchronise, its
    seconds on the card in this replay, read now because the next replay
    records the same events again. Does nothing otherwise."""
    if not captured or not torch.autograd._profiler_enabled():
        return
    _sync()
    end_ns = time.time_ns()
    stack = getattr(_THREAD, "stack", None)
    parent = stack[-1] if stack else None
    tid = threading.get_ident()
    for name, first, last in captured:
        if len(_RECORDS) >= MAX_RECORDS:
            count(DROPPED)
            continue
        rec = SpanRecord(name, start_ns, end_ns, next(_IDS), parent, _UNIT,
                         tid)
        _RECORDS.append(rec)
        _TIMES[rec.id] = first.elapsed_time(last) * 1e-3


def reset() -> None:
    """Clear the aggregates, the counters, the store, its events and the
    replays' times."""
    with _LOCK:
        _STATS.clear()
        _COUNTERS.clear()
        _RECORDS.clear()
        _EVENTS.clear()
        _TIMES.clear()


def timings() -> Dict[str, Dict[str, float]]:
    """{name: count, total_s, mean_s, min_s, max_s, last_s} of every span
    so far."""
    with _LOCK:
        return {k: {"count": st.count, "total_s": st.total,
                    "mean_s": st.total / st.count, "min_s": st.min,
                    "max_s": st.max, "last_s": st.last}
                for k, st in _STATS.items()}


def total(name: str) -> float:
    """Seconds spent under ``name`` so far, 0 where it never ran."""
    with _LOCK:
        st = _STATS.get(name)
        return st.total if st is not None else 0.0


def samples(name: str) -> List[float]:
    """The last ``RING`` durations (s) under ``name``, in order."""
    with _LOCK:
        st = _STATS.get(name)
        return list(st.ring) if st is not None else []


def report(prefix: str = "") -> str:
    """One line per span whose name starts with ``prefix``."""
    return "\n".join(
        f"{k:40s} n={st['count']:5d} total={st['total_s']:9.3f}s "
        f"mean={st['mean_s'] * 1e3:9.2f}ms min={st['min_s'] * 1e3:9.2f}ms "
        f"max={st['max_s'] * 1e3:9.2f}ms"
        for k, st in sorted(timings().items()) if k.startswith(prefix))


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` scope over the CPU and, where there is one, the
    card, written to ``logdir`` as a Chrome trace with the spans opened
    inside it; yields the profiler (for ``key_averages()``). A no-op
    yielding None when ``logdir`` is None."""
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
