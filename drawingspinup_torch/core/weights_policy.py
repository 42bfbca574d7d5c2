"""Degraded-weights policy — production honesty about missing pretrained
weights.

The reference never runs its quality-bearing paths without real pretrained
weights (ImageNet VGG19 for the stage-3 perceptual loss,
``3_style_translator/training/models.py:480-548``; ISNet DIS for side-view
background removal, ``2_charactor_reconstruction/mv.py:134-151``). This repo
can run without them — fixed-random VGG features, a heuristic matte — which
is the right default for tests and benches but silently changes production
output quality.

Policy:
  * Library-level entry points stay permissive (tests/bench), but every
    degradation is WARNED once per component and RECORDED here so run
    reports (sweep JSONL, fidelity) can surface it.
  * Production CLIs (``cli/sweep.py``, ``cli/train_stage{1,2}.py``) call
    :func:`set_strict`; in strict mode a *fail-class* degradation (random
    VGG) raises :class:`DegradedWeightsError` unless the user passed
    ``--allow-degraded-weights`` or set ``DSU_ALLOW_DEGRADED_WEIGHTS=1``.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List

__all__ = [
    "DegradedWeightsError", "set_strict", "is_strict", "allow_degraded",
    "report_degraded", "degradations", "reset_degradations",
]


class DegradedWeightsError(RuntimeError):
    """A production run required real pretrained weights that are missing."""


_lock = threading.Lock()
_strict = False
_warned: set = set()
_degradations: List[Dict[str, str]] = []


def set_strict(strict: bool = True) -> None:
    """Enable strict mode (production CLIs). In strict mode a fail-class
    degradation raises instead of warning."""
    global _strict
    _strict = strict


def allow_degraded() -> bool:
    """True when the user explicitly opted into degraded-weights runs."""
    return os.environ.get("DSU_ALLOW_DEGRADED_WEIGHTS", "0") not in ("", "0")


def is_strict() -> bool:
    return _strict and not allow_degraded()


def report_degraded(component: str, message: str, *, fail: bool = False) -> None:
    """Record (and warn once about) a degraded-weights condition.

    ``fail=True`` marks the fail-class conditions (the run's training loss
    itself is altered); in strict mode these raise with an opt-in hint.
    """
    with _lock:
        entry = {"component": component, "message": message,
                 "severity": "fail" if fail else "warn"}
        if entry not in _degradations:
            _degradations.append(entry)
        first = component not in _warned
        _warned.add(component)
    if fail and is_strict():
        raise DegradedWeightsError(
            f"[{component}] {message}\nProduction runs refuse degraded "
            "weights. Either provide the real weights (see "
            "scripts/fetch_and_verify_weights.py) or opt in explicitly "
            "with --allow-degraded-weights / DSU_ALLOW_DEGRADED_WEIGHTS=1.")
    if first:
        print(f"WARNING: [{component}] {message}", file=sys.stderr)


def degradations() -> List[Dict[str, str]]:
    """Degradations recorded so far in this process (for sweep JSONL and
    fidelity reports)."""
    with _lock:
        return list(_degradations)


def reset_degradations() -> None:
    with _lock:
        _degradations.clear()
        _warned.clear()
