"""Structured run logging: typed records appended to a JSONL file that
survives crashes and diffs cleanly (a copy of
``drawingspinup_tpu/core/metrics.py``, pinned by
``tests/test_torch_sweep.py``)."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, **record: Any) -> None:
        record.setdefault("ts", round(time.time(), 3))
        line = json.dumps(_sanitize(record))
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        else:
            print(line)


def _sanitize(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _sanitize(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sanitize(v) for v in x]
    if hasattr(x, "item"):
        try:
            return x.item()
        except Exception:
            return str(x)
    return x
