"""Structured JSONL metrics: one record per log event, tagged train / eval.

Counterpart of dssm_tpu/io/metrics.py without its TensorBoard mirror.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, IO, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, tag: str, step: int, metrics: Dict[str, Any]) -> None:
        record = {"tag": tag, "step": step, "time": time.time(), **metrics}
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
