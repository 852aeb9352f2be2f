"""Structured metric logging (port of fastvision_tpu/core/telemetry.py's
``MetricLogger``): one JSON line per record in ``<log_dir>/<name>.jsonl``
and a ``[fastvision]`` line on stdout.

Not ported yet: ``StepTimer``, ``trace`` and the MFU helpers.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | None = None, name: str = "train", stdout: bool = True):
        self.stdout = stdout
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")

    def log(self, step: int, **metrics: Any) -> None:
        """Numbers (device scalars included, which this reads back) become
        floats; anything else is kept as it is."""
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.stdout:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k != "time"
            )
            print(f"[fastvision] {parts}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
