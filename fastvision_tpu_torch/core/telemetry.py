"""Telemetry (port of fastvision_tpu/core/telemetry.py):

  - `MetricLogger`: one JSON line per record in ``<log_dir>/<name>.jsonl``
    and a ``[fastvision]`` line on stdout;
  - `span`: a named range of the program (``fit.step``, ``data.wait``, ...)
    that a running ``torch.profiler`` records on its own clock, beside the
    kernels it launched; without a profiler, one check of its state;
  - `trace`: a ``torch.profiler`` region written as a Chrome trace, the
    spans in it.

The JAX package's TPU peak rates have no counterpart here.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any

import torch


class MetricLogger:
    """In a process group of several ranks, rank 0 alone writes (every rank
    logs the same global metrics)."""

    def __init__(self, log_dir: str | None = None, name: str = "train", stdout: bool = True):
        from .distributed import rank

        self.stdout = stdout and rank() == 0
        self._fh = None
        if log_dir and rank() == 0:
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


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the region (the CPU, and the CUDA devices where there is a
    card) and write ``<log_dir>/trace.json``, a Chrome trace (default
    directory: ``fastvision_trace`` in the temporary directory). Yields
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fastvision_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class span:
    """``with span("loss.targets"): ...`` opens a ``record_function`` range
    while a profiler records (``torch.profiler.profile``, `trace`, the
    autograd profiler, ``emit_nvtx``, which makes it an NVTX range) and
    does nothing else otherwise: a profiler being on is the only switch.
    A plain class, not a generator: entering one costs the check alone."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> span:
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range, opened = None, self._range
            opened.__exit__(*exc)
