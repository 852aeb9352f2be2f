"""Telemetry (port of fastvision_tpu/core/telemetry.py):

  - `MetricLogger`: one JSON line per record in ``<log_dir>/<name>.jsonl``
    and a ``[fastvision]`` line on stdout;
  - `StepTimer`: wall-clock time per step, warm-up steps skipped, waiting
    for the step's CUDA work where the JAX package blocks on its result;
  - `trace`: a ``torch.profiler`` region written as a Chrome trace;
  - `flops_of`: the floating-point operations of one call, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` from the operators' shapes.

The JAX package's TPU peak rates have no counterpart here.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Callable

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


def _synchronize(result: Any) -> None:
    """Wait for the CUDA devices that hold a tensor of ``result`` (a tensor
    or a nest of them)."""
    devices = {t.device for t in torch.utils._pytree.tree_leaves(result)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Per-step timing: `start`, then `tick(result)` once a step; `mean`
    over the steps after the first ``warmup``."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, result: Any = None) -> float:
        """End a step: wait for ``result``'s CUDA work (where it holds CUDA
        tensors), then -> the seconds since the last tick (or `start`)."""
        if result is not None:
            _synchronize(result)
        now = time.perf_counter()
        dt = now - (self._last if self._last is not None else now)
        self._last = now
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count - self.warmup, 1)


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


def flops_of(fn: Callable, *args) -> float | None:
    """Floating-point operations of ``fn(*args)`` (one call, run here), as
    ``FlopCounterMode`` counts them from the operators' shapes (a conv or
    a matmul: 2 per multiply-add); None where it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
