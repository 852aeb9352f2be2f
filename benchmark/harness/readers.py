"""Arithmetic the per-layer metric files share. Each takes the run's
`RunInfo` and returns a number, or None where the run has nothing to read
(no trace, no such operations): the metric is then left out of the line.
A share of a peak or a roofline is never clipped: one above 100 means the
operations are counted too high or the time leaves out part of the work.
"""
from __future__ import annotations

from dataclasses import dataclass

from .flops import peak


@dataclass
class RunInfo:
    cell: object  # cells.Cell
    device_name: str
    step_flops: dict  # {'total', 'conv'} FLOPs of one step or call
    window_s: float  # the untraced window's length
    window_steps: int  # steps (or calls) completed in it
    trace: object = None  # trace.Trace of the host and the card over a traced slice
    device_trace: object = None  # trace.Trace of the card alone over another slice
    trace_steps: int = 0  # steps (or calls) in each traced slice


def _peak(run: RunInfo) -> float | None:
    return peak(run.cell.config["dtype"], run.device_name)


def mfu(run: RunInfo) -> float | None:
    """Percent of the card's peak for the configuration's dtype: the
    step's FLOPs times the steps of the untraced window, over its seconds."""
    p = _peak(run)
    if not p or not run.window_s or not run.window_steps:
        return None
    return 100.0 * run.step_flops["total"] * run.window_steps / run.window_s / p


def roofline(run: RunInfo, group: str, flops_key: str) -> float | None:
    """Percent of the peak that the kernel group's device time reaches on
    ``step_flops[flops_key]`` per traced step: the group's kernels are
    those launched under its host operations or named by its files."""
    from .cells import kernel_group

    p = _peak(run)
    if run.trace is None or not p or not run.trace_steps:
        return None
    spec = kernel_group(run.cell, group)
    seconds = run.trace.seconds(run.trace.under(spec["ops"], (), spec["kernels"]))
    if seconds <= 0:
        return None
    return 100.0 * run.step_flops[flops_key] * run.trace_steps / (seconds * p)


def range_ms(run: RunInfo, prefix: str) -> float | None:
    """Device milliseconds per traced step of the operations launched under
    host ranges whose name starts with ``prefix``."""
    if run.trace is None or not run.trace_steps:
        return None
    ops = run.trace.under((), (prefix,), ())
    if not ops:
        return None
    return 1e3 * run.trace.seconds(ops) / run.trace_steps


def idle(run: RunInfo) -> float | None:
    """Percent of the slice traced on the card alone in which no operation
    ran there: the host's profiler stays off, as in the window."""
    t = run.device_trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
