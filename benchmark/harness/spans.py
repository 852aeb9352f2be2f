"""The program's own spans in the host-and-card slice: where the card
waited, put down to what the host's main thread was doing.

The port opens ``record_function`` ranges (``fastvision_tpu_torch.core.
telemetry.span``) while a profiler records: ``fit.step`` around each
step of `Fit`, ``step.forward`` / ``step.loss`` / ``step.backward``
around each microbatch's parts, ``loss.targets`` around each level's
target assignment of `YOLOv3Loss`, and ``data.wait`` around each wait
of the consumer of ``prefetch_to_device`` (one before each step, and a
last one that finds the loader done). They share the device trace's
clock. On CUDA, autograd launches the backward's kernels from its own
thread, so a main-thread span owns the host's time and the card's idle
gaps during it, not the kernels that ran then.

Idle time is cut by overlap: the part of each gap of
``Trace.busy_intervals()`` that lies inside a span counts for it,
wherever the gap's middle falls. A program without the spans gives no
reading (None), so every reader here falls silent on it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import WINDOW, _stacks_at

STEP, WAIT = "fit.step", "data.wait"
PROGRAM = (WAIT, STEP, "step.forward", "step.loss", "loss.targets", "step.backward")
OPTIMIZER = "Optimizer.step#"  # torch's own range around the optimizer's step


def main_ranges(trace, name: str) -> list[tuple[float, float]]:
    """(start, end) in microseconds of the main thread's host ranges named
    ``name``, in order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in trace._host
                  if e.get("tid") == trace.main_tid and e.get("name") == name)


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The window's stretches in which nothing ran on the card."""
    out, prev = [], trace.t0
    for a, b in trace.busy_intervals():
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if prev < trace.t1:
        out.append((prev, trace.t1))
    return out


def union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def overlap(xs, ys) -> float:
    """Microseconds that two sets of intervals share (each set's own
    overlaps merged first)."""
    xs, ys = union(xs), union(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def loop_stretches(trace) -> list[tuple[float, float]]:
    """The stretches from the end of one ``fit.step`` to the start of the
    next on the main thread. Those before the first step and after the
    last (an epoch's start and end) are not stretches; one that holds two
    ``data.wait`` (the end of an epoch's loader and the next epoch's first
    batch) is left out too."""
    steps = main_ranges(trace, STEP)
    waits = [a for a, _ in main_ranges(trace, WAIT)]
    out = []
    for (_, a), (b, _) in zip(steps, steps[1:]):
        if bisect.bisect_left(waits, b) - bisect.bisect_left(waits, a) < 2:
            out.append((a, b))
    return out


def idle_in_span_ms(run, name: str) -> float | None:
    """Device-idle milliseconds per traced step inside the main thread's
    ``name`` spans."""
    t = run.trace
    if t is None or not run.trace_steps:
        return None
    spans = main_ranges(t, name)
    if not spans:
        return None
    return overlap(idle_intervals(t), spans) / 1e3 / run.trace_steps


def idle_loop_ms(run) -> float | None:
    """Device-idle milliseconds per stretch between two steps."""
    t = run.trace
    stretches = loop_stretches(t) if t is not None else []
    if not stretches:
        return None
    return overlap(idle_intervals(t), stretches) / 1e3 / len(stretches)


def wait_ms(run) -> float | None:
    """Main-thread milliseconds in ``data.wait`` per stretch between two
    steps: each step's wait for its batch, without an epoch's first (the
    first batch's pin and copy) and the one that finds the loader done."""
    t = run.trace
    stretches = loop_stretches(t) if t is not None else []
    waits = main_ranges(t, WAIT) if stretches else []
    if not waits:
        return None
    return overlap(waits, stretches) / 1e3 / len(stretches)


def idle_by_span(trace) -> dict[str, dict]:
    """{row: {'us': idle microseconds, 'ops': {host op: us}}}: the window's
    idle time cut at every boundary of the main thread's host ranges, each
    piece put to the innermost program span it lies in (``PROGRAM``, or the
    optimizer's range; outside them 'before the first step', 'between
    steps' or 'after the last step') and to the innermost host operation
    ('(python)' where none). The rows add up to the window's idle time."""
    main = [e for e in trace._host if e.get("tid") == trace.main_tid and e.get("name") != WINDOW]
    spans = [e for e in main if e.get("cat") == "user_annotation"]
    ops = [e for e in main if e.get("cat") == "cpu_op"]
    edges = sorted({float(e["ts"]) for e in main}
                   | {float(e["ts"]) + float(e.get("dur", 0)) for e in main})
    pieces = []
    for a, b in idle_intervals(trace):
        cuts = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        pieces += [(x, y) for x, y in zip(cuts, cuts[1:]) if y > x]
    points = [(trace.main_tid, (x + y) / 2, i) for i, (x, y) in enumerate(pieces)]
    span_at, op_at = _stacks_at(spans, points), _stacks_at(ops, points)
    steps = main_ranges(trace, STEP)
    first, last = (steps[0][0], steps[-1][1]) if steps else (trace.t1, trace.t1)
    rows: dict[str, dict] = {}
    for i, (x, y) in enumerate(pieces):
        inner = [n for n in span_at.get(i, ()) if n in PROGRAM or n.startswith(OPTIMIZER)]
        mid = (x + y) / 2
        if inner:
            row = inner[-1]
        elif mid < first:
            row = "before the first step"
        else:
            row = "between steps" if mid <= last else "after the last step"
        op = (op_at.get(i) or ("(python)",))[-1]
        entry = rows.setdefault(row, {"us": 0.0, "ops": defaultdict(float)})
        entry["us"] += y - x
        entry["ops"][op] += y - x
    return rows
