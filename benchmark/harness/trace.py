"""The traced slice: torch.profiler over a stretch of the program's steady
work, read back from its Chrome trace into device intervals, each device
operation with the host operations it was launched under.

``profiled(fn)`` runs ``fn`` inside the profiler and a ``bench.window``
range, writes the trace once under TMPDIR, reads it and deletes it. A
trace of the card alone (``host=False``) has no host ranges: its window is
the span from its first device operation's start to its last one's end.
``Trace`` then answers: the device's busy seconds in the window (the
union of kernel, copy and set intervals), the device seconds of the
operations launched under given host ranges or matching given names, the
top operations, and the idle gaps by what the host's main thread was in.

The method is ``chip_smoke.py::device_profile``'s (chip_smoke.py:680):
profile the CPU and the card over steady work, sum the device time by
kernel, take the busy share of the wall time; read here from the Chrome
trace, so that each kernel is tied to the host range that launched it,
and ranges (``Optimizer.step#...``) count by category, not by name.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass

WINDOW = "bench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


@dataclass
class DeviceOp:
    name: str
    start: float  # microseconds on the trace's clock
    end: float
    host: tuple  # names of the host ranges it was launched under, outermost first


class Trace:
    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        self.main_tid = win[0].get("tid") if win else None
        host = [e for e in xs if e.get("cat") in HOST_CATS]
        launches = [e for e in xs if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})]
        stacks = _stacks_at(host, [(e.get("tid"), float(e["ts"]), ("launch", e["args"]["correlation"]))
                                   for e in launches])
        self.ops = []
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            corr = e.get("args", {}).get("correlation")
            start = float(e["ts"])
            self.ops.append(DeviceOp(e.get("name", "?"), start, start + float(e.get("dur", 0)),
                                     stacks.get(("launch", corr), ())))
        self._host = host
        if win:
            self.t0 = float(win[0]["ts"])
            self.t1 = self.t0 + float(win[0].get("dur", 0))
        elif self.ops:  # the card's work alone: the window is its span
            self.t0 = min(o.start for o in self.ops)
            self.t1 = max(o.end for o in self.ops)
        else:
            raise RuntimeError(f"the trace holds neither a {WINDOW!r} range nor a device operation")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        spans = sorted((max(o.start, self.t0), min(o.end, self.t1)) for o in self.ops
                       if o.end > self.t0 and o.start < self.t1)
        merged: list[list[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def seconds(self, ops=None) -> float:
        return sum(o.end - o.start for o in (self.ops if ops is None else ops)) / 1e6

    def under(self, host_names=(), host_prefixes=(), kernel_patterns=()) -> list[DeviceOp]:
        """Device operations launched under a host range of one of
        ``host_names`` (or whose name starts with one of ``host_prefixes``),
        or whose own name matches one of ``kernel_patterns``."""
        names, pats = set(host_names), [re.compile(p) for p in kernel_patterns]
        return [o for o in self.ops
                if any(h in names or h.startswith(tuple(host_prefixes)) for h in o.host)
                or any(p.search(o.name) for p in pats)]

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = defaultdict(float)
        for o in self.ops:
            by[o.name[:120]] += (o.end - o.start) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds of the device inside the window, summed by the
        innermost host range the main thread was in at each gap's middle."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < self.t1:
            gaps.append((prev, self.t1))
        main = [e for e in self._host if e.get("tid") == self.main_tid]
        stacks = _stacks_at(main, [(self.main_tid, (a + b) / 2, ("gap", i))
                                   for i, (a, b) in enumerate(gaps)])
        by: dict[str, float] = defaultdict(float)
        for i, (a, b) in enumerate(gaps):
            stack = [h for h in stacks.get(("gap", i), ()) if h != WINDOW]
            by[stack[-1][:120] if stack else "(python)"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _stacks_at(host: list[dict], points: list[tuple]) -> dict:
    """{key: names of the host ranges open at (tid, time), outermost
    first} for each (tid, time, key) of ``points``: one sweep per thread
    over its ranges, which nest."""
    by_tid: dict = defaultdict(list)
    for e in host:
        by_tid[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                                     e.get("name", "?")))
    pts_by_tid: dict = defaultdict(list)
    for tid, t, key in points:
        pts_by_tid[tid].append((t, key))
    out = {}
    for tid, pts in pts_by_tid.items():
        ranges = sorted(by_tid.get(tid, []), key=lambda r: (r[0], -r[1]))
        pts.sort(key=lambda p: p[0])
        stack: list[tuple] = []
        i = 0
        for t, key in pts:
            while i < len(ranges) and ranges[i][0] <= t:
                while stack and stack[-1][1] <= ranges[i][0]:
                    stack.pop()
                stack.append(ranges[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[key] = tuple(r[2] for r in stack if r[0] <= t <= r[1])
    return out


def profiled(fn, device, host: bool = True) -> tuple[object, Trace]:
    """(fn's result, the Trace of the run). On a CUDA ``device`` the card's
    work is traced too and synchronized inside the window; there, without
    ``host``, the card's work alone: the profiler then records no host
    operation, which in a launch-bound step slows each launch, and the
    window is the span of the card's work."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            result = fn()
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return result, Trace(events)

