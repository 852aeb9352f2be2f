"""One run of one cell: the entry's work, the comparison, the metrics, and
the result line with each compared number beside its limit."""
from __future__ import annotations

import json
import sys

from .cells import Cell, finite, forbidden_modules, load_entry, read_metric, result_line
from .compare import judge


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault: str | None = None) -> tuple[str, list[str]]:
    """-> (the result line, the check's lines for standard error). Raises
    SystemExit when JAX or the JAX package was loaded."""
    out = load_entry(cell).run(cell, seed, seconds, trace, device, t_start, fault)
    correct, check = judge(out["readings"], cell.limits["limits"])
    info = out["run"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": info.device_name, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    breakdown = None
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(cell, m, info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if info.device_trace is not None:
            dev["busy_s"] = info.device_trace.busy_s
            dev["window_s"] = info.device_trace.window_s
        if info.trace is not None:
            breakdown = {"device_ops": info.trace.top_ops(10),
                         "idle_gaps": info.trace.idle_gaps(10)}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded in the result's process: {bad} (JAX or the JAX package)")
    lines = [f"readings: {json.dumps(finite(out['readings']))}"]
    for label, t in (("card alone", info.device_trace), ("host and card", info.trace)):
        if t is not None:
            lines.append(f"traced slice, {label}: busy {t.busy_s!r} s of {t.window_s!r} s")
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in check.items()]
    lines.append(f"correct: {correct}")
    return result_line(correct, out["attempted"], out["failed"], metrics, dev, check,
                       breakdown), lines


def emit(line: str, lines: list[str]) -> None:
    print(line, flush=True)
    for text in lines:
        print(text, file=sys.stderr, flush=True)
