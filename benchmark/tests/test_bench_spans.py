"""The readers of the program's spans (harness/spans.py and the four
metrics on it) on hand-built Chrome-trace events: idle time cut by
overlap, the loop's stretches without the slice's start and end, the
first and last ``data.wait`` left out, nothing read without the spans."""
import os
import time

import pytest
import torch

from harness.cells import BENCH_DIR, _module, load_entry, read_metric
from harness.readers import RunInfo
from harness.spans import idle_by_span, loop_stretches
from harness.trace import WINDOW, Trace
from test_bench_faults import small

METRICS = ("idle_loss_ms.train", "idle_loop_ms.train", "data_wait_ms.train",
           "loss_targets_ms.train")


def _x(name, cat, ts, end, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts, "tid": tid,
            "args": args}


def _span(name, ts, end):
    return _x(name, "user_annotation", ts, end)


def _kernel(ts, end, corr=None):
    return _x(f"k{ts}", "kernel", ts, end, tid=7, **({"correlation": corr} if corr else {}))


def _read(trace, steps=2):
    run = RunInfo(cell=None, device_name="cpu", step_flops={}, window_s=0.0, window_steps=0,
                  trace=trace, trace_steps=steps)
    return {m: _module(os.path.join(BENCH_DIR, "metrics", f"{m}.py"),
                       "span_metric_" + m.replace(".", "_")).read(run) for m in METRICS}


# two steps: busy [5, 26), [33, 64), [66, 90), [110, 124), [130, 150) of the
# window [0, 200); idle [0, 5), [26, 33), [64, 66), [90, 110), [124, 130), [150, 200)
EVENTS = [
    _span(WINDOW, 0, 200),
    _span("data.wait", 0, 10),  # the epoch's first: the first batch's pin and copy
    _span("fit.step", 10, 60),
    _span("step.forward", 12, 25),
    _span("step.loss", 25, 40),
    _span("loss.targets", 27, 30),
    _x("aten::copy_", "cpu_op", 27.5, 29.5),
    _x("cudaLaunchKernel", "cuda_runtime", 29.6, 29.8, correlation=1),
    _span("step.backward", 40, 55),
    _span("Optimizer.step#SGD.step", 55, 59),
    _span("data.wait", 62, 70),
    _span("fit.step", 72, 122),
    _span("step.loss", 85, 98),  # the gap [90, 110) has its middle past the span's end
    _span("step.backward", 100, 120),
    _span("data.wait", 125, 128),  # the one that finds the loader done
    _kernel(5, 26), _kernel(33, 64, corr=1), _kernel(66, 90), _kernel(110, 124),
    _kernel(130, 150),
]


def test_span_metrics_cut_by_overlap_and_leave_the_ends_out():
    got = _read(Trace(EVENTS))
    assert got == {
        "idle_loss_ms.train": pytest.approx((7 + 8) / 2 / 1e3),  # [26, 33) and [90, 98)
        "idle_loop_ms.train": pytest.approx(2 / 1e3),  # [64, 66) between the steps only
        "data_wait_ms.train": pytest.approx(8 / 1e3),  # the wait [62, 70) alone
        "loss_targets_ms.train": pytest.approx(31 / 2 / 1e3),  # the kernel launched inside
    }


def test_idle_by_span_adds_up_to_the_idle_time():
    t = Trace(EVENTS)
    rows = idle_by_span(t)
    assert sum(r["us"] for r in rows.values()) == pytest.approx(t.window_s * 1e6 - t.busy_s * 1e6)
    us = {k: r["us"] for k, r in rows.items()}
    assert us == pytest.approx({
        "after the last step": 1 + 2 + 50,  # out of the last wait
        "data.wait": 5 + 2 + 3, "step.loss": 4 + 8, "loss.targets": 3,
        "fit.step": 2, "step.backward": 10,
    })
    assert rows["loss.targets"]["ops"] == pytest.approx({"aten::copy_": 2.0, "(python)": 1.0})


def test_epoch_boundary_is_no_stretch():
    ev = [_span(WINDOW, 0, 100), _span("fit.step", 0, 10), _span("data.wait", 12, 14),
          _span("data.wait", 20, 25), _span("fit.step", 30, 40), _kernel(0, 5)]
    t = Trace(ev)
    assert loop_stretches(t) == []
    got = _read(t)
    assert got["idle_loop_ms.train"] is None and got["data_wait_ms.train"] is None


def test_no_spans_no_reading():
    ev = [_span(WINDOW, 0, 100), _x("aten::mm", "cpu_op", 1, 3),
          _x("cudaLaunchKernel", "cuda_runtime", 2, 2.5, correlation=1), _kernel(4, 9, corr=1)]
    assert _read(Trace(ev)) == dict.fromkeys(METRICS)
    assert _read(None) == dict.fromkeys(METRICS)


@pytest.mark.parametrize("name", ["yolov3-416.train-b256", "resnet50-224.train-b256"])
def test_traced_run_reads_the_program_spans(name):
    """The whole traced run on the CPU at a small size: the span metrics
    read numbers (the target assignment's kernels need a card)."""
    cell = small(name)
    cell.traffic["trace_steps"] = 3
    out = load_entry(cell).run(cell, 2**31 + 11, 0.2, True, torch.device("cpu"), time.time())
    got = {m["name"]: read_metric(cell, m, out["run"]) for m in cell.per_layer}
    assert all(got[m] >= 0 for m in METRICS[:3])
    assert got.get("loss_targets_ms.train") is None
