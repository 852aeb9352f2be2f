"""The port's program spans (core/telemetry.py::span) and the rates `Fit`
logs: a span costs one check without a profiler; under ``trace()`` a
`Fit` over `YOLOv3Loss` writes each span once where it should, nested as
the train path nests; the epoch's rate waits for its last loss read."""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch import nn

import fastvision_tpu_torch.core.telemetry as telemetry
import fastvision_tpu_torch.train as tt

C, A, S, B = 2, 3, 64, 2
ANCHORS = np.array([[[16, 16], [24, 12], [12, 24]]] * 3, np.float32)
LEVELS = (32, 16, 8)
SPANS = ("data.wait", "fit.step", "step.forward", "step.loss", "step.backward", "loss.targets")


class TinyHeads(nn.Module):
    """One 1x1 conv pooled to the three YOLO levels: heads [B, H, W, A, 5 + C]."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, A * (5 + C), 1)

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2))
        heads = []
        for s in LEVELS:
            p = nn.functional.avg_pool2d(y, s)
            b, _, h, w = p.shape
            heads.append(p.permute(0, 2, 3, 1).reshape(b, h, w, A, 5 + C))
        return heads


class Batches:
    """A train loader of ``n`` seeded batches an epoch."""

    def __init__(self, n: int):
        rng = np.random.default_rng(0)
        labels = np.full((B, 3, 5), -1.0, np.float32)
        labels[:, 0] = [0, 0.5, 0.5, 0.3, 0.4]
        self.batches = [{"images": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
                         "labels": labels} for _ in range(n)]

    def epoch(self, epoch: int, start_batch: int = 0):
        return iter(self.batches[start_batch:])


class Records:
    def __init__(self):
        self.records = []

    def log(self, step, **metrics):
        self.records.append(metrics)


def _fit(n_steps: int, step_fn=None, accum: int = 1, **kw):
    torch.manual_seed(0)
    model = TinyHeads()
    loss = tt.YOLOv3Loss(ANCHORS, LEVELS, num_classes=C)

    def loss_fn(heads, batch):
        return loss(heads, batch["labels"]).total, {}

    if accum > 1:
        step_fn = tt.make_train_step(loss_fn, accum_steps=accum)
    log = Records()
    fit = tt.Fit(model, loss_fn, tt.build_optimizer("sgd", model), Batches(n_steps), epochs=1,
                 schedule=tt.constant_lr(1e-3), logger=log, step_fn=step_fn, device="cpu", **kw)
    return fit, log


def test_span_without_a_profiler_checks_only(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    with telemetry.span("fit.step") as s:
        pass
    assert opened == [] and s._range is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with telemetry.span("fit.step"):
            pass
    assert opened == ["fit.step"]


def _ranges(trace_dir: str) -> dict[str, list[tuple[float, float, int]]]:
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = {name: [] for name in SPANS}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in out:
            out[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"]))
    return {k: sorted(v) for k, v in out.items()}


def _inside(r, outer) -> bool:
    return any(o[2] == r[2] and o[0] <= r[0] and r[1] <= o[1] for o in outer)


@pytest.mark.parametrize("accum", [1, 2])
def test_fit_spans_under_trace(tmp_path, accum):
    n = 3
    fit, _ = _fit(n, accum=accum)
    with telemetry.trace(str(tmp_path)) as d:
        fit.run()
    r = _ranges(d)
    counts = {k: len(v) for k, v in r.items()}
    # a wait before each step, and the last one, which finds the loader done
    assert counts == {"data.wait": n + 1, "fit.step": n, "step.forward": n * accum,
                      "step.loss": n * accum, "step.backward": n * accum,
                      "loss.targets": n * accum * len(LEVELS)}
    assert len({t for v in r.values() for *_, t in v}) == 1  # all on the caller's thread
    assert all(_inside(x, r["step.loss"]) for x in r["loss.targets"])
    for name in ("step.forward", "step.loss", "step.backward"):
        assert all(_inside(x, r["fit.step"]) for x in r[name])
    steps = r["fit.step"]
    assert not any(w[0] < s[1] and s[0] < w[1] for w in r["data.wait"] for s in steps)
    # each step's wait comes before it, the last one after every step
    assert [sum(w[1] <= s[0] for w in r["data.wait"]) for s in steps] == list(range(1, n + 1))
    assert r["data.wait"][-1][0] >= steps[-1][1]


class SlowRead:
    """A device loss stand-in whose read takes ``delay`` seconds."""

    def __init__(self, value: float, delay: float):
        self.value, self.delay = value, delay

    def __add__(self, other):
        return SlowRead(self.value + other.value, self.delay)

    def __float__(self):
        time.sleep(self.delay)
        return self.value


def test_epoch_rate_waits_for_the_loss_read():
    delay, n = 0.2, 2

    def step_fn(state, batch, lr):
        return state, {"loss": SlowRead(1.0, delay)}

    fit, log = _fit(n, step_fn, log_every=1)
    fit.run()
    steps = [r for r in log.records if "img_per_sec" in r]
    (epoch,) = [r for r in log.records if "epoch_img_s" in r]
    # each logged step reads its loss; the epoch reads those and its sum
    assert len(steps) == n and all(r["img_per_sec"] <= B / delay for r in steps)
    assert epoch["epoch_img_s"] <= n * B / ((n + 1) * delay)
    assert epoch["train_loss"] == 1.0
