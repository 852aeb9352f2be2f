"""Training cells: the port's ``Fit.run`` driving its train step.

Set-up builds one `Fit` (the model with the seeded weights, the port's
SGD, and the loss and ``make_train_step`` in the configuration's dtype as
``benchmark/programs/<model>.py`` builds them) and feeds
it the traffic's pool through its own loader interface (``epoch()``)
and ``prefetch_to_device``. The same object then:

1. trains ``compare_steps`` steps, one epoch each, on the pool's first
   batches; the first step's forward outputs (a hook), the momentum
   buffers after it and the parameters' change after the last are read
   for the comparison, and each epoch's logged loss is that step's;
2. trains ``warmup_steps`` more, which finish the warm-up;
3. trains the window: one epoch whose loader hands out the pool's batches
   in turn until ``seconds`` have passed since the window opened; the
   epoch's end reads its loss sum, which waits for the last step on the
   card, so the window holds all the work of its steps;
4. with ``trace``, trains ``trace_steps`` more under a profiler of the
   card alone (the busy share: the profiler then adds little to each
   launch), and ``trace_steps`` more under one of the host and the card
   (which host range launched each kernel).

Then the program is freed and the reference trains the same first steps
from the same seeded weights (`reference.train`).
"""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from harness.cells import by_model
from harness.compare import train_readings
from harness.flops import step_flops
from harness.readers import RunInfo
from harness.trace import profiled
from harness.traffic import train_pool
from harness.weights import make_weights
from reference import build as build_reference
from reference.train import leaf_norms, outputs, reference_steps

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Feed:
    """The program's train loader: ``epoch(e)`` hands out the pool's
    batches at the indices ``plan(e)`` yields."""

    def __init__(self, pool: list[dict]):
        self.pool = pool
        self.plan = lambda epoch: iter(())

    def epoch(self, epoch: int, start_batch: int = 0):
        return (self.pool[i % len(self.pool)] for i in self.plan(epoch))


class Capture:
    """A `Fit` logger that keeps each record."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, step: int, **metrics) -> None:
        self.records.append(metrics)


def _timed(start: int, t0: float, seconds: float):
    i = start
    while True:
        yield i
        i += 1
        if time.perf_counter() - t0 >= seconds:
            return


def _fault_step(step_fn, fault: str):
    """The timed path broken underneath, for the harness's own tests:
    'frozen' leaves the parameters where they are (learning rate 0),
    'half_batch' trains on the first half of each batch."""
    def frozen(state, batch, lr):
        return step_fn(state, batch, 0.0)

    def half(state, batch, lr):
        n = batch["images"].shape[0] // 2
        return step_fn(state, {**batch, "images": batch["images"][:n],
                               "labels": batch["labels"][:n]}, lr)

    return {"frozen": frozen, "half_batch": half}[fault]


def build_program(cfg: dict, weights: dict, feed: Feed, device: torch.device, seed: int,
                  fault: str | None = None):
    """The port's `Fit` over the configuration's model, loss and SGD, as
    ``benchmark/programs/<model>.py`` builds them."""
    from fastvision_tpu_torch.train import Fit, build_optimizer, constant_lr

    dtype = DTYPES[cfg["dtype"]]
    program = by_model("programs", cfg)
    with torch.device("meta"):
        model = program.model(cfg)
    model = model.to_empty(device=device)
    if set(model.state_dict()) != set(weights):
        raise RuntimeError("the program's state-dict names differ from the reference's: "
                           f"{sorted(set(model.state_dict()) ^ set(weights))[:8]}")
    model.load_state_dict(weights)
    opt = cfg["optimizer"]
    optimizer = build_optimizer(opt["name"], model, weight_decay=opt["weight_decay"],
                                momentum=opt["momentum"], nesterov=opt["nesterov"])
    loss_fn, step_fn = program.step(cfg, dtype)
    if fault:
        step_fn = _fault_step(step_fn, fault)
    capture = Capture()
    fit = Fit(model, loss_fn, optimizer, feed, epochs=0, schedule=constant_lr(opt["lr"]),
              logger=capture, step_fn=step_fn, dtype=dtype, device=device, seed=seed)
    return fit, capture


def _epochs(fit, n: int) -> None:
    fit.start_epoch, fit.epochs = fit.epochs, fit.epochs + n
    fit.run()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_start: float,
        fault: str | None = None) -> dict:
    cfg, traffic = cell.config, cell.traffic
    batch = traffic["batch"]
    with torch.device("meta"):
        shapes = build_reference(cfg)
    stamp = _Stamps(t_start)
    pool = train_pool(cfg, traffic, seed, device)
    stamp("pool")
    weights = make_weights(shapes, seed, device)
    feed = Feed(pool)
    fit, capture = build_program(cfg, weights, feed, device, seed, fault)
    stamp("program")
    model, optimizer = fit.state.model, fit.state.optimizer
    params = dict(model.named_parameters())

    n_cmp = traffic["compare_steps"]
    feed.plan = lambda epoch: [epoch]
    first_out = []
    hook = model.register_forward_hook(lambda m, i, o: first_out.append(outputs(o)))
    _epochs(fit, 1)
    hook.remove()
    prog = {"out": first_out[0],
            "grad": leaf_norms({n: optimizer.state[p]["momentum_buffer"]
                                for n, p in params.items()})}
    _epochs(fit, n_cmp - 1)
    with torch.no_grad():
        prog["delta"] = leaf_norms({n: p - weights[n] for n, p in params.items()})
    prog["loss"] = [r["train_loss"] for r in capture.records if "train_loss" in r]
    del weights
    first = n_cmp
    feed.plan = lambda epoch: range(first, first + traffic["warmup_steps"])
    _epochs(fit, 1)
    stamp("first steps")

    _sync(device)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    start_step = fit.global_step
    cursor = first + traffic["warmup_steps"]
    feed.plan = lambda epoch: _timed(cursor, t0, seconds)
    _epochs(fit, 1)
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = fit.global_step - start_step
    window_loss = capture.records[-1]["train_loss"]

    info = RunInfo(cell=cell, device_name=_device_name(device),
                   step_flops=step_flops(cfg, batch, train=True),
                   window_s=window_s, window_steps=steps)
    if trace:
        n = info.trace_steps = traffic["trace_steps"]
        cursor += steps
        feed.plan = lambda epoch: range(cursor, cursor + n)
        _, info.device_trace = profiled(lambda: _epochs(fit, 1), device, host=False)
        cursor += n
        _, info.trace = profiled(lambda: _epochs(fit, 1), device, host=True)
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del fit, model, optimizer, params, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, make_weights(shapes, seed, device), pool[:n_cmp], device)
    readings = train_readings(prog, ref)
    readings.update(program_loss=prog["loss"], reference_loss=ref["loss"])
    return {"end_to_end": {"train_img_s": steps * batch / window_s, "setup_s": setup_s},
            "attempted": steps, "failed": 0 if math.isfinite(window_loss) else steps,
            "readings": readings, "memory_peak_bytes": peak_bytes, "run": info}


class _Stamps:
    """Prints each set-up phase's end, in seconds since the process began."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        print(f"set-up: imports {time.time() - t_start:.2f} s", file=sys.stderr)

    def __call__(self, phase: str) -> None:
        print(f"set-up: {phase} {time.time() - self.t_start:.2f} s", file=sys.stderr)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
