"""LR schedules: cosine / linear / exponential between (initial, final),
warmup + cosine (+ restarts), step decay, and plateau (a copy of
fastvision_tpu/train/schedulers.py, which is pure Python).

Step-based schedules are plain ``step -> lr`` callables; `PlateauScheduler`
is host-side state updated once per epoch from a validation metric.
"""
from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_lr(initial_lr: float, final_lr: float, total_steps: int) -> Schedule:
    def fn(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        return final_lr + 0.5 * (initial_lr - final_lr) * (1 + math.cos(math.pi * t))

    return fn


def linear_lr(initial_lr: float, final_lr: float, total_steps: int) -> Schedule:
    def fn(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        return initial_lr + (final_lr - initial_lr) * t

    return fn


def exponential_lr(initial_lr: float, final_lr: float, total_steps: int) -> Schedule:
    ratio = final_lr / max(initial_lr, 1e-12)

    def fn(step: int) -> float:
        t = min(step, total_steps) / max(total_steps, 1)
        return initial_lr * ratio**t

    return fn


def step_decay_lr(initial_lr: float, decay_every: int, gamma: float = 0.1) -> Schedule:
    def fn(step: int) -> float:
        return initial_lr * gamma ** (step // max(decay_every, 1))

    return fn


def warmup_cosine_lr(
    initial_lr: float,
    final_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    warmup_init_lr: float = 0.0,
    cycles: int = 1,
) -> Schedule:
    """Linear warmup then ``cycles`` cosine annealings to final_lr (cycles > 1
    restarts each cycle at initial_lr; equal cycle lengths)."""
    cycle_len = max((total_steps - warmup_steps) // max(cycles, 1), 1)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return warmup_init_lr + (initial_lr - warmup_init_lr) * step / max(warmup_steps, 1)
        s = (step - warmup_steps) % cycle_len
        t = s / cycle_len
        return final_lr + 0.5 * (initial_lr - final_lr) * (1 + math.cos(math.pi * t))

    return fn


def constant_lr(lr: float) -> Schedule:
    return lambda step: lr


class PlateauScheduler:
    """Multiply the LR by ``gamma`` after ``patience`` epochs without metric
    improvement. Call `update(metric)` once per epoch and multiply its
    factor into the base schedule's value."""

    def __init__(self, patience: int = 3, gamma: float = 0.1, mode: str = "min",
                 min_scale: float = 1e-4):
        self.patience = patience
        self.gamma = gamma
        self.mode = mode
        self.min_scale = min_scale
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        improved = (
            self.best is None
            or (metric < self.best if self.mode == "min" else metric > self.best)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.scale = max(self.scale * self.gamma, self.min_scale)
                self.bad_epochs = 0
        return self.scale


SCHEDULES = {
    "cosine": cosine_lr,
    "linear": linear_lr,
    "exponential": exponential_lr,
}
