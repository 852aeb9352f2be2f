"""Floating-point operations of one step, counted once from the shapes.

``FlopCounterMode`` runs the benchmark's own reference model on the meta
device at the cell's batch and input size: no memory, no time, and the
same count whatever the program runs the work with. A training step is
the forward and the backward as autograd runs them (the stem's input
needs no gradient, so its backward conv counts the weight gradient
alone); a detection call is the forward. Convolutions (forward and
backward) are counted apart for the conv roofline.
"""
from __future__ import annotations

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import build

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def step_flops(cfg: dict, batch: int, train: bool) -> dict[str, float]:
    """{'total': FLOPs, 'conv': FLOPs of the convolutions} of one step."""
    with torch.device("meta"):
        model = build(cfg)
        model.train(train)
        x = torch.zeros(batch, cfg["input_size"], cfg["input_size"], 3, dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            out = model(x)
            if train:
                outs = out if isinstance(out, (list, tuple)) else [out]
                sum(o.float().sum() for o in outs).backward()
    counts = counter.get_flop_counts()["Global"]
    conv = sum(v for op, v in counts.items() if "convolution" in str(op))
    return {"total": float(sum(counts.values())), "conv": float(conv)}


def peak(kind: str, device_name: str) -> float | None:
    """The published peak ``kind`` ('bfloat16' FLOP/s, 'bytes' per second,
    ...) of the card named ``device_name``, from ``peaks.json``; None for a
    card the table does not name."""
    with open(PEAKS) as f:
        table = json.load(f)
    for entry in table["cards"]:
        if any(part in device_name for part in entry["match"]):
            return entry["peaks"].get(kind)
    return None
