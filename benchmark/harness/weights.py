"""Weights made on the card from the seed, in a few large calls.

Every floating tensor of the reference model's state dict gets
``normal * scale + shift`` from one draw of a ``torch.Generator`` on the
device: a conv followed by BN kaiming-normal fan_out (the program's own
init rule), a biased conv or a linear layer normal with variance 1 /
fan_in, biases and BN shifts 0, BN scales 1, running means 0 and
variances 1. The same seed gives the same tensors, on the program's side
and on the reference's.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _rule(name: str, shape: tuple, names: set) -> tuple[float, float]:
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        if len(shape) == 4 and name[: -len("weight")] + "bias" not in names:
            return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))), 0.0
        return math.sqrt(1.0 / fan_in), 0.0
    if name.endswith("running_var"):
        return 0.0, 1.0
    if name.endswith(".weight"):  # a BN scale
        return 0.0, 1.0
    return 0.0, 0.0


def make_weights(model: nn.Module, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """{state-dict name: tensor on ``device``} for ``model`` (any device,
    meta included: only names and shapes are read)."""
    sd = model.state_dict()
    names = set(sd)
    floats = [(n, tuple(t.shape)) for n, t in sd.items() if t.is_floating_point()]
    counts = [math.prod(s) for _, s in floats]
    rules = [_rule(n, s, names) for n, s in floats]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(counts)
    counts_t = torch.tensor(counts, device=device)
    scale = torch.tensor([r[0] for r in rules], device=device)
    shift = torch.tensor([r[1] for r in rules], device=device)
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(scale.repeat_interleave(counts_t, output_size=total))
    flat.add_(shift.repeat_interleave(counts_t, output_size=total))
    out = {n: part.view(s) for (n, s), part in zip(floats, flat.split(counts))}
    for n, t in sd.items():
        if not t.is_floating_point():  # BN's num_batches_tracked
            out[n] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return {n: out[n] for n in sd}
