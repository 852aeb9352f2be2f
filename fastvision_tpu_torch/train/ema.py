"""Exponential moving average of model tensors (port of
fastvision_tpu/train/ema.py).

The decay warms up as min(decay, (1 + t) / (10 + t)), so early steps are not
anchored to the initial weights. The update runs in place under
``torch.no_grad`` with one fused multi-tensor op per term, so the shadow
copy costs no allocation per step.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor], step: int,
               decay: float = 0.9999) -> Sequence[torch.Tensor]:
    """ema <- ema * d + tensors * (1 - d), d = min(decay, (1 + step) / (10 + step)),
    in place; returns ``ema``. ``d`` is rounded to float32 as the JAX package
    computes it."""
    step = np.float32(step)
    d = min(np.float32(decay), (np.float32(1.0) + step) / (np.float32(10.0) + step))
    ema = list(ema)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, [t.to(e.dtype) for e, t in zip(ema, tensors)],
                        alpha=float(np.float32(1.0) - d))
    return ema


def make_ema_update(decay: float = 0.9999):
    """-> update(ema, tensors, step) with ``decay`` bound."""
    return lambda ema, tensors, step: ema_update(ema, tensors, step, decay)
