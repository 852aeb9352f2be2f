"""Optimizers: SGD / Adam with decay on kernels only (port of
fastvision_tpu/train/optim.py).

The JAX package chains ``clip_by_global_norm -> add_decayed_weights(mask)
-> trace(nesterov) | scale_by_adam -> scale(-lr)``. Two torch param groups
give the same updates: rank > 1 parameters (conv and linear kernels) with
``weight_decay``, the rest (biases, BN scales and shifts) without.
``torch.optim.SGD(momentum, nesterov=True, dampening=0, weight_decay)`` adds
the decayed weights to the gradient before the momentum, as the chain does,
and ``torch.optim.Adam(betas, eps=1e-8, weight_decay)`` is the same coupled
L2. Global-norm clipping runs as a step pre-hook with optax's rule (the
gradients unchanged when the norm is below the limit, else scaled by
limit / norm), over the trainable parameters only. Frozen parameters are
left out of the optimizer: they still get gradients, but never move.

The learning rate is set per step from the host (`set_lr`).

Not ported yet: ``accum_steps > 1`` (optax.MultiSteps).
"""
from __future__ import annotations

from typing import Mapping

import torch
from torch import nn


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """True for the parameters that take weight decay: rank > 1 kernels."""
    return {name: p.ndim > 1 for name, p in model.named_parameters()}


def clip_grads_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g stays when ||g|| < max_norm,
    else becomes g / ||g|| * max_norm. No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


def build_optimizer(
    name: str,
    model: nn.Module,
    weight_decay: float = 5e-4,
    momentum: float = 0.937,
    nesterov: bool = True,
    betas: tuple[float, float] = (0.937, 0.999),
    grad_clip_norm: float = 0.0,
    trainable: Mapping[str, bool] | None = None,
    accum_steps: int = 1,
) -> torch.optim.Optimizer:
    """SGD (nesterov momentum) or Adam over ``model``'s parameters, with
    weight decay on kernels only, optional global-norm clipping, and an
    optional ``trainable`` map (parameter name -> bool) whose False entries
    are frozen. The learning rate starts at 0: set it with `set_lr`."""
    if accum_steps > 1:
        raise NotImplementedError(
            "accum_steps > 1 (optax.MultiSteps) is not ported yet (ROADMAP Queue 1, item 10); "
            "make_train_step(accum_steps=...) accumulates within a step")
    mask = decay_mask(model)
    groups: dict[bool, list] = {True: [], False: []}
    for pname, p in model.named_parameters():
        if trainable is None or trainable.get(pname, True):
            groups[bool(weight_decay) and mask[pname]].append(p)
    param_groups = [{"params": groups[True], "weight_decay": weight_decay},
                    {"params": groups[False], "weight_decay": 0.0}]
    if name == "sgd":
        opt = torch.optim.SGD(param_groups, lr=0.0, momentum=momentum, dampening=0.0,
                              nesterov=nesterov)
    elif name == "adam":
        opt = torch.optim.Adam(param_groups, lr=0.0, betas=betas, eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip_norm and grad_clip_norm > 0:
        params = groups[True] + groups[False]
        opt.register_step_pre_hook(
            lambda *_: clip_grads_by_global_norm_(params, grad_clip_norm))
    return opt


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    """The learning rate last set (for logging)."""
    return float(optimizer.param_groups[0]["lr"])
