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

``accum_steps = k > 1`` wraps the optimizer in `MultiSteps`, optax's
``MultiSteps(every_k_schedule=k)``: each call adds its gradients into a
running mean, and every k-th call applies the optimizer (the clip, the decay
and the momentum included) to that mean once; the other calls move nothing.
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
    else becomes g / ||g|| * max_norm, ||g|| over the whole model (FSDP's
    shards and tensor parallel slices included) in float32, or float64 for
    float64 gradients, as optax computes it in the gradients' dtype. No
    host sync."""
    from ..parallel.tensor_shard import tp_global_norm

    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    if not grads:
        return
    acc = torch.float64 if any(g.dtype == torch.float64 for g in grads) else torch.float32
    norms = [torch.linalg.vector_norm(g.to(acc)) for g in grads]
    if hasattr(norms[0], "full_tensor"):  # FSDP's sharded gradients: scale the local shards
        norm = torch.linalg.vector_norm(torch.stack(norms)).full_tensor()
        grads = [g.to_local() for g in grads]
    else:  # tensor parallel slices count once over the model axis
        norm = tp_global_norm(norms, params)
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
) -> "torch.optim.Optimizer | MultiSteps":
    """SGD (nesterov momentum) or Adam over ``model``'s parameters, with
    weight decay on kernels only, optional global-norm clipping, and an
    optional ``trainable`` map (parameter name -> bool) whose False entries
    are frozen, and with ``accum_steps > 1`` the gradients of that many
    calls averaged before each update (`MultiSteps`). The learning rate
    starts at 0: set it with `set_lr`."""
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
        # the optimizer's own parameters at each step: FSDP replaces them
        opt.register_step_pre_hook(lambda o, *_: clip_grads_by_global_norm_(
            [p for g in o.param_groups for p in g["params"]], grad_clip_norm))
    return MultiSteps(opt, accum_steps) if accum_steps > 1 else opt


class MultiSteps:
    """Gradient accumulation across calls around a torch optimizer, with
    optax ``MultiSteps(every_k_schedule=k, use_grad_mean=True)``'s
    semantics. Each `step` folds the parameters' ``.grad`` into float32
    running means, ``acc += (grad - acc) / (n + 1)`` at the n-th call of a
    cycle (a missing ``.grad`` counts as zero, as the JAX package's zero
    gradient of an unused parameter). The k-th call sets each ``.grad`` to
    its mean, steps the inner optimizer (its pre-hooks, the clip, run once,
    on the mean) and resets the means; the other calls leave the parameters
    and the inner state as they are. Parameters the inner optimizer does
    not hold (frozen ones) are not accumulated. ``param_groups`` are the
    inner optimizer's (`set_lr` reaches them; the learning rate of the k-th
    call is the one applied); the state dict carries the means and the
    position in the cycle, so a resume mid-cycle continues it."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.rebind()

    def rebind(self) -> None:
        """Follow the inner optimizer's parameters afresh (FSDP replaces a
        model's parameters; `parallel.fsdp.rebind_optimizer`), with zeroed
        means."""
        self.params = [p for g in self.inner.param_groups for p in g["params"]]
        self.acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @property
    def param_groups(self) -> list[dict]:
        return self.inner.param_groups

    def _follow_params(self) -> None:
        """Moves the means to their parameters' device: a model moved after
        the optimizer was built (`TrainState.create`) keeps its Parameter
        objects, whose data now lives elsewhere."""
        if any(a.device != p.device for a, p in zip(self.acc, self.params)):
            self.acc = [a.to(p.device) for a, p in zip(self.acc, self.params)]

    @torch.no_grad()
    def step(self) -> None:
        self._follow_params()
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            if p.grad is None:
                acc.sub_(acc / (n + 1))
            else:
                acc.add_((p.grad.float() - acc) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.to(p.dtype, copy=True)
        self.inner.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "every_k": self.every_k,
                "mini_step": self.mini_step, "acc": list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        if state.get("every_k") != self.every_k:
            raise ValueError(f"optimizer state accumulates over {state.get('every_k')} calls, "
                             f"this optimizer over {self.every_k}")
        self.inner.load_state_dict(state["inner"])
        self._follow_params()
        for acc, saved in zip(self.acc, state["acc"], strict=True):
            acc.copy_(saved)
        self.mini_step = int(state["mini_step"])


def set_lr(optimizer: "torch.optim.Optimizer | MultiSteps", lr: float) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_lr(optimizer: "torch.optim.Optimizer | MultiSteps") -> float:
    """The learning rate last set (for logging)."""
    return float(optimizer.param_groups[0]["lr"])
