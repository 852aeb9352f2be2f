"""Train and eval steps (port of fastvision_tpu/train/steps.py).

One train step is forward (train mode, bf16 autocast when the step's dtype
is bf16) -> loss in float32 -> backward -> the host-scheduled learning rate
-> optimizer step. Parameters, optimizer state and BN statistics stay
float32. The step's loss and gradient norm stay on the device: nothing in
the step waits for the card.

A ``batch_transform`` (mixup / cutmix, `train.mix`) edits the batch on the
device before the forward, with a numpy Generator seeded from
(``transform_seed``, step); a step called with a ``torch.Generator``
(`Fit` passes one seeded from (seed, step)) hands it to models that draw
dropout masks (VGG's classifier).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.pipeline import normalize_images
from ..device import resolve_device
from ..nn.layers import memory_format_for
from .optim import set_lr


def device_batch(batch: dict) -> dict:
    """Keep only the array-typed values of a loader batch (drops meta, ids,
    counts), so it can go straight into a step."""
    return {k: v for k, v in batch.items() if isinstance(v, (torch.Tensor, np.ndarray))}


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, and the
    number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               device: str | torch.device | None = None) -> "TrainState":
        """Moves ``model`` to ``device`` (None: CUDA, raising without a card)
        in ``channels_last`` memory (``channels_last_3d`` for a model with
        3-D convs), the layout cuDNN prefers; the optimizer keeps its
        references to the same parameters."""
        model.to(resolve_device(device), memory_format=memory_format_for(model))
        return cls(model, optimizer)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _forward(model: nn.Module, images: torch.Tensor, dtype: torch.dtype, remat: bool = False,
             imagenet: bool = False, generator: torch.Generator | None = None):
    x = normalize_images(images, dtype, imagenet=imagenet)
    # only models that draw random numbers take the generator (VGG's dropout)
    kw = ({"generator": generator} if generator is not None
          and "generator" in inspect.signature(model.forward).parameters else {})
    with torch.autocast(x.device.type, dtype=dtype,
                        enabled=dtype in (torch.bfloat16, torch.float16)):
        if remat:
            return checkpoint(model, x, use_reentrant=False, **kw)
        return model(x, **kw)


def make_train_step(
    loss_fn: Callable[[list, dict], tuple[torch.Tensor, dict]],
    dtype: torch.dtype = torch.float32,
    accum_steps: int = 1,
    remat: bool = False,
    batch_transform: Callable | None = None,
    transform_seed: int = 0,
    with_grad_norm: bool = True,
    imagenet: bool = False,
) -> Callable:
    """Build ``train_step(state, batch, lr, rng=None) -> (state, metrics)``.

    - loss_fn(outputs, batch) -> (scalar loss, metrics dict);
    - batch: 'images' uint8 NHWC on the model's device (+ what loss_fn
      reads, e.g. 'labels'); host-only keys are ignored;
    - dtype: the forward's autocast dtype (float32: no autocast); images
      are scaled to [0, 1] in it;
    - accum_steps: the batch is split into this many microbatches along
      axis 0 (it must divide the batch), each forward + backward in turn, so
      peak activation memory is one microbatch's; the update uses the mean
      gradient. BN statistics chain from one microbatch to the next;
    - remat: the forward is checkpointed and recomputed during backward
      (``torch.utils.checkpoint``); the recompute's BN statistics update is
      undone, so BN moves once per forward as without remat;
    - batch_transform(batch, rng) -> batch: a random edit of the device
      batch before the forward (mixup / cutmix, `train.mix`); ``rng`` is a
      numpy Generator seeded from (transform_seed, state.step), so the
      draws repeat on resume and match between the card and the CPU;
    - with_grad_norm: add metrics['grad_norm'], the global norm of the
      gradients before clipping (one extra read of every gradient);
    - imagenet: standardize the images with the ImageNet mean and std
      after scaling them to [0, 1] (the classifiers' input);
    - rng: a ``torch.Generator`` on the model's device for models that draw
      random numbers in their forward (dropout); others ignore it.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def grads_of(model: nn.Module, batch: dict, rng: torch.Generator | None):
        outputs = _forward(model, batch["images"], dtype, remat, imagenet, rng)
        if remat:  # BN's statistics after the forward, before the recompute
            buffers = list(model.buffers())
            saved = [b.clone() for b in buffers]
        loss, metrics = loss_fn(outputs, batch)
        loss = loss.float()
        loss.backward()
        if remat:
            torch._foreach_copy_(buffers, saved)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def split(batch: dict) -> list[dict]:
        for k, v in batch.items():
            if v.shape[0] % accum_steps:
                raise ValueError(
                    f"batch size {v.shape[0]} of {k!r} not divisible by accum_steps={accum_steps}")
        parts = {k: v.chunk(accum_steps) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(accum_steps)]

    def train_step(state: TrainState, batch: dict, lr: float,
                   rng: torch.Generator | None = None):
        model, opt = state.model, state.optimizer
        batch = device_batch(batch)
        if batch_transform is not None:
            batch = batch_transform(batch, np.random.default_rng((transform_seed, state.step)))
        model.train()
        model.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, metrics = grads_of(model, batch, rng)
        else:
            runs = [grads_of(model, mb, rng) for mb in split(batch)]
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, float(accum_steps))
            loss = torch.stack([r[0] for r in runs]).mean()
            metrics = {k: torch.stack([r[1][k] for r in runs]).mean() for k in runs[0][1]}
        metrics["loss"] = loss
        if with_grad_norm:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            metrics["grad_norm"] = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        set_lr(opt, lr)
        opt.step()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(postprocess: Callable | None = None,
                   dtype: torch.dtype = torch.float32, imagenet: bool = False) -> Callable:
    """Build ``eval_step(state, batch) -> outputs``: eval mode, no autograd,
    images scaled to [0, 1] (and imagenet-standardized with ``imagenet``),
    ``postprocess(outputs, batch)`` (e.g. decode + NMS) in the same call,
    outside autocast. The model's train/eval mode is restored afterwards."""

    def eval_step(state: TrainState, batch: dict):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                out = _forward(model, batch["images"], dtype, imagenet=imagenet)
                if postprocess is not None:
                    out = postprocess(out, batch)
        finally:
            model.train(was_training)
        return out

    return eval_step
