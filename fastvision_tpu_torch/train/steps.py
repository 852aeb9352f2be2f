"""Train and eval steps (port of fastvision_tpu/train/steps.py).

One train step is forward (train mode, bf16 autocast when the step's dtype
is bf16) -> loss in float32 -> backward -> the host-scheduled learning rate
-> optimizer step. Parameters, optimizer state and BN statistics stay
float32. The step's loss and gradient norm stay on the device: nothing in
the step waits for the card. Each microbatch's forward, loss and backward
are the spans ``step.forward``, ``step.loss`` and ``step.backward``
(`core.telemetry.span`); the optimizer keeps torch's own range.

A ``batch_transform`` (mixup / cutmix, `train.mix`) edits the batch on the
device before the forward, with a numpy Generator seeded from
(``transform_seed``, step); a step called with a ``torch.Generator``
(`Fit` passes one seeded from (seed, step)) hands it to models that draw
dropout masks (VGG's classifier).

Data parallel: a model wrapped in ``DistributedDataParallel`` or sharded by
``fully_shard`` (`Fit` places it, `parallel.fsdp`) trains on this rank's
share of the global batch. The step runs it inside
`core.distributed.data_parallel` (global BN statistics and loss
denominators), averages the logged metrics over the ranks, gathers the
global batch for a ``batch_transform`` (the mix pairs images across the
whole batch, as the JAX package's does) or for microbatches (each a
contiguous slice of the global batch, as the JAX package's) and keeps its
own share of each, and skips the gradient all-reduce of the accumulation
passes whose gradients are summed locally first: every microbatch but the
last, and under DDP every `MultiSteps` call but the k-th, whose running
means are then averaged over the ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.distributed import all_gather_cat, axis, data_parallel
from ..core.telemetry import span
from ..data.pipeline import normalize_images
from ..device import resolve_device
from ..nn.layers import memory_format_for
from ..parallel.tensor_shard import tp_global_norm
from .optim import MultiSteps, set_lr


def parallel_kind(model: nn.Module) -> str | None:
    """'ddp' for a ``DistributedDataParallel`` wrapper, 'fsdp' for a module
    sharded by ``fully_shard``, else None."""
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(model, DistributedDataParallel):
        return "ddp"
    if torch.distributed.is_available():
        from torch.distributed.fsdp import FSDPModule

        if isinstance(model, FSDPModule):
            return "fsdp"
    return None


def unwrap(model: nn.Module) -> nn.Module:
    """The module a ``DistributedDataParallel`` wraps (the model itself
    otherwise): its names and ``state_dict`` are the plain model's."""
    return model.module if parallel_kind(model) == "ddp" else model


def plain_value(t: torch.Tensor) -> torch.Tensor:
    """A DTensor (a norm of FSDP's sharded gradients) as a plain tensor."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@contextlib.contextmanager
def gradient_sync(model: nn.Module, enabled: bool):
    """Backward passes inside skip (``enabled=False``) or make the data
    parallel gradient reduction of ``model``."""
    kind = parallel_kind(model)
    if enabled or kind is None:
        yield
    elif kind == "ddp":
        with model.no_sync():
            yield
    else:
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)


def _average_over_ranks_(tensors: list[torch.Tensor]) -> None:
    """In place: each tensor becomes its mean over the batch axis (the
    ranks data parallelism averages gradients over; one all-reduce of
    their concatenation)."""
    ax = axis("batch")
    dtype = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    torch.distributed.all_reduce(flat, group=ax.group)
    flat /= ax.size
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


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
          and "generator" in inspect.signature(unwrap(model).forward).parameters else {})
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
      gradients before clipping (one extra read of every gradient); NaN for
      a DDP `MultiSteps` call that skips the all-reduce, whose gradients
      are the rank's own;
    - imagenet: standardize the images with the ImageNet mean and std
      after scaling them to [0, 1] (the classifiers' input);
    - rng: a ``torch.Generator`` on the model's device for models that draw
      random numbers in their forward (dropout); others ignore it.

    Under data parallelism (see the module docstring) ``batch`` is this
    rank's share and the metrics are the global batch's; microbatch i is
    this rank's share of the global batch's i-th slice, as in the JAX
    package (the global batch is gathered for it).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def grads_of(model: nn.Module, batch: dict, rng: torch.Generator | None):
        with span("step.forward"):
            outputs = _forward(model, batch["images"], dtype, remat, imagenet, rng)
        if remat:  # BN's statistics after the forward, before the recompute
            buffers = list(model.buffers())
            saved = [b.clone() for b in buffers]
        with span("step.loss"):
            loss, metrics = loss_fn(outputs, batch)
            loss = loss.float()
        with span("step.backward"):
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

    def microbatches(batch: dict, parallel: bool, step: int) -> list[dict]:
        """The transformed batch in ``accum_steps`` parts. Over several
        ranks with a transform or microbatches, the global batch is
        gathered first: the transform pairs images across all of it, and
        microbatch i is this rank's contiguous share of the global batch's
        i-th contiguous slice, as the JAX package splits the global batch."""
        draws = (np.random.default_rng((transform_seed, step))
                 if batch_transform is not None else None)
        data = axis("data")
        if not parallel or data.size == 1 or (batch_transform is None and accum_steps == 1):
            return split(batch if draws is None else batch_transform(batch, draws))
        split(batch)  # this rank's share must split too
        full = {k: all_gather_cat(v) for k, v in batch.items()}
        if draws is not None:
            full = batch_transform(full, draws)
        w, r = data.size, data.index
        return [{k: v[r * (len(v) // w):(r + 1) * (len(v) // w)] for k, v in mb.items()}
                for mb in split(full)]

    def train_step(state: TrainState, batch: dict, lr: float,
                   rng: torch.Generator | None = None):
        model, opt = state.model, state.optimizer
        kind = parallel_kind(model)
        mbs = microbatches(device_batch(batch), kind is not None, state.step)
        # a MultiSteps call that only accumulates: DDP skips its all-reduce
        # (FSDP keeps unsynchronized gradients out of .grad, so it reduces)
        local = (kind == "ddp" and isinstance(opt, MultiSteps)
                 and opt.mini_step + 1 < opt.every_k)
        model.train()
        model.zero_grad(set_to_none=True)
        with data_parallel() if kind else contextlib.nullcontext():
            if accum_steps == 1:
                with gradient_sync(model, not local):
                    loss, metrics = grads_of(model, mbs[0], rng)
            else:
                runs = []
                for i, mb in enumerate(mbs):
                    with gradient_sync(model, not local and i == accum_steps - 1):
                        runs.append(grads_of(model, mb, rng))
                grads = [p.grad for p in model.parameters() if p.grad is not None]
                torch._foreach_div_(grads, float(accum_steps))
                loss = torch.stack([r[0] for r in runs]).mean()
                metrics = {k: torch.stack([r[1][k] for r in runs]).mean() for k in runs[0][1]}
        metrics["loss"] = loss
        if kind and axis("batch").size > 1:
            values = list(metrics.values())
            _average_over_ranks_(values)
        if with_grad_norm and local:  # the rank's own gradient: the global norm is unknown
            metrics["grad_norm"] = torch.tensor(float("nan"), device=loss.device)
        elif with_grad_norm:
            params = [p for p in model.parameters() if p.grad is not None]
            norms = torch._foreach_norm([p.grad for p in params])
            metrics["grad_norm"] = (plain_value(torch.linalg.vector_norm(torch.stack(norms)))
                                    if kind == "fsdp" else tp_global_norm(list(norms), params))
        if (kind == "ddp" and isinstance(opt, MultiSteps) and opt.every_k > 1
                and opt.mini_step + 1 == opt.every_k and axis("batch").size > 1):
            _average_over_ranks_(opt.acc)  # the local means of the calls that skipped DDP
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
