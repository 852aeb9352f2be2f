"""Train and eval steps for Faster R-CNN (port of
fastvision_tpu/train/frcnn_steps.py).

The two-stage model computes its losses inside the training forward (it
samples proposals against the ground truth), so it has its own train step
instead of `make_train_step`'s forward / loss split. Every random draw of a
step comes from one ``torch.Generator`` on the model's device, seeded from
(``seed``, ``state.step``) as the JAX step folds ``state.step`` into its
key: a re-run repeats its draws.

Labels arrive from ``DetectionLoader`` as normalized xywh [B, M, 5]; the
steps convert them to the pixel xyxy the model takes. Images are
imagenet-standardized (the recipe of the JAX package's
``cli.py::_train_faster_rcnn``).

Under data parallelism (a model `Fit` placed: DDP, FSDP, or tensor
parallel over a data axis) the step is this rank's share of the global
batch: it runs inside `core.distributed.data_parallel`, draws the global
batch's `Draws` and keeps its data index's rows (``draw_shard``, see
`models.detection.faster_rcnn`), and averages the logged losses over the
ranks.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..core.distributed import axis, data_parallel
from ..core.rng import step_seed
from ..data.pipeline import normalize_images
from .optim import set_lr
from .steps import (TrainState, _average_over_ranks_, device_batch, make_eval_step,
                    parallel_kind, unwrap)


def labels_to_pixel_xyxy(labels_norm: torch.Tensor, size: int) -> torch.Tensor:
    """[B, M, 5] (cls, cxn, cyn, wn, hn) -> (cls, x1, y1, x2, y2) in pixels."""
    cls = labels_norm[..., 0:1]
    cx, cy = labels_norm[..., 1] * size, labels_norm[..., 2] * size
    w, h = labels_norm[..., 3] * size, labels_norm[..., 4] * size
    return torch.cat([cls, torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                                       dim=-1)], dim=-1)


def make_frcnn_train_step(seed: int = 0, dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``train_step(state, batch, lr, draws=None) -> (state, metrics)``
    for `Fit`: forward in train mode (bf16 autocast when ``dtype`` is bf16;
    losses in float32), backward, the host's learning rate, optimizer step.
    metrics: the four losses and their sum 'loss', on the device (the
    global batch's under data parallelism). ``draws`` replaces the
    generator's `Draws` of the global batch (tests feed the JAX package's
    samples and dropout masks through it)."""
    generators: dict[torch.device, torch.Generator] = {}

    def train_step(state: TrainState, batch: dict, lr: float, *, draws=None):
        model, opt = state.model, state.optimizer
        kind = parallel_kind(model)
        data = axis("data") if kind else None
        batch = device_batch(batch)
        labels = labels_to_pixel_xyxy(batch["labels"].float(), unwrap(model).image_size)
        gen = generators.setdefault(state.device, torch.Generator(device=state.device))
        gen.manual_seed(step_seed(seed, state.step))
        model.train()
        model.zero_grad(set_to_none=True)
        x = normalize_images(batch["images"], dtype, imagenet=True)
        with data_parallel() if kind else contextlib.nullcontext(), \
                torch.autocast(x.device.type, dtype=dtype,
                               enabled=dtype in (torch.bfloat16, torch.float16)):
            losses = model(x, labels, generator=gen, draws=draws,
                           draw_shard=(data.index, data.size) if kind else (0, 1))
        total = sum(losses.values())
        total.backward()
        set_lr(opt, lr)
        opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if kind and axis("batch").size > 1:
            _average_over_ranks_(list(metrics.values()))
        return state, metrics

    return train_step


def make_frcnn_eval_step(score_thresh: float = 0.05, nms_thresh: float = 0.3,
                         max_det: int = 100, dtype: torch.dtype = torch.float32) -> Callable:
    """Build ``eval_step(state, batch) -> ops.nms.Detections`` in input-size
    pixels (what `train.fit.detection_evaluator` takes): the eval forward,
    then `fastrcnn_postprocess`, whose NMS is the CUDA kernel on the card."""
    from ..models.detection.faster_rcnn import fastrcnn_postprocess

    def postprocess(outputs, batch):
        cls_logits, boxes, _, valid = outputs
        return fastrcnn_postprocess(cls_logits, boxes, valid, score_thresh, nms_thresh, max_det)

    return make_eval_step(postprocess, dtype, imagenet=True)
