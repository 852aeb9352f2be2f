"""Fit: the epoch-level training harness (port of fastvision_tpu/train/fit.py).

Sequences epochs, schedules the learning rate on the host per step (a base
schedule times the plateau factor), streams prefetched device batches into
the train step, keeps an EMA copy of the weights, and validates every
``eval_every`` epochs with the EMA weights when there are any. The epoch's
loss sum stays on the device and is read once at the end of the epoch.

Not ported yet: checkpointing (``ckpt_dir``, ``resume``, the save on
preemption; core/checkpoint.py), meshes and FSDP (``mesh``, ``fsdp``), and a
``step_fn`` that takes a per-step random key.
"""
from __future__ import annotations

import copy
import signal
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..core.telemetry import MetricLogger
from ..data.pipeline import prefetch_to_device
from ..infer.postprocess import scale_coords
from ..ops.map import MeanAveragePrecision
from .ema import make_ema_update
from .schedulers import PlateauScheduler, Schedule, constant_lr
from .steps import TrainState, make_train_step


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


class Fit:
    """``Fit(model, loss_fn, optimizer, train_loader, ...).run()``.

    ``model`` is moved to ``device`` (None: CUDA, raising without a card);
    ``optimizer`` comes from `build_optimizer` over that model; ``loss_fn``
    and ``dtype`` build the default train step (`make_train_step`) unless a
    ``step_fn(state, batch, lr) -> (state, metrics)`` is given.
    ``evaluator(state, val_loader) -> dict`` runs every ``eval_every``
    epochs and after the last; ``metric_key`` of its result feeds the
    plateau schedule. The last ``no_aug_epochs`` epochs use
    ``no_aug_loader`` (default: the train loader) at ``no_aug_lr``.
    ``multiscale``: train input sizes, one per epoch, from a seeded
    permutation cycled every ``len(multiscale)`` epochs."""

    def __init__(
        self,
        model: nn.Module,
        loss_fn: Callable,
        optimizer: torch.optim.Optimizer,
        train_loader,
        val_loader=None,
        epochs: int = 100,
        schedule: Schedule | None = None,
        plateau: PlateauScheduler | None = None,
        mesh=None,
        evaluator: Callable | None = None,
        ckpt_dir: str | None = None,
        eval_every: int = 1,
        no_aug_epochs: int = 0,
        no_aug_loader=None,
        no_aug_lr: float | None = None,
        logger: MetricLogger | None = None,
        log_every: int = 50,
        start_epoch: int = 0,
        resume: bool = False,
        metric_mode: str = "min",
        metric_key: str = "val_loss",
        step_fn: Callable | None = None,
        ema_decay: float = 0.0,
        multiscale: Sequence[int] | None = None,
        preempt_signals: Sequence[int] = (),
        fsdp: bool = False,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        if ckpt_dir or resume:
            raise _not_ported("checkpointing (ckpt_dir, resume; core/checkpoint.py)", 10)
        if mesh is not None or fsdp:
            raise _not_ported("meshes and FSDP (mesh, fsdp)", 17)
        self.state = TrainState.create(model, optimizer, device)
        self.device = self.state.device
        self.step_fn = step_fn or make_train_step(loss_fn, dtype=dtype)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.epochs = epochs
        self.schedule = schedule or constant_lr(1e-3)
        self.plateau = plateau
        self.evaluator = evaluator
        self.eval_every = eval_every
        self.no_aug_epochs = no_aug_epochs
        self.no_aug_loader = no_aug_loader
        self.no_aug_lr = no_aug_lr
        self.logger = logger or MetricLogger()
        self.log_every = log_every
        self.start_epoch = start_epoch
        self.metric_mode = metric_mode
        self.metric_key = metric_key
        self.global_step = 0
        # sizes change per epoch, so the loader never switches shapes
        # mid-epoch; labels are normalized, so only the letterbox target
        # changes. no-aug epochs and validation run at the base size
        self.multiscale = tuple(int(s) for s in multiscale) if multiscale else None
        self._base_input_size = getattr(train_loader, "input_size", None)
        if self.multiscale:
            bad = [s for s in self.multiscale if s % 32]
            if bad:
                raise ValueError(f"multiscale sizes must be multiples of 32: {bad}")
            if self._base_input_size is None:
                raise ValueError("multiscale needs a train_loader with .input_size")
        self.preempt_signals = tuple(preempt_signals)
        self._preempt = False
        self.interrupted = False
        self.ema_decay = ema_decay
        self.ema_model = None
        if ema_decay > 0:
            # the EMA shadows the parameters; BN statistics are the live
            # model's, copied in at evaluation (`eval_state`)
            self.ema_model = copy.deepcopy(self.state.model).requires_grad_(False)
            self._ema_pairs = (list(self.ema_model.parameters()),
                               list(self.state.model.parameters()))
            self._ema_update = make_ema_update(ema_decay)

    def request_preempt(self) -> None:
        """Stop after the current step (safe from a signal handler or
        another thread: the train loop polls the flag between batches)."""
        self._preempt = True

    def _lr(self) -> float:
        lr = self.schedule(self.global_step)
        if self.plateau is not None:
            lr *= self.plateau.scale
        return lr

    def _train_epoch(self, epoch: int, loader, lr_override: float | None = None) -> float:
        loss_sum = None  # on the device: one read at the end of the epoch
        n_steps = n_images = 0
        t0 = time.perf_counter()
        for batch in prefetch_to_device(loader.epoch(epoch), device=self.device):
            if self._preempt:
                break
            lr = lr_override if lr_override is not None else self._lr()
            self.state, metrics = self.step_fn(self.state, batch, lr)
            if self.ema_model is not None:
                self._ema_update(*self._ema_pairs, self.state.step)
            step_loss = metrics["loss"]
            loss_sum = step_loss if loss_sum is None else loss_sum + step_loss
            n_steps += 1
            self.global_step += 1
            n_images += batch["images"].shape[0]
            if self.global_step % self.log_every == 0:
                dt = time.perf_counter() - t0
                self.logger.log(self.global_step, epoch=epoch, loss=float(step_loss), lr=lr,
                                img_per_sec=n_images / max(dt, 1e-9))
        if n_steps == 0:
            if self._preempt:  # the request came before the first batch
                return float("nan")
            raise ValueError(
                f"train loader produced zero batches in epoch {epoch} "
                "(dataset smaller than batch_size with drop_last?)")
        return float(loss_sum) / n_steps

    def eval_state(self) -> TrainState:
        """State for evaluation and serving: the EMA weights, when enabled,
        with the live model's BN statistics."""
        if self.ema_model is None:
            return self.state
        with torch.no_grad():
            torch._foreach_copy_(list(self.ema_model.buffers()),
                                 list(self.state.model.buffers()))
        return TrainState(self.ema_model, self.state.optimizer, self.state.step)

    def _validate(self, epoch: int) -> dict:
        if self.evaluator is None or self.val_loader is None:
            return {}
        return dict(self.evaluator(self.eval_state(), self.val_loader))

    def epoch_input_size(self, epoch: int) -> int | None:
        """Train input size for ``epoch`` under multi-scale (None = base):
        a permutation seeded by (the train loader's seed, the cycle index)
        covers every size once per cycle."""
        if not self.multiscale:
            return None
        n = len(self.multiscale)
        seed = getattr(self.train_loader, "seed", 0)
        perm = np.random.default_rng((seed, epoch // n)).permutation(n)
        return self.multiscale[perm[epoch % n]]

    def run(self) -> TrainState:
        installed = []
        for sig in self.preempt_signals:
            try:
                installed.append((sig, signal.signal(sig, lambda *_: self.request_preempt())))
            except ValueError:  # not the main thread: the caller calls request_preempt()
                pass
        try:
            return self._run()
        finally:
            for sig, prev in installed:
                signal.signal(sig, prev)

    def _run(self) -> TrainState:
        main_epochs = self.epochs - self.no_aug_epochs
        for epoch in range(self.start_epoch, self.epochs):
            no_aug_phase = epoch >= main_epochs
            loader = ((self.no_aug_loader or self.train_loader) if no_aug_phase
                      else self.train_loader)
            lr_override = self.no_aug_lr if no_aug_phase else None
            if self.multiscale:
                if no_aug_phase or loader is not self.train_loader:
                    self.train_loader.input_size = self._base_input_size
                else:
                    size = self.epoch_input_size(epoch)
                    loader.input_size = size
                    self.logger.log(self.global_step, epoch=epoch, img_size=size)
            train_loss = self._train_epoch(epoch, loader, lr_override)
            if self._preempt:
                self.interrupted = True
                self.logger.log(self.global_step, epoch=epoch, preempted=True)
                break

            val_metrics: dict[str, Any] = {}
            if (epoch + 1) % self.eval_every == 0 or epoch == self.epochs - 1:
                val_metrics = self._validate(epoch)
            self.logger.log(self.global_step, epoch=epoch, train_loss=train_loss, **val_metrics)

            # compare like with like: with eval_every > 1 the plateau only
            # sees fresh validation metrics (or the train loss when there is
            # no evaluator at all)
            expects_val = self.evaluator is not None and self.val_loader is not None
            if self.plateau is not None and (val_metrics or not expects_val):
                self.plateau.update(val_metrics.get(self.metric_key, train_loss))
        if self.multiscale:
            self.train_loader.input_size = self._base_input_size
        return self.state


def detection_evaluator(eval_step: Callable, num_batches: int | None = None,
                        mesh=None) -> Callable:
    """Build ``evaluator(state, loader) -> {'map50', 'map'}``.

    ``eval_step(state, batch)`` returns ops.nms.Detections in input-size
    coordinates (decode + NMS, whose suppression is the CUDA kernel on the
    card). Batches run on the device of ``state``'s model; the kept boxes
    are unscaled to original pixels with the loader's meta and matched on
    the host against the original-space GT."""
    if mesh is not None:
        raise _not_ported("meshes (mesh)", 17)

    def evaluate(state: TrainState, loader) -> dict:
        m = MeanAveragePrecision()
        for bi, batch in enumerate(prefetch_to_device(loader.epoch(0), device=state.device)):
            if num_batches is not None and bi >= num_batches:
                break
            det = eval_step(state, batch)
            boxes, scores, classes, valid = (t.cpu().numpy() for t in det)
            for i in range(batch["num_real"]):
                meta = batch["meta"][i]
                v = valid[i]
                gt = meta["gt_pixels"]
                m.update(scale_coords(boxes[i][v], meta["scale"], meta["pad"], meta["orig_hw"]),
                         scores[i][v], classes[i][v], gt[:, 1:5], gt[:, 0])
        res = m.compute()
        return {"map50": res.map50, "map": res.map}

    return evaluate
