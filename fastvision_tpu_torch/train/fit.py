"""Fit: the epoch-level training harness (port of fastvision_tpu/train/fit.py).

Sequences epochs, schedules the learning rate on the host per step (a base
schedule times the plateau factor), streams prefetched device batches into
the train step, keeps an EMA copy of the weights, and validates every
``eval_every`` epochs with the EMA weights when there are any. The epoch's
loss sum stays on the device and is read once at the end of the epoch.

With ``ckpt_dir`` every epoch is checkpointed (`core.checkpoint`: the raw
weights and BN statistics, the optimizer's state, the EMA parameters, and
the epoch, global step and state step in the meta); the best slot follows
``metric_key`` / ``metric_mode``. On preemption the state is saved in the
interrupted epoch's slot, stamped with the previous epoch and the epoch's
first global step as in the JAX package, plus how many of its batches are
done and their loss sum. ``resume=True`` restores the newest checkpoint and
redoes the interrupted epoch from the batch after the last one done: the
loader's order and augmentations come from (seed, epoch[, position]) and a
step's random draws from (seed, step), so a resumed run takes the same
steps as one never interrupted.

A ``step_fn`` that takes a 4th positional argument (or ``*args``, or a
positional one named ``rng``; the rules of the JAX package's ``step_fn``
setter) gets a ``torch.Generator`` on the model's device, seeded from
(``seed``, global step): the per-step key that dropout needs.

Not ported yet: meshes and FSDP (``mesh``, ``fsdp``).
"""
from __future__ import annotations

import copy
import inspect
import signal
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import CheckpointManager
from ..core.rng import step_seed
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
    permutation cycled every ``len(multiscale)`` epochs. ``ckpt_dir``:
    checkpoint after every epoch (``save_every_epoch``; else after the last
    only) and on preemption; ``resume``: continue from the newest
    checkpoint there. ``seed``: the root of the per-step generators that
    an rng-taking ``step_fn`` receives."""

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
        save_every_epoch: bool = True,
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
        seed: int = 0,
    ):
        if mesh is not None or fsdp:
            raise _not_ported("meshes and FSDP (mesh, fsdp)", 17)
        self.state = TrainState.create(model, optimizer, device)
        self.device = self.state.device
        self.seed = seed
        self._generator = None
        self.step_fn = step_fn or make_train_step(loss_fn, dtype=dtype)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.epochs = epochs
        self.schedule = schedule or constant_lr(1e-3)
        self.plateau = plateau
        self.evaluator = evaluator
        self.save_every_epoch = save_every_epoch
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
        # where a resumed epoch starts: batches already done and their loss sum
        self._resume_batch, self._resume_loss = 0, None
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self._restore()

    def _restore(self) -> None:
        restored = self.ckpt.restore()
        state, meta = restored["state"], restored["meta"]
        model = self.state.model
        model.load_state_dict(state["model"])
        if "optimizer" in state:
            self.state.optimizer.load_state_dict(state["optimizer"])
        if self.ema_model is not None:
            # the EMA shadow; the restored raw weights (not the fresh init)
            # when the checkpoint has none
            ema = state.get("ema") or dict(model.named_parameters())
            with torch.no_grad():
                for name, p in self.ema_model.named_parameters():
                    p.copy_(ema[name])
        self._resume_batch = int(meta.get("epoch_batches_done", 0))
        self._resume_loss = meta.get("epoch_loss_sum")
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.global_step = int(meta.get("global_step", 0)) + self._resume_batch
        self.state.step = int(meta.get("state_step", self.global_step))
        print(f"[fit] resumed from epoch {self.start_epoch}, batch {self._resume_batch}")

    def _save(self, step: int, extra: dict, metric: float | None = None) -> None:
        ema = dict(self.ema_model.named_parameters()) if self.ema_model is not None else None
        self.ckpt.save(step, self.state.model.state_dict(), self.state.optimizer.state_dict(),
                       ema=ema, extra={**extra, "state_step": self.state.step}, metric=metric,
                       higher_is_better=self.metric_mode == "max")

    @property
    def step_fn(self) -> Callable:
        """(state, batch, lr[, rng]) -> (state, metrics). Assigning it
        inspects the new callable: it takes the per-step generator when it
        has 4 positional parameters, ``*args``, or a positional ``rng``
        (keyword-only parameters and ``**kwargs`` do not count)."""
        return self._step_fn

    @step_fn.setter
    def step_fn(self, fn: Callable) -> None:
        self._step_fn = fn
        try:
            params = inspect.signature(fn).parameters.values()
        except (TypeError, ValueError):
            self._step_takes_rng = False
            return
        positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        self._step_takes_rng = (len(positional) >= 4 or any(p.name == "rng" for p in positional)
                                or any(p.kind == p.VAR_POSITIONAL for p in params))

    def _step(self, batch: dict, lr: float):
        if not self._step_takes_rng:
            return self.step_fn(self.state, batch, lr)
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(step_seed(self.seed, self.global_step))
        return self.step_fn(self.state, batch, lr, self._generator)

    def request_preempt(self) -> None:
        """Stop after the current step (safe from a signal handler or
        another thread: the train loop polls the flag between batches)."""
        self._preempt = True

    def _lr(self) -> float:
        lr = self.schedule(self.global_step)
        if self.plateau is not None:
            lr *= self.plateau.scale
        return lr

    def _train_epoch(self, epoch: int, loader, lr_override: float | None = None):
        """-> (the epoch's mean loss, its images/s); on preemption the
        batches done and their loss sum are left in ``self._progress``."""
        skip, loss0 = self._resume_batch, self._resume_loss
        self._resume_batch, self._resume_loss = 0, None
        # on the device: one read at the end of the epoch
        loss_sum = None if loss0 is None else torch.tensor(loss0, device=self.device)
        n_steps, n_images = skip, 0
        batches = loader.epoch(epoch, start_batch=skip) if skip else loader.epoch(epoch)
        t0 = time.perf_counter()
        for batch in prefetch_to_device(batches, device=self.device):
            if self._preempt:
                break
            lr = lr_override if lr_override is not None else self._lr()
            self.state, metrics = self._step(batch, lr)
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
        img_s = n_images / max(time.perf_counter() - t0, 1e-9)
        if self._preempt:
            self._progress = (n_steps, None if loss_sum is None else float(loss_sum))
            return float("nan"), img_s
        if n_steps == 0:
            raise ValueError(
                f"train loader produced zero batches in epoch {epoch} "
                "(dataset smaller than batch_size with drop_last?)")
        return float(loss_sum) / n_steps, img_s

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
            epoch_start_step = self.global_step - self._resume_batch
            train_loss, img_s = self._train_epoch(epoch, loader, lr_override)
            if self._preempt:
                self.interrupted = True
                if self.ckpt is not None:
                    done, loss_sum = self._progress
                    self._save(epoch, {"epoch": epoch - 1, "global_step": epoch_start_step,
                                       "preempted": True, "epoch_batches_done": done,
                                       "epoch_loss_sum": loss_sum})
                    self.ckpt.wait()
                self.logger.log(self.global_step, epoch=epoch, preempted=True)
                print(f"[fit] preempted in epoch {epoch}: checkpoint saved, resume "
                      "finishes this epoch")
                break

            val_metrics: dict[str, Any] = {}
            if (epoch + 1) % self.eval_every == 0 or epoch == self.epochs - 1:
                val_metrics = self._validate(epoch)
            self.logger.log(self.global_step, epoch=epoch, train_loss=train_loss,
                            epoch_img_s=img_s, **val_metrics)

            # compare like with like: with eval_every > 1 the plateau and the
            # best slot only see fresh validation metrics (or the train loss
            # when there is no evaluator at all)
            expects_val = self.evaluator is not None and self.val_loader is not None
            fresh = bool(val_metrics) or not expects_val
            metric = val_metrics.get(self.metric_key, train_loss)
            if self.plateau is not None and fresh:
                self.plateau.update(metric)
            if self.ckpt is not None and (self.save_every_epoch or epoch == self.epochs - 1):
                self._save(epoch, {"epoch": epoch, "global_step": self.global_step,
                                   "train_loss": train_loss,
                                   **{k: float(v) for k, v in val_metrics.items()}},
                           metric=float(metric) if fresh else None)
        if self.multiscale:
            self.train_loader.input_size = self._base_input_size
        if self.ckpt is not None:
            self.ckpt.wait()
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


def classification_evaluator(eval_step: Callable, mesh=None) -> Callable:
    """Build ``evaluator(state, loader) -> {'accuracy'}``: top-1 over the
    real images of each batch (``num_real``: a padded last batch counts its
    real ones only). ``eval_step(state, batch)`` returns the logits; the
    count stays on the device and is read once at the end."""
    if mesh is not None:
        raise _not_ported("meshes (mesh)", 17)

    def evaluate(state: TrainState, loader) -> dict:
        correct, total = torch.zeros((), dtype=torch.int64, device=state.device), 0
        for batch in prefetch_to_device(loader.epoch(0), device=state.device):
            n = batch.get("num_real", batch["images"].shape[0])
            logits = eval_step(state, batch)
            correct += (logits[:n].argmax(dim=-1) == batch["labels"][:n]).sum()
            total += int(n)
        return {"accuracy": int(correct) / max(total, 1)}

    return evaluate


def multiclip_windows(total: int, num_frames: int, n_clips: int) -> list[np.ndarray]:
    """The multi-clip protocol's frame indices for a clip of ``total``
    frames: ``n_clips`` windows of ``num_frames`` consecutive frames, their
    starts evenly spaced by ``np.linspace`` over [0, total - num_frames]
    and rounded; a clip no longer than a window gives ``n_clips`` copies of
    its frames, the last repeated."""
    if total <= num_frames:
        return [np.clip(np.arange(num_frames), 0, max(total - 1, 0))] * n_clips
    starts = np.round(np.linspace(0, total - num_frames, n_clips)).astype(np.int64)
    return [s + np.arange(num_frames) for s in starts]


def video_multiclip_evaluator(eval_step: Callable, n_clips: int = 4, mesh=None) -> Callable:
    """Build ``evaluator(state, loader) -> {'accuracy', 'n_clips'}``, the
    Kinetics-style test protocol: `multiclip_windows` per video, the logits
    of its windows summed before the argmax.

    ``loader`` is a `data.VideoClipLoader` (train=False): the windows are
    read on its workers (`VideoClipLoader.windows`) and stream through
    ``eval_step(state, batch) -> logits`` in batches of its batch size
    ([bs, T, S, S, 3], one shape: the ragged tail repeats its last clip and
    is ignored). The logits stay on the device until the end."""
    if mesh is not None:
        raise _not_ported("meshes (mesh)", 17)

    def evaluate(state: TrainState, loader) -> dict:
        ds, bs = loader.ds, loader.batch_size
        n_videos = len(ds)
        jobs = [(v, w) for v in range(n_videos)
                for w in multiclip_windows(ds.clip_length(v), loader.num_frames, n_clips)]
        labels = np.zeros(n_videos, np.int64)
        windows = loader.windows(jobs)  # a process pool starts here, in this thread

        def batches():
            clips = np.empty((bs, loader.num_frames, loader.size, loader.size, 3), np.uint8)
            real = 0
            for k, (clip, label) in enumerate(windows):
                clips[real] = clip
                labels[jobs[k][0]] = label
                real += 1
                if real == bs or k == len(jobs) - 1:
                    clips[real:] = clips[real - 1]
                    yield {"images": clips.copy(), "num_real": real}
                    real = 0

        logits = []
        for batch in prefetch_to_device(batches(), device=state.device, device_keys=("images",)):
            logits.append(eval_step(state, batch)[: batch["num_real"]].float())
        per_video = torch.cat(logits).view(n_videos, n_clips, -1).sum(dim=1)
        pred = per_video.argmax(dim=-1).cpu().numpy()
        return {"accuracy": float((pred == labels).mean()), "n_clips": n_clips}

    return evaluate
