"""Fit: the epoch-level training harness (port of fastvision_tpu/train/fit.py).

Sequences epochs, schedules the learning rate on the host per step (a base
schedule times the plateau factor), streams prefetched device batches into
the train step, keeps an EMA copy of the weights, and validates every
``eval_every`` epochs with the EMA weights when there are any. The epoch's
loss sum stays on the device and is read once at the end of the epoch. The
logged rates (``img_per_sec``, ``epoch_img_s``) stop their clock after a
loss read, so they count finished steps, not enqueued ones. Each step runs
in a ``fit.step`` span (`core.telemetry.span`), which a profiler records.

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

Parallel placement (``mesh``, a `core.mesh.Mesh`, in a process group; one
rank per device), in the JAX package's order: a ``model`` axis above 1
means tensor parallel (`parallel.tensor_shard`, the EMA copy too), even
with ``fsdp=True``; else ``fsdp=True`` shards the model over the data axis
(`parallel.fsdp`); else the model is replicated. Except under FSDP it is
then wrapped in ``DistributedDataParallel`` over the batch axis (the data
ranks, and the time ranks of a time-sharded model, which hold partial
gradients of one clip: `core.mesh`) unless that axis is one rank of
several (tensor parallel alone). Each data rank trains on its share of
every global batch: a loader built with ``host_shard`` yields it, any other
yields the global batch and the rank keeps its data index's contiguous
part; the step gives every rank the global batch's BN statistics, loss and
metrics (`train.steps`). Rank 0 writes the checkpoints (FSDP's and tensor
parallel's state gathered first, in the single-process format) while the
others wait, every rank restores, and the evaluators shard each
validation batch over the data axis and gather the outputs, so every rank
computes the metric one process would. Without a process group a mesh has
one rank and training is the single-process one.
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
from ..core.distributed import all_gather_cat, axis, barrier, is_initialized, rank, world_size
from ..core.mesh import Mesh, use_mesh
from ..core.rng import step_seed
from ..core.telemetry import MetricLogger, span
from ..data.pipeline import prefetch_to_device
from ..infer.postprocess import scale_coords
from ..ops.map import MeanAveragePrecision
from .ema import make_ema_update
from .schedulers import PlateauScheduler, Schedule, constant_lr
from .steps import TrainState, make_train_step, parallel_kind, unwrap

# steps between the ranks' agreements on a preemption request
PREEMPT_POLL = 8


def check_mesh(mesh) -> None:
    """``mesh``: None or a `core.mesh.Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a core.mesh.Mesh, got {type(mesh).__name__}")


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
    an rng-taking ``step_fn`` receives. ``mesh`` / ``fsdp``: parallel
    placement (module docstring; the mesh becomes the process's,
    `core.mesh.use_mesh`); the optimizer must not have stepped."""

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
        check_mesh(mesh)
        self.mesh = mesh
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
            self._ema_update = make_ema_update(ema_decay)
        # ranks sharing each global batch, and the ranks that agree on each
        # stop and checkpoint (1 and 1 without a mesh over a process group)
        grouped = mesh is not None and is_initialized()
        self.world = mesh.data if grouped else 1
        self._ranks = world_size() if grouped else 1
        if grouped:
            use_mesh(mesh)
            self._place(fsdp)
        if self.ema_model is not None:
            self._ema_pairs = (list(self.ema_model.parameters()),
                               list(self.state.model.parameters()))
        # where a resumed epoch starts: batches already done and their loss sum
        self._resume_batch, self._resume_loss = 0, None
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self._restore()

    def _place(self, fsdp: bool) -> None:
        """Placement over the process group (one rank per device), as the
        JAX package orders it: a model axis above 1 shards the model and
        the EMA copy's channels (tensor parallel) whatever ``fsdp`` says;
        else ``fsdp`` shards them over the data (and time) ranks and rebinds
        the optimizer; else they stay whole. Then, but for FSDP, DDP wraps
        the model over the batch axis, where it has more than one rank (or
        is the whole world). Global BN keeps the buffers equal on every
        rank, so DDP broadcasts none."""
        from ..core.mesh import replicate

        model = self.state.model
        replicate(model)  # rank 0's weights everywhere, as DDP starts
        if self.ema_model is not None:
            replicate(self.ema_model)
        if self.mesh.model > 1:
            from ..parallel.tensor_shard import shard_module
            from .optim import MultiSteps

            shard_module(model, self.mesh)
            if isinstance(self.state.optimizer, MultiSteps):
                self.state.optimizer.rebind()  # its means take the slices' shapes
            if self.ema_model is not None:
                shard_module(self.ema_model, self.mesh)
        elif fsdp:
            from ..parallel.fsdp import fsdp_shard_module, rebind_optimizer

            # over every rank: with a model axis of 1 the batch axis is the world
            names = fsdp_shard_module(model, self._ranks)
            rebind_optimizer(self.state.optimizer, names, model)
            if self.ema_model is not None:
                fsdp_shard_module(self.ema_model, self._ranks)
            return
        batch = axis("batch")
        if batch.size == 1 and self._ranks > 1:
            return  # tensor parallel alone: no gradient to average
        from torch.nn.parallel import DistributedDataParallel

        # newer torch names the switch forward_sync_buffers (and still
        # syncs at construction, where the buffers are equal anyway)
        sync = ("forward_sync_buffers" if "forward_sync_buffers" in
                inspect.signature(DistributedDataParallel).parameters
                else "broadcast_buffers")
        self.state.model = DistributedDataParallel(
            model, device_ids=[self.device] if self.device.type == "cuda" else None,
            process_group=batch.group, **{sync: False})

    def _restore(self) -> None:
        restored = self.ckpt.restore()
        state, meta = restored["state"], restored["meta"]
        model = unwrap(self.state.model)
        ema = state.get("ema")
        sharded = self._sharded_state_module(model)
        if sharded is not None:
            sharded.load_full_state(model, state["model"], self.state.optimizer,
                                    state.get("optimizer"))
            if self.ema_model is not None:
                # the EMA shadow over the restored model's state (its BN buffers)
                sharded.load_full_state(self.ema_model, {**state["model"], **(ema or {})})
        else:
            model.load_state_dict(state["model"])
            if "optimizer" in state:
                self.state.optimizer.load_state_dict(state["optimizer"])
            if self.ema_model is not None:
                # the EMA shadow; the restored raw weights (not the fresh
                # init) when the checkpoint has none
                ema = ema or dict(model.named_parameters())
                with torch.no_grad():
                    for name, p in self.ema_model.named_parameters():
                        p.copy_(ema[name])
        done = int(meta.get("epoch_batches_done", 0))
        if done and meta.get("host_count", 1) != getattr(self.train_loader, "host_count", 1):
            raise ValueError(
                f"checkpoint cut {done} batches into an epoch over {meta.get('host_count', 1)} "
                f"host shards; this run has {getattr(self.train_loader, 'host_count', 1)}: "
                "resume it at the world size it was saved at")
        self._resume_batch = done
        self._resume_loss = meta.get("epoch_loss_sum")
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.global_step = int(meta.get("global_step", 0)) + self._resume_batch
        self.state.step = int(meta.get("state_step", self.global_step))
        print(f"[fit] resumed from epoch {self.start_epoch}, batch {self._resume_batch}")

    @staticmethod
    def _sharded_state_module(model: nn.Module):
        """The module of `parallel` whose ``full_state`` / ``load_full_state``
        give ``model``'s sharded state in the one-process format (FSDP's or
        tensor parallel's), or None for a whole model."""
        if parallel_kind(model) == "fsdp":
            from ..parallel import fsdp

            return fsdp
        from ..parallel import tensor_shard

        return tensor_shard if tensor_shard.is_tensor_parallel(model) else None

    def _save(self, step: int, extra: dict, metric: float | None = None) -> None:
        """Rank 0 writes; the others wait for the write to be on disk."""
        model = unwrap(self.state.model)
        sharded = self._sharded_state_module(model)
        if sharded is not None:
            model_sd, opt_sd = sharded.full_state(model, self.state.optimizer)
            ema = None
            if self.ema_model is not None:
                names = dict(self.ema_model.named_parameters())
                ema = {k: v for k, v in sharded.full_state(self.ema_model)[0].items()
                       if k in names}
        else:
            model_sd, opt_sd = model.state_dict(), self.state.optimizer.state_dict()
            ema = (dict(self.ema_model.named_parameters())
                   if self.ema_model is not None else None)
        if rank() == 0 or self._ranks == 1:
            self.ckpt.save(step, model_sd, opt_sd, ema=ema,
                           extra={**extra, "state_step": self.state.step,
                                  "host_count": getattr(self.train_loader, "host_count", 1)},
                           metric=metric, higher_is_better=self.metric_mode == "max")
        if self._ranks > 1:
            if rank() == 0:
                self.ckpt.wait()
            barrier()

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
        another thread: the train loop polls the flag between batches; with
        several ranks they agree every `PREEMPT_POLL` steps and once more
        at the end of the epoch, and all stop where one asked)."""
        self._preempt = True

    def _stop_now(self, n_steps: int | None = None) -> bool:
        """Whether to stop before step ``n_steps`` of the epoch (None: at
        its end). With several ranks, the answer every rank gets: they
        agree at every `PREEMPT_POLL`-th step and at the end; elsewhere
        False. A request is never cleared here, so one that lands after
        an agreement counts at the next."""
        if self._ranks == 1:
            return self._preempt
        if n_steps is not None and n_steps % PREEMPT_POLL:
            return False
        flag = torch.tensor([float(self._preempt)],
                            device=self.device if torch.distributed.get_backend() == "nccl"
                            else "cpu")
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        stop = bool(flag.item())
        if stop:
            self._preempt = True
        return stop

    def _lr(self) -> float:
        lr = self.schedule(self.global_step)
        if self.plateau is not None:
            lr *= self.plateau.scale
        return lr

    def _train_epoch(self, epoch: int, loader, lr_override: float | None = None):
        """-> (the epoch's mean loss, its images/s); on preemption (the
        ranks' agreed answer) the batches done and their loss sum are left
        in ``self._progress``, else it is None."""
        skip, loss0 = self._resume_batch, self._resume_loss
        self._resume_batch, self._resume_loss = 0, None
        # on the device: one read at the end of the epoch
        loss_sum = None if loss0 is None else torch.tensor(loss0, device=self.device)
        n_steps, n_images = skip, 0
        batches = loader.epoch(epoch, start_batch=skip) if skip else loader.epoch(epoch)
        t0 = time.perf_counter()
        # a host-sharded loader yields this rank's share; any other the global batch
        per_host = self.mesh is not None and getattr(loader, "host_count", 1) > 1
        stop = False
        for batch in prefetch_to_device(batches, device=self.device, mesh=self.mesh,
                                        per_host=per_host):
            if self._stop_now(n_steps):
                stop = True
                break
            lr = lr_override if lr_override is not None else self._lr()
            with span("fit.step"):
                self.state, metrics = self._step(batch, lr)
                if self.ema_model is not None:
                    self._ema_update(*self._ema_pairs, self.state.step)
                step_loss = metrics["loss"]
                loss_sum = step_loss if loss_sum is None else loss_sum + step_loss
            n_steps += 1
            self.global_step += 1
            n_images += batch["images"].shape[0] * self.world  # the global batch
            if self.global_step % self.log_every == 0:
                loss = float(step_loss)  # waits for the step: the rate counts finished work
                dt = time.perf_counter() - t0
                self.logger.log(self.global_step, epoch=epoch, loss=loss, lr=lr,
                                img_per_sec=n_images / max(dt, 1e-9))
        # a request after the last agreement: every rank must take the same branch
        stop = stop or self._stop_now()
        total = None if loss_sum is None else float(loss_sum)  # waits for the last step
        img_s = n_images / max(time.perf_counter() - t0, 1e-9)
        self._progress = None
        if stop:
            self._progress = (n_steps, total)
            return float("nan"), img_s
        if n_steps == 0:
            raise ValueError(
                f"train loader produced zero batches in epoch {epoch} "
                "(dataset smaller than batch_size with drop_last?)")
        return total / n_steps, img_s

    def eval_state(self) -> TrainState:
        """State for evaluation and serving: the EMA weights, when enabled,
        with the live model's BN statistics (the model a DDP wrapper holds:
        evaluation runs no collective of its own)."""
        model = unwrap(self.state.model)
        if self.ema_model is None:
            return (self.state if model is self.state.model
                    else TrainState(model, self.state.optimizer, self.state.step))
        with torch.no_grad():
            torch._foreach_copy_(list(self.ema_model.buffers()), list(model.buffers()))
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
            if self._progress is not None:
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


def _gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's share of an output, concatenated in rank order."""
    if t.dtype == torch.bool:  # gloo has no bool collectives
        return all_gather_cat(t.to(torch.uint8)).bool()
    return all_gather_cat(t)


def replicate_eval_outputs(eval_step: Callable, mesh) -> Callable:
    """``eval_step`` over this rank's share of a batch (the loader's whole
    batch on every rank), its outputs (a tensor or a tuple of them)
    gathered so that every rank holds the whole batch's. Without a mesh, or
    with one rank, ``eval_step`` itself."""
    check_mesh(mesh)
    if mesh is None or mesh.data == 1:
        return eval_step

    def step(state: TrainState, batch: dict):
        out = eval_step(state, batch)
        if isinstance(out, torch.Tensor):
            return _gather(out)
        parts = (_gather(t) for t in out)
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)

    return step


def detection_evaluator(eval_step: Callable, num_batches: int | None = None,
                        mesh=None) -> Callable:
    """Build ``evaluator(state, loader) -> {'map50', 'map'}``.

    ``eval_step(state, batch)`` returns ops.nms.Detections in input-size
    coordinates (decode + NMS, whose suppression is the CUDA kernel on the
    card). Batches run on the device of ``state``'s model; the kept boxes
    are unscaled to original pixels with the loader's meta and matched on
    the host against the original-space GT. With a ``mesh`` of several
    ranks each rank runs its share of every batch and the detections are
    gathered (`replicate_eval_outputs`): every rank gets the same metric."""
    step = replicate_eval_outputs(eval_step, mesh)

    def evaluate(state: TrainState, loader) -> dict:
        m = MeanAveragePrecision()
        for bi, batch in enumerate(prefetch_to_device(loader.epoch(0), device=state.device,
                                                      mesh=mesh)):
            if num_batches is not None and bi >= num_batches:
                break
            det = step(state, batch)
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
    count stays on the device and is read once at the end. With a ``mesh``
    of several ranks the logits and labels of each rank's share are
    gathered (`replicate_eval_outputs`)."""

    def with_labels(state: TrainState, batch: dict):
        return eval_step(state, batch), batch["labels"]

    step = replicate_eval_outputs(with_labels, mesh)

    def evaluate(state: TrainState, loader) -> dict:
        correct, total = torch.zeros((), dtype=torch.int64, device=state.device), 0
        for batch in prefetch_to_device(loader.epoch(0), device=state.device, mesh=mesh):
            n = batch.get("num_real", batch["images"].shape[0] * (mesh.data if mesh else 1))
            logits, labels = step(state, batch)
            correct += (logits[:n].argmax(dim=-1) == labels[:n]).sum()
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
    is ignored). The logits stay on the device until the end. With a
    ``mesh`` of several ranks each rank runs its share of every batch and
    the logits are gathered (`replicate_eval_outputs`)."""
    step = replicate_eval_outputs(eval_step, mesh)

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
        for batch in prefetch_to_device(batches(), device=state.device, device_keys=("images",),
                                        mesh=mesh):
            logits.append(step(state, batch)[: batch["num_real"]].float())
        per_video = torch.cat(logits).view(n_videos, n_clips, -1).sum(dim=1)
        pred = per_video.argmax(dim=-1).cpu().numpy()
        return {"accuracy": float((pred == labels).mean()), "n_clips": n_clips}

    return evaluate
