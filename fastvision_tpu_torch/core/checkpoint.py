"""Checkpointing: run checkpoints with a background write, resume, partial
load, freeze masks and torch-checkpoint import (port of
fastvision_tpu/core/checkpoint.py).

The JAX package saves with orbax; the card's machine has no orbax, and an
orbax tree would not hold a torch optimizer's state, so the port has a
format of its own. ``<dir>/<step>/`` holds one ``torch.save`` file per item
(``model.pt``: parameters and BN buffers, ``optimizer.pt``: the optimizer's
``state_dict()`` with its momentum, ``ema.pt``: the EMA shadow parameters
when EMA is on) and ``meta.json``. A step is written under a temporary name
and renamed, so a step directory is complete or absent. ``<dir>/best/``
holds one more copy, of the best-metric step, which retention never
deletes, and ``best.json`` its metric.

`CheckpointManager.save` copies every tensor to host memory on the calling
thread (pinned memory for CUDA tensors, one synchronisation) and writes the
files on a background thread that `wait()` joins: the step loop stalls for
the copy only, as the JAX package's async orbax save after its host
snapshot (``train/fit.py::_ckpt_snapshot``).

The JAX package's layout converters (``conv_oihw_to_hwio``,
``linear_spatial_to_io`` and kin) turn torch layouts into flax ones; the
port's modules take torch layouts as they are, so they have no counterpart.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Mapping

import torch
from torch import nn

ITEMS = ("model", "optimizer", "ema")


def partial_load(model: nn.Module, source: Mapping[str, Any],
                 verbose: bool = True) -> tuple[list[str], list[str]]:
    """Non-strict, shape-filtered load into ``model``'s state_dict: entries
    whose name exists in ``source`` with the same shape are copied (cast to
    the target's dtype); the rest keep their values. -> (loaded, kept)."""
    loaded, kept, new = [], [], {}
    for name, target in model.state_dict().items():
        src = source.get(name)
        if src is not None and tuple(src.shape) == tuple(target.shape):
            new[name] = torch.as_tensor(src)
            loaded.append(name)
        else:
            kept.append(name)
    model.load_state_dict(new, strict=False)
    if verbose:
        print(f"[checkpoint] partial load: {len(loaded)} loaded, {len(kept)} kept")
    return loaded, kept


def trainable_mask(model: nn.Module, freeze_substrings) -> dict[str, bool]:
    """Parameter name -> False where the name, or the JAX package's name of
    the same leaf (``backbone/stem/conv/kernel`` for
    ``backbone.conv0.conv.weight``, `models.import_jax.jax_paths`), contains
    any frozen substring (the ``trainable`` map of `train.build_optimizer`),
    so a JAX ``model.freeze`` list freezes the same leaves here."""
    from ..models.import_jax import jax_paths

    jax = jax_paths(model) if freeze_substrings else {}

    def names(name):
        return (name, *(p[len("params/"):] for p in jax.get(name, ()) if p.startswith("params/")))

    return {name: not any(s in n for s in freeze_substrings for n in names(name))
            for name, _ in model.named_parameters()}


def load_torch_state(path: str, strip_module_prefix: bool = True) -> dict[str, torch.Tensor]:
    """A torch checkpoint -> {name: CPU tensor}, floating tensors as float32.

    Takes a bare state_dict, ``{'model': state_dict}`` or ``{'model':
    nn.Module}`` (ultralytics), and strips DataParallel's ``module.``
    prefix. The file is unpickled in full (``weights_only=False``, as a
    pickled module needs): load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    out = {}
    for name, tensor in ckpt.items():
        if strip_module_prefix and name.startswith("module."):
            name = name[len("module."):]
        tensor = torch.as_tensor(tensor).detach().cpu()
        out[name] = tensor.float() if tensor.is_floating_point() else tensor
    return out


def _host_copy(obj: Any, pinned: list) -> Any:
    """Copy every tensor of a nested state to host memory: CUDA tensors into
    pinned buffers with non-blocking copies (listed in ``pinned``; the
    caller synchronises once), CPU tensors cloned."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            pinned.append(out)
            return out
        return t.clone()
    if isinstance(obj, dict):
        return {k: _host_copy(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pinned) for v in obj)
    return obj


def _nbytes(obj: Any) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


class CheckpointManager:
    """Run checkpoints ``<dir>/<step>/{model,optimizer,ema}.pt + meta.json``,
    the newest ``max_to_keep`` retained, plus the best-metric slot
    ``<dir>/best/<step>/`` and ``best.json``. One write is in flight at a
    time: `save` waits for the previous one before it copies.

    A manager changes its directory only when it saves: the first `save`
    creates it and removes the temporary entries of writes cut off by a
    crash. A manager that only restores (eval, infer) leaves it as it is,
    so it may read the run of a trainer that is still writing there."""

    def __init__(self, directory: str, max_to_keep: int | None = 5):
        self.directory = os.path.abspath(directory)
        self.best_dir = os.path.join(self.directory, "best")
        self.max_to_keep = max_to_keep
        self._cleaned = False
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        self._best_metric = None
        self.last_save: dict = {}  # host_copy_s, bytes of the latest save
        best_json = os.path.join(self.directory, "best.json")
        if os.path.exists(best_json):
            try:
                with open(best_json) as f:
                    self._best_metric = json.load(f).get("metric")
            except (json.JSONDecodeError, OSError):
                pass

    # -- listing -------------------------------------------------------------
    @staticmethod
    def _steps(root: str) -> list[int]:
        if not os.path.isdir(root):
            return []
        return sorted(int(n) for n in os.listdir(root)
                      if n.isdigit() and os.path.isdir(os.path.join(root, n)))

    def all_steps(self) -> list[int]:
        return self._steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def available_items(self, step: int | None = None) -> set[str]:
        """Item names in a saved step ('meta' included)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return set()
        d = os.path.join(self.directory, str(step))
        if not os.path.isdir(d):
            return set()
        return {os.path.splitext(n)[0] for n in os.listdir(d) if n.endswith((".pt", ".json"))}

    # -- save ----------------------------------------------------------------
    def save(self, step: int, model: Mapping[str, torch.Tensor], optimizer: dict | None = None,
             ema: Mapping[str, torch.Tensor] | None = None, extra: dict | None = None,
             metric: float | None = None, higher_is_better: bool = True) -> None:
        """Snapshot the items to host memory now and write them in the
        background. ``model``: a state_dict (the RAW weights and BN
        buffers); ``optimizer``: its ``state_dict()``; ``ema``: the EMA
        shadow parameters. A step already on disk is overwritten (a
        preemption checkpoint holds the interrupted epoch's slot)."""
        self.wait()
        if not self._cleaned:
            os.makedirs(self.directory, exist_ok=True)
            for root in (self.directory, self.best_dir):  # writes cut off by a crash
                if os.path.isdir(root):
                    for name in os.listdir(root):
                        if name.startswith(".tmp-"):
                            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            self._cleaned = True
        meta = dict(extra or {})
        meta["date"] = datetime.datetime.now().isoformat()
        meta["step"] = int(step)
        items = {k: v for k, v in (("model", model), ("optimizer", optimizer), ("ema", ema))
                 if v is not None}
        t0 = time.perf_counter()
        pinned: list = []
        snap = {k: _host_copy(v, pinned) for k, v in items.items()}
        if pinned:
            torch.cuda.synchronize()
        self.last_save = {"host_copy_s": time.perf_counter() - t0, "bytes": _nbytes(snap)}
        meta["items"] = sorted(snap)
        better = metric is not None and (
            self._best_metric is None
            or (metric > self._best_metric if higher_is_better else metric < self._best_metric))
        if better:
            self._best_metric = float(metric)
        self._writer = threading.Thread(
            target=self._write, args=(int(step), snap, meta, metric if better else None),
            daemon=False)
        self._writer.start()

    def _write(self, step: int, snap: dict, meta: dict, best_metric: float | None) -> None:
        try:
            self._write_step(self.directory, step, snap, meta, self.max_to_keep)
            if best_metric is not None:
                self._write_step(self.best_dir, step, snap, meta, 1)
                tmp = os.path.join(self.directory, ".tmp-best.json")
                with open(tmp, "w") as f:
                    json.dump({"step": step, "metric": float(best_metric)}, f)
                os.replace(tmp, os.path.join(self.directory, "best.json"))
        except BaseException as e:  # re-raised by wait() on the caller's thread
            self._error = e

    @classmethod
    def _write_step(cls, root: str, step: int, snap: dict, meta: dict,
                    max_to_keep: int | None) -> None:
        os.makedirs(root, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=root)
        try:
            for name, obj in snap.items():
                torch.save(obj, os.path.join(tmp, f"{name}.pt"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            final = os.path.join(root, str(step))
            if os.path.exists(final):
                old = tempfile.mkdtemp(prefix=f".tmp-old-{step}-", dir=root)
                os.replace(final, os.path.join(old, "step"))
                os.replace(tmp, final)
                shutil.rmtree(old)
            else:
                os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        steps = cls._steps(root)
        if max_to_keep is not None:
            for s in steps[: max(len(steps) - max_to_keep, 0)]:
                shutil.rmtree(os.path.join(root, str(s)), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int | None = None, best: bool = False,
                items: tuple[str, ...] | None = None) -> dict:
        """-> {'state': {item: loaded object}, 'meta': dict}, tensors on the
        CPU. ``items`` limits what is read (missing ones are skipped: eval
        needs only the model and EMA); ``best=True`` reads the best slot."""
        self.wait()
        root = self.best_dir if best else self.directory
        steps = self._steps(root)
        if step is None:
            if not steps:
                raise FileNotFoundError(f"no checkpoint under {root}")
            step = steps[-1]
        d = os.path.join(root, str(step))
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint {d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        state = {}
        for name in items or ITEMS:
            path = os.path.join(d, f"{name}.pt")
            if os.path.exists(path):
                state[name] = torch.load(path, map_location="cpu", weights_only=True)
        return {"state": state, "meta": meta}

    def wait(self) -> None:
        """Join the write in flight; re-raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def restore_inference_weights(directory: str, model: nn.Module, best: bool = False) -> dict:
    """Load a run checkpoint's weights into ``model`` for evaluation or
    serving: the EMA parameters when the run kept them, else the raw ones,
    with the checkpoint's BN statistics either way. -> the step's meta."""
    restored = CheckpointManager(directory).restore(best=best, items=("model", "ema"))
    model.load_state_dict(restored["state"]["model"])
    ema = restored["state"].get("ema")
    if ema is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(ema[name])
    return restored["meta"]
