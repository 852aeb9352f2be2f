"""The data-parallel mesh over the process group (port of
fastvision_tpu/core/mesh.py).

The JAX package's mesh names three axes: ``data`` (batch sharding), ``model``
(channel sharding) and ``time`` (a clip's time axis). The port's `Mesh`
spans the ``torch.distributed`` process group with one rank per device:
its ``data`` axis is the world size, and ``model`` / ``time`` above 1 are
not ported yet (ROADMAP Queue 1, item 17: tensor parallel, time sharding).

  - `create_mesh` / `MeshConfig`: ``data`` None or 0 means every rank;
  - `shard_batch`: this rank's contiguous 1/P of a global batch, or a
    host-local batch passed through (``per_host``);
  - `local_batch_size`, `replicate` (rank 0's tensors broadcast).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .distributed import is_initialized, rank, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model', 'time') mesh of ``data`` ranks; a ``model`` or
    ``time`` axis above 1 is not ported yet and raises."""

    data: int
    model: int = 1
    time: int = 1

    def __post_init__(self):
        for size, what in ((self.model, "tensor parallel (mesh_model > 1)"),
                           (self.time, "time sharding (mesh_time > 1)")):
            if size != 1:
                raise NotImplementedError(
                    f"{what} is not ported yet (ROADMAP Queue 1, item 17)")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, TIME_AXIS: self.time}

    @property
    def rank(self) -> int:
        return rank()


def create_mesh(data: int | None = None, model: int = 1, time: int = 1) -> Mesh:
    """The mesh over the process group (one rank without a group). The
    data axis takes every rank (``data`` None or 0) or must equal the
    world size; a model or time axis above 1 raises (`Mesh`)."""
    world = world_size()
    mesh = Mesh(data or world, model, time)
    if mesh.data != world:
        raise ValueError(f"mesh {mesh.data}x{model}x{time} != {world} processes")
    return mesh


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Serializable mesh description (goes into the run config)."""

    data: int | None = None
    model: int = 1
    time: int = 1

    def build(self) -> Mesh:
        return create_mesh(self.data, self.model, self.time)


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by data axis {n}")
    return global_batch_size // n


def _take_shard(x: Any, index: int, count: int) -> Any:
    if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
        b = local_batch_size(x.shape[0], Mesh(count))
        return x[index * b:(index + 1) * b]
    return x


def shard_batch(batch: dict, mesh: Mesh, per_host: bool = False) -> dict:
    """This rank's part of a batch dict: with ``per_host=False`` every rank
    holds the same global batch and keeps its contiguous 1/P along dim 0
    (rank order, so the ranks' parts concatenate back into the batch);
    with ``per_host=True`` the batch is already this rank's local slice
    (loaders built with ``host_shard``) and passes through. Non-array
    values pass through."""
    count = mesh.shape[DATA_AXIS]
    if per_host or count == 1:
        return batch
    return {k: _take_shard(v, mesh.rank, count) for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors: Any, mesh: Mesh | None = None) -> Any:
    """Broadcast rank 0's values into ``tensors`` (a module's parameters and
    buffers, or a list / dict of tensors) on every rank, in place. ->
    ``tensors``."""
    if not is_initialized() or world_size() == 1:
        return tensors
    if isinstance(tensors, torch.nn.Module):
        items = [*tensors.parameters(), *tensors.buffers()]
    elif isinstance(tensors, dict):
        items = list(tensors.values())
    else:
        items = list(tensors)
    for t in items:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return tensors
