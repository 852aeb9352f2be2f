"""The ('data', 'model', 'time') mesh over the process group (port of
fastvision_tpu/core/mesh.py).

The JAX package's mesh names three axes: ``data`` (batch sharding),
``model`` (channel sharding, `parallel.tensor_shard`) and ``time`` (a
clip's time axis, `parallel.time_shard`). The port's `Mesh` spans the
``torch.distributed`` process group with one rank per device, in the JAX
package's order: ``create_mesh`` reshapes its device list to
``(data, model, time)`` row-major, so rank ``(d * model + m) * time + t``
holds mesh position (d, m, t).

  - `create_mesh` / `MeshConfig`: ``data`` None or 0 takes every rank that
    ``model x time`` leaves; axes that do not multiply to the world size
    raise. It builds one process group per axis (and one over the data and
    time axes together, the ``batch`` axis) and makes them the process's
    mesh (`core.distributed.axis`);
  - `shard_batch`: this rank's contiguous share of a global batch by its
    data index (every rank of one data index holds the same share), or a
    host-local batch passed through (``per_host``);
  - `local_batch_size`, `replicate` (rank 0's tensors broadcast);
  - `enable_compile_cache`: the JAX package's persistent compilation cache;
    here the port's compiled artefacts, its native libraries.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .distributed import Axis, is_initialized, rank, set_axes, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"
BATCH_AXES = (DATA_AXIS, TIME_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model', 'time') mesh of ``data * model * time`` ranks."""

    data: int
    model: int = 1
    time: int = 1

    def __post_init__(self):
        for name in ("data", "model", "time"):
            if getattr(self, name) < 1:
                raise ValueError(f"mesh axis {name} must be >= 1, got {self}")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, TIME_AXIS: self.time}

    @property
    def size(self) -> int:
        return self.data * self.model * self.time

    @property
    def rank(self) -> int:
        return rank()

    def coords(self, r: int | None = None) -> dict[str, int]:
        """Rank ``r``'s (this rank's) position on each axis."""
        r = rank() if r is None else r
        return {DATA_AXIS: r // (self.model * self.time), MODEL_AXIS: r // self.time % self.model,
                TIME_AXIS: r % self.time}

    def ranks_along(self, names: tuple[str, ...]) -> list[list[int]]:
        """The rank lists of the groups spanning axes ``names``: one per
        position on the other axes, each in mesh order."""
        grid = np.arange(self.size).reshape(self.data, self.model, self.time)
        order = (DATA_AXIS, MODEL_AXIS, TIME_AXIS)
        keep = [order.index(n) for n in order if n in names]
        rest = [i for i in range(3) if i not in keep]
        moved = grid.transpose(*rest, *keep).reshape(-1, int(np.prod([grid.shape[i]
                                                                      for i in keep])))
        return [row.tolist() for row in moved]


# the groups built per mesh shape, for the process group they were built in
_GROUPS: dict = {"world": None, "meshes": {}}


def _axes(mesh: Mesh) -> dict[str, Axis]:
    """The mesh's `Axis` per name for this rank, building each axis's groups
    (a collective: every rank builds every group, in one order) once per
    process group. An axis of one rank needs no group, one of every rank
    is the world."""
    if _GROUPS["world"] is not dist.group.WORLD:
        _GROUPS.update(world=dist.group.WORLD, meshes={})
    key = (mesh.data, mesh.model, mesh.time)
    if key not in _GROUPS["meshes"]:
        me, axes = rank(), {}
        for name, names in ((DATA_AXIS, (DATA_AXIS,)), (MODEL_AXIS, (MODEL_AXIS,)),
                            (TIME_AXIS, (TIME_AXIS,)), ("batch", BATCH_AXES)):
            if name == "batch" and mesh.time == 1:  # the data axis's groups
                axes[name] = axes[DATA_AXIS]
                continue
            lists = mesh.ranks_along(names)
            size = len(lists[0])
            mine = next(r for r in lists if me in r)
            group = None
            if 1 < size < mesh.size:
                for ranks in lists:  # every rank creates every group
                    g = dist.new_group(ranks)
                    if ranks is mine:
                        group = g
            axes[name] = Axis(group, size, mine.index(me))
        _GROUPS["meshes"][key] = axes
    return _GROUPS["meshes"][key]


def use_mesh(mesh: Mesh) -> Mesh:
    """Make ``mesh`` the process's mesh (`core.distributed.axis`), building
    its groups the first time (a collective). -> ``mesh``."""
    if is_initialized():
        if mesh.size != world_size():
            raise ValueError(f"mesh {mesh.data}x{mesh.model}x{mesh.time} != "
                             f"{world_size()} processes")
        set_axes(_axes(mesh))
    return mesh


def create_mesh(data: int | None = None, model: int = 1, time: int = 1) -> Mesh:
    """The mesh over the process group (one rank without a group), made the
    process's mesh (`use_mesh`). ``data`` None or 0 takes every rank that
    ``model x time`` leaves; the axes must multiply to the world size."""
    world = world_size()
    if not data:
        data = world // (model * time)
    if data * model * time != world or min(data, model, time) < 1:
        raise ValueError(f"mesh {data}x{model}x{time} != {world} processes")
    return use_mesh(Mesh(data, model, time))


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
    holds the same global batch and keeps the contiguous 1/data share of
    its data index along dim 0 (so the data ranks' parts concatenate back
    into the batch, and the ranks of one data index hold the same part);
    with ``per_host=True`` the batch is already this rank's local slice
    (loaders built with ``host_shard``) and passes through. Non-array
    values pass through."""
    count = mesh.shape[DATA_AXIS]
    if per_host or count == 1:
        return batch
    index = mesh.coords()[DATA_AXIS]
    return {k: _take_shard(v, index, count) for k, v in batch.items()}


def enable_compile_cache(cache_dir: str) -> str:
    """Keep the port's compiled artefacts in ``cache_dir`` (created): the
    native libraries of ``csrc/`` (the CUDA kernels built by nvcc, the host
    decoders and encoders by the host compiler) are built into and loaded
    from it (`cuda_build.set_build_dir`), so a restarted run, another rank
    or a loader worker on the same host finds them built. Libraries are
    named by a hash of their source and flags, and written through a
    temporary file and a rename, so processes may share the directory. Call
    it before the process's first native build or load (the CLI does, from
    ``compile_cache``): a directory other than the one a library was
    already built or loaded from raises. -> the absolute path."""
    from .. import cuda_build

    return cuda_build.set_build_dir(cache_dir)


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
