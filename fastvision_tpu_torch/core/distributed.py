"""Process groups: multi-process and multi-host start-up, and the
global-batch context the train step runs in (port of
fastvision_tpu/core/distributed.py).

  - `initialize_multihost`: ``torch.distributed.init_process_group`` from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``LOCAL_RANK``) or from an explicit coordinator,
    process count and id; NCCL for CUDA, gloo for the CPU. A group that
    cannot form raises: nothing carries on as N single-process runs;
  - `set_visible_devices`: ``CUDA_VISIBLE_DEVICES``;
  - `process_info`: rank, world size and device counts;
  - the mesh's axes (`set_axes`, which `core.mesh.create_mesh` calls;
    `axis`): the process group of each of ``data``, ``model`` and
    ``time``, and of ``batch``, the data and time axes together (the ranks
    of one model index: they share the global batch's BN statistics and
    average their gradients). Without a mesh the data axis is the world;
  - `data_parallel`: the context in which a train-mode forward is one rank's
    share of a global batch. Inside it, with more than one rank on the data
    (or time) axis, BN normalizes over the global batch and clip (`nn.layers`:
    the ``batch`` axis), the losses take their denominators from the global
    batch (`train.losses`: the ``data`` axis), and `global_sum` reaches the
    data axis; outside it, or with one rank, every layer and loss runs as
    in a single process;
  - `all_gather_dim`, `all_gather_cat`: gathers written as an all-reduce
    of a zero-filled buffer in which each rank writes its part (exact in
    every dtype), the one form that NCCL, gloo on the CPU and gloo ranks
    sharing a card all take (PyTorch's backend table lists only
    ``broadcast`` and ``all_reduce`` for gloo on CUDA tensors; the
    ``parallel`` phase of chip_smoke.py probes the others there).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Iterator, NamedTuple, Sequence

import torch
import torch.distributed as dist

# seconds a rank waits for the others to join (torch's own default is 30 min)
DEFAULT_TIMEOUT_S = 600.0


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         device: str | torch.device | None = None,
                         timeout_s: float | None = None) -> None:
    """Join (or start) the process group. With no arguments the rank, world
    size and coordinator come from torchrun's environment; explicit ones
    (``coordinator_address='host:port'``) take their place. ``device``: the
    entry point's device (None: CUDA): NCCL for CUDA, after
    ``torch.cuda.set_device(LOCAL_RANK)`` (else the rank modulo the local
    card count), gloo for the CPU. A second call in a process with a group
    returns. Raises when there is no group to join, or when the others do
    not come within ``timeout_s`` (`DEFAULT_TIMEOUT_S`, 600 s)."""
    if is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise RuntimeError(
            "multihost: no process group to join. Launch with torchrun (it sets RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or pass coordinator_address, "
            "num_processes and process_id")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost on CUDA, but CUDA is not available; pass "
                               "device='cpu' for a gloo group on the CPU")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)  # before any other CUDA call of this process
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", rank=int(process_id),
        world_size=int(num_processes),
        timeout=datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S),
        **({"device_id": torch.device("cuda", torch.cuda.current_device())}
           if backend == "nccl" else {}))


def set_visible_devices(device_ids: Sequence[int] | int) -> None:
    """Restrict the process to some local cards (before CUDA initializes)."""
    if isinstance(device_ids, int):
        device_ids = [device_ids]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(d) for d in device_ids)


def process_info() -> dict:
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": rank(), "process_count": world_size(),
            "local_device_count": local, "global_device_count": world_size(),
            "backend": dist.get_backend() if is_initialized() else None}


class Axis(NamedTuple):
    """One axis of the mesh as this rank sees it: the process group of the
    ranks along it (None: the whole world), their number, and this rank's
    index among them."""

    group: Any
    size: int
    index: int


_TRIVIAL = Axis(None, 1, 0)
# the axes of the mesh over the current process group (`set_axes`)
_MESH: dict = {"world": None, "axes": None}


def set_axes(axes: dict[str, Axis]) -> None:
    """Make ``axes`` (name -> `Axis`) the mesh of the current process
    group (as process-wide as the group itself: the layers that reach an
    axis find it here, as JAX code finds the mesh it runs under)."""
    _MESH["world"] = dist.group.WORLD if is_initialized() else None
    _MESH["axes"] = axes


def axis(name: str) -> Axis:
    """The `Axis` ``name`` ('data', 'model', 'time' or 'batch') of the mesh
    set over the current process group; without one the data and batch
    axes are the world and the others have one rank."""
    if not is_initialized():
        return _TRIVIAL
    axes = _MESH["axes"] if _MESH["world"] is dist.group.WORLD else None
    if axes is None:
        return Axis(None, world_size(), rank()) if name in ("data", "batch") else _TRIVIAL
    return axes[name]


_ACTIVE = {"data": _TRIVIAL, "batch": _TRIVIAL}


@contextlib.contextmanager
def data_parallel() -> Iterator[int]:
    """Run the enclosed forward and loss as this rank's share of a global
    batch split evenly over the data axis (and a clip split over the time
    axis). -> the data axis's size (1 without a group)."""
    prev = dict(_ACTIVE)
    _ACTIVE.update(data=axis("data"), batch=axis("batch"))
    try:
        yield _ACTIVE["data"].size
    finally:
        _ACTIVE.update(prev)


def dp_world() -> int:
    """The number of ranks sharing the global batch: > 1 only inside
    `data_parallel` with more than one rank on the data axis."""
    return _ACTIVE["data"].size


def batch_axis() -> Axis:
    """The ranks whose shares make up the global batch and clip (data x
    time) inside `data_parallel`; one rank outside it."""
    return _ACTIVE["batch"]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the data axis inside `data_parallel` (``t`` itself
    outside), as a new tensor; no gradient flows through the sum."""
    ax = _ACTIVE["data"]
    if ax.size == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=ax.group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim: int, ax: Axis):
        ctx.dim, ctx.ax, ctx.n = dim, ax, t.shape[dim]
        shape = list(t.shape)
        shape[dim] = ctx.n * ax.size
        buf = torch.empty(shape, dtype=t.dtype, device=t.device,
                          memory_format=memory_format_of(t)).zero_()
        buf.narrow(dim, ax.index * ctx.n, ctx.n).copy_(t)
        dist.all_reduce(buf, group=ax.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.ax.index * ctx.n, ctx.n), None, None


def all_gather_dim(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``t`` (same shape on each) concatenated along ``dim`` in
    their order on axis ``ax``, on every rank of it: an all-reduce of a
    zero-filled buffer in which each rank writes its part (in ``t``'s
    memory format). Its gradient is this rank's part of the output's (the
    consumers of the whole tensor compute the same on every rank)."""
    return t if ax.size == 1 else _AllGather.apply(t, dim, ax)


def memory_format_of(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` (``_3d``) for a 4-D (5-D) tensor laid out so, else
    the contiguous format."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last) \
            and not t.is_contiguous():
        return torch.channels_last
    if t.dim() == 5 and t.is_contiguous(memory_format=torch.channels_last_3d) \
            and not t.is_contiguous():
        return torch.channels_last_3d
    return torch.contiguous_format


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``t`` (same shape on each) concatenated along dim 0
    in their order, on every rank (``t`` itself with one data rank)."""
    return all_gather_dim(t, 0, axis("data"))


def barrier() -> None:
    if is_initialized():
        dist.barrier()
