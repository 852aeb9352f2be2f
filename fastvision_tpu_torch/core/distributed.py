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
  - `data_parallel`: the context in which a train-mode forward is one rank's
    share of a global batch. Inside it, with more than one rank, BN
    normalizes over the global batch (`nn.layers`), the losses take their
    denominators from it (`train.losses`), and `global_sum` /
    `all_gather_cat` reach the other ranks; outside it, or with one rank,
    every layer and loss runs as in a single process.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator, Sequence

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


_ACTIVE = {"world": 1}


@contextlib.contextmanager
def data_parallel() -> Iterator[int]:
    """Run the enclosed forward and loss as this rank's share of a global
    batch split evenly over the process group. -> the world size in force
    (1 without a group)."""
    prev = _ACTIVE["world"]
    _ACTIVE["world"] = world_size()
    try:
        yield _ACTIVE["world"]
    finally:
        _ACTIVE["world"] = prev


def dp_world() -> int:
    """The number of ranks sharing the global batch: > 1 only inside
    `data_parallel` in a group of more than one process."""
    return _ACTIVE["world"]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks of `data_parallel` (``t`` itself
    outside), as a new tensor; no gradient flows through the sum."""
    if dp_world() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along dim 0 in
    rank order, on every rank (``t`` itself without a group)."""
    if world_size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def barrier() -> None:
    if is_initialized():
        dist.barrier()
