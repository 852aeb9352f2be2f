"""FSDP (ZeRO-3) over the process group (port of fastvision_tpu/parallel/fsdp.py).

The JAX package shards every parameter leaf 1/N over the mesh's ``data``
axis and lets GSPMD gather it at use and reduce-scatter its gradient; the
optimizer state follows the parameters. The port does the same with
FSDP2's ``fully_shard``: each parameter becomes a DTensor sharded on the
dimension `fsdp_spec` picks, gathered before its module's forward and
backward, its gradient reduce-scattered, and the optimizer (built on the
sharded parameters) keeps its state 1/N per rank. The contract is the JAX
package's: FSDP-trained == data-parallel-trained.

`fsdp_spec` is the JAX rule on the port's layouts: the largest dimension
divisible by the axis size, ties to the last one, in the JAX package's
order of the same parameter (a conv's ``[Kh, Kw, Cin, Cout]`` for the
port's ``[Cout, Cin, Kh, Kw]``, a dense ``[in, out]`` for ``[out, in]``),
so it shards the same channel; leaves under ``min_size`` elements and
leaves without a divisible dimension are the ones the JAX package
replicates. FSDP2 manages every parameter of the modules it wraps and has
no replicated placement, so those are sharded on dimension 0 (padded where
uneven); the arithmetic is the same.

Checkpoints keep the single-process format (`full_state`,
`load_full_state`): the whole state is gathered to rank 0's host memory, the
optimizer's state keyed by parameter index as ``state_dict()`` keys it, so
a run saved under N-process FSDP resumes in one process, and the reverse.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

# the port's dimension at each position of the JAX package's layout, by rank
_JAX_ORDER = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def fsdp_spec(x, axis_size: int, min_size: int = 1024) -> int | None:
    """The dimension of a port parameter (or shape) that FSDP shards, or
    None where the JAX package replicates the same leaf."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < max(min_size, axis_size):
        return None
    order = _JAX_ORDER.get(len(shape), tuple(range(len(shape))))
    best, best_len = None, 0
    for d in order:  # the JAX rule over the JAX layout: ties go to the last
        if shape[d] % axis_size == 0 and shape[d] >= best_len:
            best, best_len = d, shape[d]
    return best


def _units(model: nn.Module, unit_numel: int) -> list[nn.Module]:
    """Modules gathered as one (each its own ``fully_shard`` group), bottom
    up: a module with submodules and its own forward, holding at least
    ``unit_numel`` elements not in a smaller unit. Containers (Sequential,
    ModuleList, ModuleDict) are never units: a model may call their members
    one by one, and a unit is gathered only when its own forward runs."""
    units = []

    def visit(m: nn.Module) -> int:
        n = sum(p.numel() for p in m.parameters(recurse=False))
        n += sum(visit(c) for c in m.children())
        if (m is not model and n >= unit_numel and any(True for _ in m.children())
                and not isinstance(m, (nn.Sequential, nn.ModuleList, nn.ModuleDict))):
            units.append(m)
            return 0
        return n

    visit(model)
    return units


def fsdp_shard_module(model: nn.Module, world: int, min_size: int = 1024,
                      unit_numel: int = 1 << 22) -> dict[int, str]:
    """Shard ``model`` in place over the process group's ``world`` ranks:
    ``fully_shard`` on each unit (`_units`) and on the root, parameters
    placed by `fsdp_spec`. Parameters are made contiguous first (the
    gathered ones are too; activations keep their memory format). -> {id
    of each former parameter: its name}, for `rebind_optimizer`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def placement(p: nn.Parameter):
        d = fsdp_spec(p, world, min_size)
        return Shard(0 if d is None else d)

    names = {id(p): n for n, p in model.named_parameters()}
    for p in model.parameters():  # FSDP2 shards contiguous tensors only (not channels_last)
        p.data = p.data.contiguous()
    for unit in _units(model, unit_numel):
        fully_shard(unit, shard_placement_fn=placement)
    fully_shard(model, shard_placement_fn=placement)
    return names


def rebind_optimizer(optimizer, names: dict[int, str], model: nn.Module) -> None:
    """Point an optimizer built on ``model``'s former parameters at the
    sharded ones (by name). It must not have stepped yet."""
    from ..train.optim import MultiSteps

    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    if inner.state:
        raise ValueError("FSDP placement needs an optimizer that has not stepped yet")
    new = dict(model.named_parameters())
    for group in inner.param_groups:
        group["params"] = [new[names[id(p)]] for p in group["params"]]
    if isinstance(optimizer, MultiSteps):
        optimizer.rebind()


def _param_names(model: nn.Module, inner) -> list[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in inner.param_groups for p in g["params"]]


def full_state(model: nn.Module, optimizer=None) -> tuple[dict, Any]:
    """The sharded model's (and optimizer's) whole state in the
    single-process format, on rank 0's host (empty / None elsewhere). A
    collective: every rank calls it."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    from ..core.distributed import rank
    from ..train.optim import MultiSteps

    options = StateDictOptions(full_state_dict=True, cpu_offload=True)
    model_sd = get_model_state_dict(model, options=options)
    if optimizer is None:
        return model_sd, None
    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    by_name = get_optimizer_state_dict(model, inner, options=options)
    if isinstance(optimizer, MultiSteps):
        acc = [a.full_tensor().cpu() if hasattr(a, "full_tensor") else a.cpu()
               for a in optimizer.acc]
    if rank() != 0:
        return model_sd, None
    index = {n: i for i, n in enumerate(_param_names(model, inner))}
    groups = []
    for g in by_name["param_groups"]:
        groups.append({**g, "params": [index[n] for n in g["params"]]})
    opt_sd = {"state": {index[n]: v for n, v in by_name["state"].items()},
              "param_groups": groups}
    if isinstance(optimizer, MultiSteps):
        opt_sd = {"inner": opt_sd, "every_k": optimizer.every_k,
                  "mini_step": optimizer.mini_step, "acc": acc}
    return model_sd, opt_sd


def load_full_state(model: nn.Module, model_sd: dict, optimizer=None,
                    opt_sd: dict | None = None) -> None:
    """Load a single-process-format state (every rank holds it whole) into
    the sharded model and optimizer. A collective."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )
    from torch.distributed.tensor import distribute_tensor

    from ..train.optim import MultiSteps

    options = StateDictOptions(full_state_dict=True)
    set_model_state_dict(model, model_sd, options=options)
    if optimizer is None or opt_sd is None:
        return
    multi = isinstance(optimizer, MultiSteps)
    inner = optimizer.inner if multi else optimizer
    if multi:
        if opt_sd.get("every_k") != optimizer.every_k:
            raise ValueError(f"optimizer state accumulates over {opt_sd.get('every_k')} "
                             f"calls, this optimizer over {optimizer.every_k}")
        optimizer.mini_step = int(opt_sd["mini_step"])
        with torch.no_grad():
            for a, saved in zip(optimizer.acc, opt_sd["acc"], strict=True):
                if hasattr(a, "device_mesh"):
                    full = saved.to(a.device, a.dtype)
                    a.to_local().copy_(
                        distribute_tensor(full, a.device_mesh, a.placements).to_local())
                else:
                    a.copy_(saved)
        opt_sd = opt_sd["inner"]
    names = _param_names(model, inner)
    by_name = {"state": {names[i]: v for i, v in opt_sd["state"].items()},
               "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                for g in opt_sd["param_groups"]]}
    set_optimizer_state_dict(model, inner, by_name, options=options)
