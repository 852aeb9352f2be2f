"""Tensor (model-axis) parallelism: channel-sharded convs and linears (port
of fastvision_tpu/parallel/tensor_shard.py).

The JAX package annotates parameter shardings only (each kernel's output
channels over the mesh's ``model`` axis) and lets GSPMD partition the same
program. The port does by hand what that program computes, Megatron's
column-parallel pair around every sharded layer:

  - `tp_spec`: the JAX rule on the port's layouts. The output-channel
    dimension is dim 0 of a conv weight ``[Cout, Cin, kh, kw(, kt)]``, of a
    linear weight ``[out, in]`` and of a per-channel vector; it is sharded
    when the axis divides it, else the tensor is replicated;
  - `shard_module`: each rank keeps its ``1/model`` slice of every conv
    (``groups == 1``) and ``nn.Linear`` whose output channels the axis
    divides (weight and bias). Such a layer computes its slice of the
    output and all-gathers it over the model axis, so the next layer sees
    the whole tensor, as GSPMD's result is. Its input passes through
    `_CopyToModel` (identity forward, all-reduce over the model axis
    backward: each rank's input gradient is the share through its output
    channels) and its output through `core.distributed.all_gather_dim`
    (all-gather forward, this rank's slice of the gradient backward). Every other
    layer (BN, grouped convs, heads whose width the axis does not divide)
    runs replicated on whole tensors, so every rank computes the same
    gradients for it, and every rank's sharded weight gets its slice's
    whole gradient. Data parallelism then averages each parameter over the
    data axis (ranks of one model index hold the same slices);
  - `tp_global_norm`: the global norm of gradients some of which are
    slices: the slices' squares are summed over the model axis;
  - `full_state` / `load_full_state`: the model's and optimizer's state in
    the one-process format (slices gathered; a whole state sliced), so a
    run saved at ``mesh_model=2`` resumes at ``mesh_model=1`` and the
    reverse.

Grouped convs stay replicated where the JAX package shards their kernels:
a slice of their output channels needs a slice of the input's too. The
arithmetic is the same; each rank holds their whole weight.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..core.distributed import Axis, all_gather_dim, axis, memory_format_of

# the attribute a sharded parameter carries: the dimension it is sliced on
SHARD_ATTR = "tp_shard_dim"


def tp_spec(x, axis_size: int) -> int | None:
    """The dimension of a port parameter (or shape) that tensor parallelism
    shards over a model axis of ``axis_size`` ranks (its output channels,
    dim 0), or None where it is replicated (a scalar, or output channels
    the axis does not divide)."""
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    if not shape or shape[0] % axis_size:
        return None
    return 0


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis backward."""

    @staticmethod
    def forward(ctx, x, ax: Axis):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=memory_format_of(g))
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


class _ColumnParallel:
    """The forward hooks of one sharded layer (a plain object, so a
    ``deepcopy`` of the model copies them)."""

    def __init__(self, dim: int):
        self.dim = dim

    def pre(self, module, args):
        return (_CopyToModel.apply(args[0], axis("model")), *args[1:])

    def post(self, module, args, out):
        dim = self.dim if self.dim >= 0 else out.dim() + self.dim
        return all_gather_dim(out, dim, axis("model"))


def shardable(module: nn.Module, axis_size: int) -> bool:
    """Whether `shard_module` slices ``module``: a conv with ``groups == 1``
    or an ``nn.Linear``, whose output channels ``axis_size`` divides."""
    if isinstance(module, nn.Linear):
        return tp_spec(module.weight, axis_size) == 0
    if isinstance(module, nn.modules.conv._ConvNd):
        return module.groups == 1 and not module.transposed and \
            tp_spec(module.weight, axis_size) == 0
    return False


@torch.no_grad()
def shard_module(model: nn.Module, mesh=None) -> list[str]:
    """Shard ``model`` in place over the mesh's model axis (the process's
    mesh, `core.mesh.use_mesh`; ``mesh`` is checked against it): every
    `shardable` layer keeps this rank's slice of its output channels (the
    same Parameter objects, so an optimizer built on them stays bound) and
    runs as a column-parallel pair (module docstring). -> the names of the
    sharded parameters. With one rank on the axis the model is left as it
    is."""
    ax = axis("model")
    if mesh is not None and mesh.model != ax.size:
        raise ValueError(f"mesh model axis {mesh.model} but the process's mesh has {ax.size}: "
                         "build the mesh with core.mesh.create_mesh / use_mesh first")
    names = []
    if ax.size == 1:
        return names
    for mname, m in model.named_modules():
        if not shardable(m, ax.size):
            continue
        for pname, p in m.named_parameters(recurse=False):
            n = p.shape[0] // ax.size
            p.data = p.data[ax.index * n:(ax.index + 1) * n].clone(
                memory_format=torch.preserve_format)
            setattr(p, SHARD_ATTR, 0)
            names.append(f"{mname}.{pname}" if mname else pname)
        hooks = _ColumnParallel(-1 if isinstance(m, nn.Linear) else 1)
        m.register_forward_pre_hook(hooks.pre)
        m.register_forward_hook(hooks.post)
    return names


def is_tensor_parallel(model: nn.Module) -> bool:
    """Whether `shard_module` sharded any of ``model``'s parameters."""
    return any(hasattr(p, SHARD_ATTR) for p in model.parameters())


def tp_global_norm(norms: list[torch.Tensor], params) -> torch.Tensor:
    """The global norm from the per-tensor ``norms`` of the gradients of
    ``params`` (same order): the sharded ones' squares summed over the
    model axis first. Without sharded parameters, ``||norms||``."""
    sharded = [hasattr(p, SHARD_ATTR) for p in params]
    if not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    part = torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum()
    dist.all_reduce(part, group=axis("model").group)
    rest = [n for n, s in zip(norms, sharded) if not s]
    return torch.sqrt(part + (torch.stack(rest).square().sum() if rest else 0.0))


def _gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    return all_gather_dim(t.detach(), dim, axis("model"))


def _slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    ax = axis("model")
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n)


def _optimizer_params(optimizer) -> tuple[Any, list]:
    from ..train.optim import MultiSteps

    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    return inner, [p for g in inner.param_groups for p in g["params"]]


def full_state(model: nn.Module, optimizer=None) -> tuple[dict, Any]:
    """The sharded model's (and optimizer's) state in the one-process
    format, on every rank: each slice all-gathered over the model axis (a
    collective: every rank calls it), the optimizer's per-parameter state
    of a slice's shape (momentum, Adam's moments, `MultiSteps`' means) too."""
    from ..train.optim import MultiSteps

    dims = {n: getattr(p, SHARD_ATTR) for n, p in model.named_parameters()
            if hasattr(p, SHARD_ATTR)}
    model_sd = {k: _gather(v, dims[k]) if k in dims else v
                for k, v in model.state_dict().items()}
    if optimizer is None:
        return model_sd, None
    inner, params = _optimizer_params(optimizer)

    def gather_state(sd: dict) -> dict:
        state = {}
        for i, s in sd["state"].items():
            d = getattr(params[i], SHARD_ATTR, None)
            state[i] = {k: _gather(v, d) if d is not None and isinstance(v, torch.Tensor)
                        and v.shape == params[i].shape else v for k, v in s.items()}
        return {**sd, "state": state}

    opt_sd = gather_state(inner.state_dict())
    if isinstance(optimizer, MultiSteps):
        acc = [_gather(a, getattr(p, SHARD_ATTR)) if hasattr(p, SHARD_ATTR) else a
               for a, p in zip(optimizer.acc, optimizer.params)]
        opt_sd = {"inner": opt_sd, "every_k": optimizer.every_k,
                  "mini_step": optimizer.mini_step, "acc": acc}
    return model_sd, opt_sd


def load_full_state(model: nn.Module, model_sd: dict, optimizer=None,
                    opt_sd: dict | None = None) -> None:
    """Load a one-process-format state into the sharded model (and
    optimizer): each sharded tensor's slice is this rank's."""
    from ..train.optim import MultiSteps

    dims = {n: getattr(p, SHARD_ATTR) for n, p in model.named_parameters()
            if hasattr(p, SHARD_ATTR)}
    model.load_state_dict({k: _slice(v, dims[k]) if k in dims else v
                           for k, v in model_sd.items()})
    if optimizer is None or opt_sd is None:
        return
    inner, params = _optimizer_params(optimizer)
    multi = isinstance(optimizer, MultiSteps)
    sd = opt_sd["inner"] if multi else opt_sd
    state = {}
    for i, s in sd["state"].items():
        p = params[int(i)]
        d = getattr(p, SHARD_ATTR, None)
        state[i] = {k: _slice(v, d) if d is not None and isinstance(v, torch.Tensor)
                    and v.dim() == p.dim() and v.shape[d] == p.shape[d] * axis("model").size
                    else v for k, v in s.items()}
    sliced = {**sd, "state": state}
    if multi:
        acc = [_slice(a, getattr(p, SHARD_ATTR)) if hasattr(p, SHARD_ATTR) else a
               for a, p in zip(opt_sd["acc"], optimizer.params)]
        optimizer.load_state_dict({**opt_sd, "inner": sliced, "acc": acc})
    else:
        optimizer.load_state_dict(sliced)
