"""Video time-axis (sequence) parallelism (port of
fastvision_tpu/parallel/time_shard.py).

A clip's frames are split over the mesh's ``time`` axis: each rank of it
holds ``[B, T/n, ...]``. A temporal conv of kernel ``2 * halo + 1`` then
needs ``halo`` frames from each neighbour: `halo_exchange_time` appends
them (zero frames at the clip's first and last rank, so a conv without
time padding over the result is the whole clip's conv with zero padding),
and its backward sends each halo's gradient back to the rank that owns the
frames, which adds it to theirs. `time_sum` is a sum over the time axis
whose backward is the same sum (the adjoint of an all-reduce), for a head
that pools over the whole clip.

The exchange is an all-reduce of a buffer in which each rank writes its
two boundary slabs (`core.distributed`: the one collective form that NCCL
and gloo, on the CPU and on a card, all take).

    y = time_sharded_conv(lambda x: conv_valid(x), clip, mesh, halo=1)
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..core.distributed import Axis, all_gather_dim, axis, memory_format_of


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis, halo: int, dim: int):
        length = x.shape[dim]
        if halo > length:
            raise ValueError(f"halo of {halo} frames > the {length} frames this rank holds")
        ctx.ax, ctx.halo, ctx.dim, ctx.length = ax, halo, dim, length
        slab = list(x.shape)
        slab[dim] = halo
        left = right = None
        if ax.size > 1:
            edges = torch.zeros([ax.size, 2, *slab], dtype=x.dtype, device=x.device)
            edges[ax.index, 0] = x.narrow(dim, 0, halo)
            edges[ax.index, 1] = x.narrow(dim, length - halo, halo)
            dist.all_reduce(edges, group=ax.group)
            left = edges[ax.index - 1, 1] if ax.index > 0 else None
            right = edges[ax.index + 1, 0] if ax.index < ax.size - 1 else None
        zero = torch.zeros(slab, dtype=x.dtype, device=x.device)
        out = torch.cat([zero if left is None else left, x, zero if right is None else right],
                        dim)
        return out.contiguous(memory_format=memory_format_of(x))

    @staticmethod
    def backward(ctx, g):
        ax, h, dim, length = ctx.ax, ctx.halo, ctx.dim, ctx.length
        dx = g.narrow(dim, h, length).clone(memory_format=memory_format_of(g))
        if ax.size == 1:
            return dx, None, None, None
        slab = list(g.shape)
        slab[dim] = h
        back = torch.zeros([ax.size, 2, *slab], dtype=g.dtype, device=g.device)
        if ax.index > 0:  # my left halo is my left neighbour's tail
            back[ax.index - 1, 1] = g.narrow(dim, 0, h)
        if ax.index < ax.size - 1:  # my right halo is my right neighbour's head
            back[ax.index + 1, 0] = g.narrow(dim, h + length, h)
        dist.all_reduce(back, group=ax.group)
        dx.narrow(dim, 0, h).add_(back[ax.index, 0])
        dx.narrow(dim, length - h, h).add_(back[ax.index, 1])
        return dx, None, None, None


def halo_exchange_time(x: torch.Tensor, axis_name: str = "time", halo: int = 1,
                       dim: int = 1) -> torch.Tensor:
    """Append ``halo`` frames from each neighbour along the time axis
    ``dim`` of this rank's shard (axis 1 of ``[B, T_local, ...]`` as in the
    JAX package; 2 for an NCDHW activation) -> ``T_local + 2 * halo``
    frames; the first and last rank's outer halo is zeros. Differentiable:
    the halos' gradients go back to their owners. With one rank on the
    axis, zero padding."""
    return _HaloExchange.apply(x, axis(axis_name), halo, dim)


class _TimeSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax: Axis):
        ctx.ax = ax
        out = x.clone()
        dist.all_reduce(out, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


def time_sum(x: torch.Tensor, axis_name: str = "time") -> torch.Tensor:
    """``x`` summed over the time axis's ranks, on each of them. Its
    gradient is the sum of theirs: every rank's loss counts once per rank,
    as data parallelism over the data and time axes then averages it."""
    ax = axis(axis_name)
    return x if ax.size == 1 else _TimeSum.apply(x, ax)


def time_sharded_conv(fn: Callable[[torch.Tensor], torch.Tensor], clip: torch.Tensor,
                      mesh=None, halo: int = 1, axis_name: str = "time") -> torch.Tensor:
    """Run a temporal-window function over a time-sharded clip.

    ``clip`` is the whole clip ``[B, T, ...]`` on every rank of the time
    axis; each rank takes its ``T/n`` frames, extends them by ``halo`` on
    each side (`halo_exchange_time`) and calls ``fn``, which must return
    ``[B, T/n, ...]`` (consume the halo: a conv without time padding of
    kernel ``2 * halo + 1`` does). -> the whole output, the ranks' parts
    all-gathered along time (its gradient: this rank's part). ``mesh``, when
    given, must be the process's mesh (`core.mesh.use_mesh`)."""
    ax = axis(axis_name)
    if mesh is not None and mesh.time != ax.size:
        raise ValueError(f"mesh time axis {mesh.time} but the process's mesh has {ax.size}")
    t = clip.shape[1]
    if t % ax.size:
        raise ValueError(f"{t} frames do not split over {ax.size} time ranks")
    n = t // ax.size
    local = clip.narrow(1, ax.index * n, n)
    out = fn(halo_exchange_time(local, axis_name, halo, dim=1))
    return all_gather_dim(out, 1, ax)
