"""Pipeline (stage) parallelism: GPipe microbatch streaming over the mesh's
``model`` axis (port of fastvision_tpu/parallel/pipeline.py).

Rank ``i`` of the axis holds and runs stage ``i`` only. The schedule is the
JAX package's: ``n_micro + n_stages - 1`` ticks; at tick ``t`` rank 0 takes
microbatch ``t``, every rank applies its stage to the activation it holds,
the last rank banks microbatch ``t - (n_stages - 1)``, and a shift moves
each rank's output one stage right. So the outputs and the gradients are
the sequential chain's.

  - The shift is an all-reduce of an ``[n_stages - 1, ...]`` zero buffer in
    which rank ``i`` writes its output into slot ``i`` and from which rank
    ``i`` reads slot ``i - 1`` (`core.distributed`: the one collective form
    that NCCL and gloo, on the CPU and on a card, all take; gloo's
    ``send`` / ``recv`` with CUDA tensors fail).
  - Idle warm-up and drain ticks skip the stage's compute (the JAX package
    computes on a repeated or zero input there and masks it); every rank
    still takes part in every tick's all-reduce.
  - The backward is GPipe's: the ticks in reverse, each rank taking the
    vector-Jacobian product of its stage on each of its microbatches and
    sending its input's gradient to rank ``i - 1`` by the same all-reduce
    (the transpose of the shift). The whole schedule is one
    ``torch.autograd.Function``, so every rank runs every collective of the
    backward in one order. Each rank keeps its stage's autograd graph of
    every microbatch from the forward to the backward (GPipe's memory).
  - The outputs reach every rank by an all-reduce of the last rank's
    banked outputs (zeros elsewhere), the JAX package's masked ``psum``.
    Its backward is the identity on each rank, not an all-reduce: every
    rank computes the same loss from the same outputs, and the last rank's
    gradient of them is used once.
  - Gradients: each rank's stage parameters get the gradient of its own
    stage (a stacked parameter's other rows get zeros, through the
    indexing); the microbatches' gradient is all-reduced (rank 0 computes
    it, the others add zeros), so a replicated prefix (`pipeline_vit_apply`'s
    patch embedding) gets the whole gradient on every rank, as does a
    replicated suffix computed from the outputs.

Heterogeneous stages (`pipeline_hetero_apply`) ride a flat buffer sized to
the largest boundary, as in the JAX package: the boundary shapes come from
running the chain once on an empty microbatch (batch 0) before the
schedule. The JAX package's ravel / pad / ``lax.switch`` of every stage's
parameters is a single-program device trick and is not needed here: each
rank calls its own stage function with its own parameters.

Every rank of the model axis must call these functions together, with the
same microbatches (or the same images) and parameters that require a
gradient alike. Bubble fraction: (n_stages - 1) / (n_micro + n_stages - 1).

    mesh = use_mesh(Mesh(data=1, model=4))
    logits = pipeline_vit_apply(vit, images, mesh, n_micro=4)
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from ..core.distributed import Axis, axis
from ..core.mesh import MODEL_AXIS
from ..nn.layers import conv_bn_act, global_avg_pool, max_pool


def _axis(mesh, axis_name: str) -> Axis:
    ax = axis(axis_name)
    if mesh is not None and mesh.shape[axis_name] != ax.size:
        raise ValueError(f"mesh '{axis_name}' axis {mesh.shape[axis_name]} but the process's "
                         f"mesh has {ax.size}")
    return ax


class _Schedule:
    """What the forward leaves for the backward: the stage, the axis and
    the shapes of the boundaries around this rank."""

    def __init__(self, stage, ax: Axis, n_micro: int, in_shape, in_dtype, out_shape, out_dtype,
                 final_shape, final_dtype, buf_size: int, buf_dtype):
        self.stage, self.ax, self.n_micro = stage, ax, n_micro
        self.in_shape, self.in_dtype = in_shape, in_dtype  # this rank's input, per microbatch
        self.out_shape, self.out_dtype = out_shape, out_dtype  # this rank's output
        self.final_shape, self.final_dtype = final_shape, final_dtype  # the last stage's output
        self.buf_size, self.buf_dtype = buf_size, buf_dtype  # one slot of the shift's buffer


def _shift(sched: _Schedule, y: torch.Tensor | None, write_slot: int, read_slot: int,
           shape, dtype, device) -> torch.Tensor | None:
    """One shift: an all-reduce of an ``[n_stages - 1, buf_size]`` zero
    buffer in which this rank wrote ``y`` into ``write_slot`` (None: wrote
    nothing); -> slot ``read_slot`` as ``shape`` (None for no slot)."""
    ax = sched.ax
    buf = torch.zeros(ax.size - 1, sched.buf_size, dtype=sched.buf_dtype, device=device)
    if y is not None and 0 <= write_slot < ax.size - 1:
        flat = y.reshape(-1)
        buf[write_slot, :flat.numel()] = flat
    dist.all_reduce(buf, group=ax.group)
    if not 0 <= read_slot < ax.size - 1:
        return None
    return buf[read_slot, :math.prod(shape)].reshape(shape).to(dtype)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, mbs: torch.Tensor, *params):
        ax, n_micro = sched.ax, sched.n_micro
        me, last = ax.index, ax.size - 1
        ticks = n_micro + ax.size - 1
        # the stage runs on detached copies that require a gradient, so that
        # the backward can take its vector-Jacobian product by hand
        p_in = [p.detach().requires_grad_(p.requires_grad) for p in params]
        need_x = me > 0 or mbs.requires_grad
        saved = {}
        outs = torch.zeros((n_micro, *sched.final_shape), dtype=sched.final_dtype,
                           device=mbs.device)
        recv = None
        for t in range(ticks):
            m, y = t - me, None
            if 0 <= m < n_micro:
                x = mbs[m] if me == 0 else recv
                x = x.detach().requires_grad_(need_x)
                with torch.enable_grad():
                    y = sched.stage(p_in, x)
                saved[m] = (x, y)
                if me == last:
                    outs[m] = y.detach()
            if t < ticks - 1:
                recv = _shift(sched, y, me, me - 1, sched.in_shape, sched.in_dtype, mbs.device)
        dist.all_reduce(outs, group=ax.group)
        ctx.sched, ctx.saved, ctx.p_in = sched, saved, p_in
        ctx.mbs_meta = (mbs.shape, mbs.dtype, mbs.device, mbs.requires_grad)
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        sched, saved, p_in = ctx.sched, ctx.saved, ctx.p_in
        shape, dtype, device, mbs_grad = ctx.mbs_meta
        ax, n_micro = sched.ax, sched.n_micro
        me, last = ax.index, ax.size - 1
        ticks = n_micro + ax.size - 1
        grads = [None] * len(p_in)
        wanted = [p for p in p_in if p.requires_grad]
        g_mbs = torch.zeros(shape, dtype=dtype, device=device) if mbs_grad else None
        g_y = None  # the gradient of this rank's output at the current tick
        for t in reversed(range(ticks)):
            if t < ticks - 1:  # the reverse shift: rank i's input gradient to rank i - 1
                g_y = _shift(sched, g_x, me - 1, me, sched.out_shape, sched.out_dtype, device)
            m, g_x = t - me, None
            if not 0 <= m < n_micro:
                continue
            x, y = saved.pop(m)
            g = g_outs[m] if me == last else g_y
            inputs = ([x] if x.requires_grad else []) + wanted
            if not inputs:
                continue
            got = torch.autograd.grad(y, inputs, g.to(y.dtype), allow_unused=True)
            if x.requires_grad:
                g_x, got = got[0], got[1:]
                if g_x is None:
                    g_x = torch.zeros_like(x)
                if me == 0 and g_mbs is not None:
                    g_mbs[m] = g_x
            it = iter(got)
            for i, p in enumerate(p_in):
                if p.requires_grad:
                    gi = next(it)
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
        if g_mbs is not None:  # the microbatches are replicated: their gradient is a sum
            dist.all_reduce(g_mbs, group=ax.group)
        grads = [torch.zeros_like(p) if p.requires_grad and g is None else g
                 for p, g in zip(p_in, grads)]
        return (None, g_mbs, *grads)


def _run(stage, ax: Axis, mbs: torch.Tensor, params: list, boundaries: list) -> torch.Tensor:
    """The schedule over ``ax`` for this rank's ``stage(params, x)``;
    ``boundaries``: the (shape, dtype) per microbatch of every stage's input
    and of the last stage's output (n_stages + 1 entries)."""
    me = ax.index
    if ax.size == 1:
        return torch.stack([stage(params, x) for x in mbs])
    sizes = [math.prod(s) for s, _ in boundaries[1:-1]]
    buf_dtype = boundaries[1][1]
    for _, d in boundaries[2:-1]:
        buf_dtype = torch.promote_types(buf_dtype, d)
    sched = _Schedule(stage, ax, mbs.shape[0], *boundaries[me], *boundaries[me + 1],
                      *boundaries[-1], max(sizes), buf_dtype)
    return _GPipe.apply(sched, mbs, *params)


def _call(stage_fn, params, x):
    """``stage_fn`` applied with ``params``: a module through
    ``torch.func.functional_call``, else ``stage_fn(params, x)``."""
    if isinstance(stage_fn, nn.Module):
        return torch.func.functional_call(stage_fn, params, (x,))
    return stage_fn(params, x)


def pipeline_apply(stage_fn: Callable | nn.Module, stacked_params: Any, microbatches: torch.Tensor,
                   mesh=None, axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """Run ``y = stage_{n-1}(...stage_0(x))`` as an n-rank pipeline over the
    mesh's ``axis_name`` axis (``mesh``, when given, must be the process's
    mesh: `core.mesh.use_mesh`).

    ``stage_fn(params_i, x) -> y`` applies one stage and keeps the shape and
    dtype (or is a module, called through ``torch.func.functional_call``
    with ``params_i``, a dict of its parameter names). ``stacked_params``: a
    pytree whose leaves lead with ``n_stages`` (stage ``i``'s at index
    ``i``, `stack_stage_params`); each rank takes its row. ``microbatches``:
    ``[n_micro, mb, ...]``, the same on every rank; -> ``[n_micro, mb,
    ...]``, on every rank."""
    ax = _axis(mesh, axis_name)
    leaves, spec = pytree.tree_flatten(stacked_params)
    for leaf in leaves:
        if leaf.shape[0] != ax.size:
            raise ValueError(f"stacked params lead with {leaf.shape[0]} stages for a "
                             f"{ax.size}-device '{axis_name}' axis")
    rows = [leaf[ax.index] for leaf in leaves]

    def stage(params, x):
        return _call(stage_fn, pytree.tree_unflatten(params, spec), x)

    mb = (tuple(microbatches.shape[1:]), microbatches.dtype)
    return _run(stage, ax, microbatches, rows, [mb] * (ax.size + 1))


def stack_stage_params(params_list: list) -> Any:
    """Stack per-stage param pytrees on a new leading dim (stage index)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), params_list[0], *params_list[1:])


def _boundaries(stage_fns: Sequence, stage_params: Sequence, mb: torch.Tensor) -> list:
    """(shape, dtype) per microbatch of each stage's input and of the last
    stage's output, from the chain run on an empty microbatch (batch 0)."""
    out = [(tuple(mb.shape), mb.dtype)]
    x = mb[:0]
    with torch.no_grad():
        for f, p in zip(stage_fns, stage_params):
            x = f(p, x)
            out.append(((mb.shape[0], *x.shape[1:]), x.dtype))
    return out


def pipeline_hetero_apply(stage_fns: list, stage_params: list, microbatches: torch.Tensor,
                          mesh=None, axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """GPipe over heterogeneous stages (different parameters and activation
    shapes): ``stage_fns[i](stage_params[i], x) -> y`` takes and returns one
    tensor whose batch is dim 0; ``len(stage_fns) == len(stage_params) ==``
    the axis's size. Rank ``i`` runs stage ``i`` with its parameters (a
    pytree of tensors); every inter-stage activation rides a flat buffer
    sized to the largest boundary. ``microbatches``: ``[n_micro, mb, ...]``
    on every rank; -> the last stage's outputs ``[n_micro, mb, ...]`` on
    every rank."""
    ax = _axis(mesh, axis_name)
    n_stages = ax.size
    if len(stage_fns) != n_stages or len(stage_params) != n_stages:
        raise ValueError(
            f"{len(stage_fns)} stage_fns / {len(stage_params)} stage_params "
            f"for a {n_stages}-device '{axis_name}' axis")
    boundaries = _boundaries(stage_fns, stage_params, microbatches[0])
    fn = stage_fns[ax.index]
    leaves, spec = pytree.tree_flatten(stage_params[ax.index])

    def stage(params, x):
        return fn(pytree.tree_unflatten(params, spec), x)

    return _run(stage, ax, microbatches, leaves, boundaries)


@contextlib.contextmanager
def _inference_mode_bn(modules: nn.Module):
    """The modules in eval mode for the call (BN on its frozen statistics,
    updating none), their modes restored after."""
    modes = [(m, m.training) for m in modules.modules()]
    modules.eval()
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


class _ResNetStem(nn.Module):
    """NHWC images -> the stem's conv + BN + ReLU and its 3x3 max pool."""

    def __init__(self, conv1: nn.Module, bn1: nn.Module):
        super().__init__()
        self.conv1, self.bn1 = conv1, bn1

    def forward(self, x):
        return max_pool(conv_bn_act(self.conv1, self.bn1, x.permute(0, 3, 1, 2), "relu"), 3, 2,
                        padding=1)


class _ResNetTop(nn.Module):
    """Global average pool + ``fc``."""

    def __init__(self, fc: nn.Module):
        super().__init__()
        self.fc = fc

    def forward(self, x):
        return self.fc(global_avg_pool(x))


def resnet_stage_split(model: nn.Module, n_stages: int = 4):
    """Partition a zoo ResNet / ResNeXt (`models.classification.resnet`,
    ``including_top=True``) into heterogeneous pipeline stages at its
    residual stages: 4 segments = [stem + maxpool + layer1 (the JAX
    package's stage1), layer2, layer3, layer4 + pool + fc], grouped
    contiguously into ``n_stages`` (1, 2 or 4). Inference mode: BN runs on
    its frozen statistics and updates none (BN statistics cannot cross
    stages). -> (stage_fns, stage_params) for `pipeline_hetero_apply`;
    ``stage_params[i]`` maps the segment's parameter and buffer names to
    the model's own tensors (shared, not copied); the stages take NHWC
    images, as the model does."""
    if 4 % n_stages:
        raise ValueError(f"n_stages must divide the 4 segments, got {n_stages}")
    if not model.including_top:
        raise ValueError("pipeline split needs the single-output head "
                         "(including_top=True); pyramids have 3 outputs")
    segments = [[_ResNetStem(model.conv1, model.bn1), model.layer1], [model.layer2],
                [model.layer3], [model.layer4, _ResNetTop(model.fc)]]
    k = 4 // n_stages
    stage_fns, stage_params = [], []
    for i in range(n_stages):
        seg = nn.Sequential(*sum(segments[i * k:(i + 1) * k], []))

        def stage(sp, x, seg=seg):
            with _inference_mode_bn(seg):
                return torch.func.functional_call(seg, sp, (x,))

        stage_fns.append(stage)
        stage_params.append({**dict(seg.named_parameters()), **dict(seg.named_buffers())})
    return stage_fns, stage_params


def vit_stage_split(model: nn.Module, n_stages: int):
    """Partition a ViT's encoder (`models.classification.vit`) into
    ``n_stages`` stages of ``depth / n_stages`` consecutive blocks. ->
    (stage_fn, stacked_params) for `pipeline_apply`: ``stacked_params``
    maps ``b{j}.<block parameter>`` to the stages' tensors stacked on a
    leading ``n_stages`` dim (a stack of the model's, through which the
    gradient reaches them). `pipeline_vit_apply` runs the whole forward
    with each rank's own blocks, unstacked."""
    depth = len(model.blocks)
    if depth % n_stages:
        raise ValueError(f"ViT depth {depth} is not divisible into {n_stages} stages")
    k = depth // n_stages
    block = model.blocks[0]

    def stage_fn(stage_params, x):
        for j in range(k):
            x = torch.func.functional_call(
                block, {name: stage_params[f"b{j}.{name}"] for name, _ in
                        block.named_parameters()}, (x,))
        return x

    stages = [{f"b{j}.{name}": p for j in range(k)
               for name, p in model.blocks[i * k + j].named_parameters()}
              for i in range(n_stages)]
    return stage_fn, stack_stage_params(stages)


def pipeline_vit_apply(model: nn.Module, images: torch.Tensor, mesh=None, n_micro: int = 1,
                       axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """Full ViT forward (``images`` NHWC ``[B, H, W, 3]``, ``B`` divisible by
    ``n_micro``) with the encoder pipelined over ``axis_name``: the patch
    embedding, CLS token and position embedding (the prefix) and the final
    norm and head (the suffix) run on every rank; rank ``i`` runs blocks
    ``i * depth / n`` to ``(i + 1) * depth / n - 1``. Equals ``model(images)``
    up to float reassociation; the prefix's and suffix's parameters get the
    whole gradient on every rank. ``including_top=False`` returns the
    normed tokens (then ``images`` are NCHW, as the model takes them)."""
    ax = _axis(mesh, axis_name)
    depth = len(model.blocks)
    if depth % ax.size:
        raise ValueError(f"ViT depth {depth} is not divisible into {ax.size} stages")
    b = images.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    k = depth // ax.size
    x = images.permute(0, 3, 1, 2) if model.including_top else images
    x = model.patch_embed(x).flatten(2).transpose(1, 2)
    x = torch.cat([model.cls_token.expand(b, 1, model.dim).to(x.dtype), x], dim=1)
    x = x + model.pos_embed.to(x.dtype)
    mine = nn.Sequential(*model.blocks[ax.index * k:(ax.index + 1) * k])
    names = [n for n, _ in mine.named_parameters()]

    def stage(params, h):
        return torch.func.functional_call(mine, dict(zip(names, params)), (h,))

    mb = ((b // n_micro, *x.shape[1:]), x.dtype)
    y = _run(stage, ax, x.reshape(n_micro, b // n_micro, *x.shape[1:]),
             [p for _, p in mine.named_parameters()], [mb] * (ax.size + 1))
    x = model.norm(y.reshape(b, *x.shape[1:]))
    if not model.including_top:
        return x
    with torch.autocast(x.device.type, enabled=False):
        return model.head(x[:, 0].float())
