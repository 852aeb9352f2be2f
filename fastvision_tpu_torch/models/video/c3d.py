"""C3D (port of fastvision_tpu/models/video/c3d.py): a VGG-style trunk of
3x3x3 convs for 16-frame 112 x 112 clips, ``c3d`` (biased convs, no BN) and
``c3d_bn`` (BN, no conv bias).

  - pool1 (1, 2, 2) keeps time; pools 2-5 are (2, 2, 2); pool5 pads H and W
    by 1 on both sides (-inf);
  - ``F.adaptive_avg_pool3d`` to (1, 4, 4), torch's adaptive windows, which
    the JAX package computes with averaging matrices (the identity at 112
    px; at 32 px pool5 gives 2 x 2 and the pool upsamples it to 4 x 4);
  - flatten in (c, t, h, w) order, torch's own NCDHW ``flatten(1)`` and the
    reference's: a reference checkpoint's fc6 loads unpermuted, and the
    bridge from the JAX package re-interleaves its (t, h, w, c) rows
    (`models.import_jax.c3d_state_dict_from_jax`);
  - fc6 -> ReLU -> dropout -> fc7 -> ReLU -> dropout -> fc8.

Dropout draws its keep masks from the ``generator`` the caller passes to
``forward`` (the train step's per-step generator), or takes given masks,
as VGG's does; in train mode without either it raises.

The ``state_dict`` keys are the reference's: ``layer{1..5}.{n}.conv`` for
the n-th module of a layer's Sequential (conv [, BN], ReLU per conv, then
the pool) and ``classifier.{0,3,6}``, so the JAX package's
``c3d_from_reference`` + ``apply_import`` load this model's weights.

Input: NDHWC clips [B, T, H, W, 3] -> logits [B, num_classes].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import BatchNorm3d, init_weights_
from ..classification.vgg import dropout
from .resnet3d import Conv

# each layer's conv widths and its pool: (window = stride, padding)
PLAN = (((64,), (1, 2, 2), (0, 0, 0)), ((128,), (2, 2, 2), (0, 0, 0)),
        ((256, 256), (2, 2, 2), (0, 0, 0)), ((512, 512), (2, 2, 2), (0, 0, 0)),
        ((512, 512), (2, 2, 2), (0, 1, 1)))


class C3D(nn.Module):
    """``generator`` seeds the initial weights: convs and Linears
    lecun-normal, biases 0 (flax's defaults)."""

    def __init__(self, num_classes: int = 101, batch_norm: bool = False, dropout: float = 0.5,
                 generator: torch.Generator | None = None):
        super().__init__()
        cin = 3
        for i, (widths, pool, pad) in enumerate(PLAN):
            mods: list[nn.Module] = []
            for c in widths:
                mods.append(Conv(cin, c, (3, 3, 3), bias=not batch_norm))
                mods += [BatchNorm3d(c)] if batch_norm else []
                mods.append(nn.ReLU())
                cin = c
            mods.append(nn.MaxPool3d(pool, pool, pad))
            setattr(self, f"layer{i + 1}", nn.Sequential(*mods))
        # the reference's Sequential indices: ReLU and dropout sit between
        # them, applied in forward with the step's generator
        self.classifier = nn.ModuleDict({"0": nn.Linear(512 * 4 * 4, 4096),
                                         "3": nn.Linear(4096, 4096),
                                         "6": nn.Linear(4096, num_classes)})
        self.dropout_rate = dropout
        init_weights_(self, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep_masks=None) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(1, 6):
            x = getattr(self, f"layer{i}")(x)
        x = F.adaptive_avg_pool3d(x, (1, 4, 4)).flatten(1)  # (c, t, h, w)
        train_dropout = self.training and self.dropout_rate > 0
        if train_dropout and keep_masks is None:
            if generator is None:
                raise ValueError("C3D in train mode needs a generator (or keep_masks) for "
                                 "its dropout")
            keep_masks = [torch.rand((x.shape[0], 4096), generator=generator,
                                     device=generator.device) < 1.0 - self.dropout_rate
                          for _ in range(2)]
        fc = self.classifier
        for i, name in enumerate(("0", "3")):
            x = F.relu(fc[name](x))
            if train_dropout:
                x = dropout(x, keep_masks[i], self.dropout_rate)
        return fc["6"](x)


def c3d(**kw) -> C3D:
    return C3D(batch_norm=False, **kw)


def c3d_bn(**kw) -> C3D:
    return C3D(batch_norm=True, **kw)
