"""VGG 11/13/16/19 with and without BN, the conv trunk and the 4096-4096
MLP (port of fastvision_tpu/models/classification/vgg.py).

Faster R-CNN uses the VGG16 trunk without its last max pool (stride 16) as
its backbone, and the MLP (`VGGClassifier`) as the RoI head. Module names
follow the JAX package (``conv{i}`` for the i-th conv, ``fc1`` / ``fc2`` /
``fc3``), so the flax variables bridge by name.

The classifier (``including_top=True``) takes NHWC images [B, H, W, 3],
pools the last map to 7 x 7 with the JAX package's `adaptive_avg_pool`,
flattens it in (h, w, c) order, as the JAX package flattens NHWC, and runs
fc1 -> ReLU -> dropout -> fc2 -> ReLU -> dropout -> fc3. A torch VGG
checkpoint's fc1 reads a (c, h, w) flatten instead: its input columns are
re-interleaved on import (`models.import_torch.vgg_state_dict_from_torch`).
The trunk alone (``including_top=False``) takes and returns NCHW.

Dropout draws its keep masks from the ``generator`` the caller passes to
``forward`` (the train step's per-step generator), or takes given masks,
so a run is repeatable and a test can feed the JAX package's masks. In
train mode without either, the classifier raises, as flax's ``Dropout``
does without its rng.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import ConvBN, adaptive_avg_pool, init_weights_, max_pool

# stage channel plans; 'M' = 2x2 max pool (standard VGG configs A / B / D / E)
CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"),
}


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax ``Dropout`` with a given keep mask: kept entries scaled by
    1 / (1 - rate), the rest 0."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


class VGG(nn.Module):
    """``cfg`` from `CFGS`, ConvBN (BN with ``batch_norm``) + ReLU convs, 2x2
    VALID max pools; ``drop_last_pool`` stops before the last pool (stride
    16); ``including_top`` adds the classifier of ``num_classes``.
    ``generator`` seeds the initial weights."""

    def __init__(self, cfg: Sequence, batch_norm: bool = False, num_classes: int = 1000,
                 including_top: bool = True, drop_last_pool: bool = False,
                 dropout: float = 0.5, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = tuple(cfg[:-1] if drop_last_pool else cfg)
        prev, i = 3, 0
        for v in self.cfg:
            if v != "M":
                setattr(self, f"conv{i}", ConvBN(prev, int(v), 3, 1, use_bn=batch_norm, act="relu"))
                prev, i = int(v), i + 1
        self.out_channels = prev
        self.including_top = including_top
        self.dropout_rate = dropout
        if including_top:
            self.fc1 = nn.Linear(prev * 7 * 7, 4096)
            self.fc2 = nn.Linear(4096, 4096)
            self.fc3 = nn.Linear(4096, num_classes)
        init_weights_(self, generator)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x)
            else:
                x = getattr(self, f"conv{i}")(x)
                i += 1
        return x

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                keep_masks=None) -> torch.Tensor:
        if not self.including_top:
            return self.trunk(x)
        x = adaptive_avg_pool(self.trunk(x.permute(0, 3, 1, 2)), (7, 7))
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), the JAX package's order
        train_dropout = self.training and self.dropout_rate > 0
        if train_dropout and keep_masks is None:
            if generator is None:
                raise ValueError("VGG in train mode needs a generator (or keep_masks) for "
                                 "its dropout")
            keep_masks = [torch.rand((x.shape[0], 4096), generator=generator,
                                     device=generator.device) < 1.0 - self.dropout_rate
                          for _ in range(2)]
        for fc, i in ((self.fc1, 0), (self.fc2, 1)):
            x = F.relu(fc(x))
            if train_dropout:
                x = dropout(x, keep_masks[i], self.dropout_rate)
        return self.fc3(x)


class VGGClassifier(nn.Module):
    """The 4096-4096 MLP: fc1 -> ReLU -> dropout -> fc2 -> ReLU -> dropout.
    ``keep_masks`` (two bool masks of the hidden activations' shape) turn
    dropout on; None is the deterministic (eval) forward."""

    def __init__(self, in_features: int, hidden: int = 4096, dropout_rate: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.hidden = hidden
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, keep_masks=None) -> torch.Tensor:
        for fc, i in ((self.fc1, 0), (self.fc2, 1)):
            x = F.relu(fc(x))
            if keep_masks is not None:
                x = dropout(x, keep_masks[i], self.dropout_rate)
        return x


vgg11 = partial(VGG, CFGS["vgg11"], batch_norm=False)
vgg13 = partial(VGG, CFGS["vgg13"], batch_norm=False)
vgg16 = partial(VGG, CFGS["vgg16"], batch_norm=False)
vgg19 = partial(VGG, CFGS["vgg19"], batch_norm=False)
vgg11_bn = partial(VGG, CFGS["vgg11"], batch_norm=True)
vgg13_bn = partial(VGG, CFGS["vgg13"], batch_norm=True)
vgg16_bn = partial(VGG, CFGS["vgg16"], batch_norm=True)
vgg19_bn = partial(VGG, CFGS["vgg19"], batch_norm=True)
