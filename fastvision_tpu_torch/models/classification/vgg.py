"""VGG conv trunk and its 4096-4096 MLP (port of
fastvision_tpu/models/classification/vgg.py).

Faster R-CNN uses the VGG16 trunk without its last max pool (stride 16) as
its backbone, and the MLP as the RoI head. Module names follow the JAX
package (``conv{i}`` for the i-th conv, ``fc1`` / ``fc2``), so the flax
variables bridge by name. Dropout draws no random numbers itself: the caller
passes the keep masks, drawn from its own ``torch.Generator``, so a run is
repeatable and a test can feed the JAX package's masks.

Not ported yet: the classification top (``including_top=True``: adaptive
average pool to 7x7, the MLP and ``fc3``), ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import ConvBN, max_pool

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
    """The VGG conv trunk on NCHW input: ``cfg`` from `CFGS`, ConvBN (BN
    with ``batch_norm``) + ReLU convs, 2x2 VALID max pools;
    ``drop_last_pool`` stops before the last pool (stride 16)."""

    def __init__(self, cfg: Sequence, batch_norm: bool = False, including_top: bool = True,
                 drop_last_pool: bool = False):
        super().__init__()
        if including_top:
            raise NotImplementedError(
                "VGG's classification top (adaptive_avg_pool, classifier, fc3) is not "
                "ported yet (ROADMAP Queue 1, item 13); pass including_top=False")
        self.cfg = tuple(cfg[:-1] if drop_last_pool else cfg)
        prev, i = 3, 0
        for v in self.cfg:
            if v != "M":
                setattr(self, f"conv{i}", ConvBN(prev, int(v), 3, 1, use_bn=batch_norm, act="relu"))
                prev, i = int(v), i + 1
        self.out_channels = prev

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool(x)
            else:
                x = getattr(self, f"conv{i}")(x)
                i += 1
        return x


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
