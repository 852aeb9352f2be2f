"""Top-k accuracy (port of fastvision_tpu/ops/accuracy.py)."""
from __future__ import annotations

import numpy as np
import torch


def _hits(logits: torch.Tensor, labels: torch.Tensor, topk: int) -> torch.Tensor:
    """Bool [N]: the label is among the ``topk`` highest logits; ties go to
    the lower class index, as the JAX package's stable argsort orders them."""
    if topk == 1:
        return logits.argmax(dim=-1) == labels
    top = torch.argsort(-logits, dim=-1, stable=True)[:, :topk]
    return (top == labels[:, None]).any(dim=-1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk: int = 1) -> torch.Tensor:
    """logits [N, C], labels [N] -> top-k accuracy in [0, 1], a float32
    scalar on the logits' device."""
    return _hits(logits, torch.as_tensor(labels, device=logits.device), topk).float().mean()


class Accuracy:
    """Streaming top-k accuracy over batches on the host (the reference's
    class surface): ``acc(logits, labels)`` -> the batch's accuracy,
    ``fetch()`` -> the running one. Tensors (read back from any device) or
    arrays; ties in the top k are ordered by numpy's ``argsort``, as the
    JAX package orders them here."""

    def __init__(self, topk: int = 1):
        self.topk = topk
        self.correct = 0
        self.total = 0

    def __call__(self, logits, labels) -> float:
        logits, labels = (np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
                          for x in (logits, labels))
        if self.topk == 1:
            c = int((logits.argmax(-1) == labels).sum())
        else:
            top = np.argsort(-logits, axis=-1)[:, : self.topk]
            c = int((top == labels[:, None]).any(-1).sum())
        self.correct += c
        self.total += len(labels)
        return c / max(len(labels), 1)

    def fetch(self) -> float:
        return self.correct / max(self.total, 1)
