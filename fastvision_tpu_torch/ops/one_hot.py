"""One-hot encoding (port of fastvision_tpu/ops/one_hot.py)."""
from __future__ import annotations

import torch


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """Integer labels [...] -> one-hot [..., num_classes]; labels outside
    [0, num_classes) give an all-zero row."""
    labels = torch.as_tensor(labels)
    classes = torch.arange(num_classes, dtype=labels.dtype, device=labels.device)
    return (labels[..., None] == classes).to(dtype)
