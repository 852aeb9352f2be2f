"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises: entry points
    never carry on silently on the CPU; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
