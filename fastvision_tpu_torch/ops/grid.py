"""Grid-cell offsets for anchor-based decoding (port of fastvision_tpu/ops/grid.py)."""
from __future__ import annotations

import torch


def grid(height: int, width: int, mode: str = "xy", dtype=torch.float32,
         device: torch.device | str | None = None) -> torch.Tensor:
    """Meshgrid of integer cell offsets, shape [height, width, 2], indexed
    [row, col, :]. ``mode='xy'`` puts the column offset first, ``'yx'`` the row."""
    ys = torch.arange(height, dtype=dtype, device=device)
    xs = torch.arange(width, dtype=dtype, device=device)
    oy, ox = torch.meshgrid(ys, xs, indexing="ij")
    if mode == "xy":
        return torch.stack([ox, oy], dim=-1)
    if mode == "yx":
        return torch.stack([oy, ox], dim=-1)
    raise ValueError("mode must be 'xy' or 'yx'")
