"""Seeding (port of fastvision_tpu/core/rng.py).

The JAX package derives per-step keys with ``step_key(root, step)``; the port
has no counterpart: each consumer seeds its own ``torch.Generator`` from
(seed, step), as `train.frcnn_steps.step_seed` does, and the loader seeds
numpy generators from (seed, epoch[, position]). A run resumed at any step
therefore replays the same draws.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seeds(seed: int = 0) -> torch.Generator:
    """Seed the host's RNGs (python, numpy, torch's default generators) and
    return a ``torch.Generator`` seeded with ``seed``, the root of the run's
    explicit randomness (e.g. weight init)."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
