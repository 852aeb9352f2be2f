"""Seeding (port of fastvision_tpu/core/rng.py).

The JAX package derives per-step keys with ``step_key(root, step)``; in the
port each consumer seeds its own ``torch.Generator`` from `step_seed` (seed,
step): Faster R-CNN's train step and `train.Fit`'s per-step generator for
dropout. The loaders seed numpy generators from (seed, epoch[, position]),
the mix transform from (seed, step). A run resumed at any step therefore
replays the same draws.
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


def step_seed(seed: int, step: int) -> int:
    """The generator seed of step ``step``: (seed, step) mixed."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
