"""Core utilities of the port: config, seeding, checkpoints, metric logging."""
from .checkpoint import (
    CheckpointManager,
    load_torch_state,
    partial_load,
    restore_inference_weights,
    trainable_mask,
)
from .config import (
    Config,
    DataConfig,
    ModelConfig,
    NMSConfig,
    TrainConfig,
    apply_overrides,
    from_yaml,
    to_dict,
    update_dataclass,
)
from .rng import set_random_seeds
from .telemetry import MetricLogger

__all__ = [
    "CheckpointManager", "load_torch_state", "partial_load", "restore_inference_weights",
    "trainable_mask", "Config", "DataConfig", "ModelConfig", "NMSConfig", "TrainConfig",
    "apply_overrides", "from_yaml", "to_dict", "update_dataclass", "set_random_seeds",
    "MetricLogger",
]
