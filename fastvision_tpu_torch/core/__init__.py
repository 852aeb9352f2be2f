"""Core utilities of the port: config, seeding, checkpoints, telemetry, the
process group and the data-parallel mesh."""
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
from .distributed import initialize_multihost, process_info, set_visible_devices
from .mesh import (
    Mesh,
    MeshConfig,
    create_mesh,
    enable_compile_cache,
    local_batch_size,
    replicate,
    shard_batch,
    use_mesh,
)
from .rng import set_random_seeds, step_seed
from .telemetry import MetricLogger, span, trace

__all__ = [
    "CheckpointManager", "load_torch_state", "partial_load", "restore_inference_weights",
    "trainable_mask", "Config", "DataConfig", "ModelConfig", "NMSConfig", "TrainConfig",
    "apply_overrides", "from_yaml", "to_dict", "update_dataclass", "set_random_seeds", "step_seed",
    "MetricLogger", "span", "trace", "initialize_multihost", "process_info",
    "set_visible_devices", "Mesh", "MeshConfig", "create_mesh", "enable_compile_cache",
    "local_batch_size", "replicate", "shard_batch", "use_mesh",
]
