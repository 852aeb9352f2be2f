from .layers import (
    ACTIVATIONS,
    BatchNorm,
    BatchNorm3d,
    ConvBN,
    Dense,
    adaptive_avg_pool,
    global_avg_pool,
    init_weights_,
    max_pool,
    memory_format_for,
)

__all__ = ["ACTIVATIONS", "BatchNorm", "BatchNorm3d", "ConvBN", "Dense", "adaptive_avg_pool",
           "global_avg_pool", "init_weights_", "max_pool", "memory_format_for"]
