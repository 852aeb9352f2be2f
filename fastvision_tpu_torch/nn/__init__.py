from .layers import (
    ACTIVATIONS,
    BatchNorm,
    ConvBN,
    Dense,
    adaptive_avg_pool,
    global_avg_pool,
    init_weights_,
    max_pool,
)

__all__ = ["ACTIVATIONS", "BatchNorm", "ConvBN", "Dense", "adaptive_avg_pool", "global_avg_pool",
           "init_weights_", "max_pool"]
