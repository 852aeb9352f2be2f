from .layers import (
    ACTIVATIONS,
    BatchNorm,
    BatchNorm3d,
    ConvBN,
    Dense,
    Int8Conv,
    adaptive_avg_pool,
    conv_bn_act,
    conv_bn_pairs,
    global_avg_pool,
    init_weights_,
    max_pool,
    memory_format_for,
)

__all__ = ["ACTIVATIONS", "BatchNorm", "BatchNorm3d", "ConvBN", "Dense", "Int8Conv",
           "adaptive_avg_pool", "conv_bn_act", "conv_bn_pairs", "global_avg_pool",
           "init_weights_", "max_pool", "memory_format_for"]
