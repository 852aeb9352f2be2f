from .layers import (
    ACTIVATIONS,
    BatchNorm,
    BatchNorm3d,
    Carried,
    ConvBN,
    Dense,
    Int8Conv,
    adaptive_avg_pool,
    conv_bn_act,
    conv_bn_pairs,
    float_of,
    global_avg_pool,
    init_weights_,
    max_pool,
    memory_format_for,
)

__all__ = ["ACTIVATIONS", "BatchNorm", "BatchNorm3d", "Carried", "ConvBN", "Dense", "Int8Conv",
           "adaptive_avg_pool", "conv_bn_act", "conv_bn_pairs", "float_of", "global_avg_pool",
           "init_weights_", "max_pool", "memory_format_for"]
