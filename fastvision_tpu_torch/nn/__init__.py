from .layers import ACTIVATIONS, BatchNorm, ConvBN, init_weights_, max_pool

__all__ = ["ACTIVATIONS", "BatchNorm", "ConvBN", "init_weights_", "max_pool"]
