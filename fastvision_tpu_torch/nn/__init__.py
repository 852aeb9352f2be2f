from .layers import ACTIVATIONS, BatchNorm, ConvBN, init_weights_

__all__ = ["ACTIVATIONS", "BatchNorm", "ConvBN", "init_weights_"]
