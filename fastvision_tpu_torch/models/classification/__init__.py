from .darknet53 import DarkResidual, Darknet53
from .vgg import CFGS, VGG, VGGClassifier

__all__ = ["DarkResidual", "Darknet53", "CFGS", "VGG", "VGGClassifier"]
