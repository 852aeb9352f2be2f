"""Classification zoo (names as in fastvision_tpu.models.classification)."""
from .darknet53 import DarkResidual, Darknet53, darknet53
from .resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
)
from .vgg import (
    CFGS,
    VGG,
    VGGClassifier,
    vgg11,
    vgg11_bn,
    vgg13,
    vgg13_bn,
    vgg16,
    vgg16_bn,
    vgg19,
    vgg19_bn,
)
from .vit import EncoderBlock, ViT, vit_base_patch16, vit_small_patch16, vit_tiny_patch16

__all__ = [
    "DarkResidual", "Darknet53", "darknet53", "BasicBlock", "Bottleneck", "ResNet", "resnet18",
    "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d", "resnext101_32x8d",
    "CFGS", "VGG", "VGGClassifier", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn", "vgg16",
    "vgg16_bn", "vgg19", "vgg19_bn", "EncoderBlock", "ViT", "vit_base_patch16",
    "vit_small_patch16", "vit_tiny_patch16",
]
