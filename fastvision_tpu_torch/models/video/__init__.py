"""Video recognition zoo (names as in fastvision_tpu.models.video)."""
from .c3d import C3D, c3d, c3d_bn
from .resnet3d import (
    BasicBlock3D,
    Bottleneck3D,
    ResNet3D,
    resnet18_3d,
    resnet34_3d,
    resnet50_3d,
    resnet101_3d,
    resnet152_3d,
)
from .slowfast import (
    SFBottleneck,
    SlowFast,
    slowfast_resnet18,
    slowfast_resnet34,
    slowfast_resnet50,
    slowfast_resnet101,
    slowfast_resnet152,
)

__all__ = [
    "C3D", "c3d", "c3d_bn", "BasicBlock3D", "Bottleneck3D", "ResNet3D", "resnet18_3d",
    "resnet34_3d", "resnet50_3d", "resnet101_3d", "resnet152_3d", "SFBottleneck", "SlowFast",
    "slowfast_resnet18", "slowfast_resnet34", "slowfast_resnet50", "slowfast_resnet101",
    "slowfast_resnet152",
]
