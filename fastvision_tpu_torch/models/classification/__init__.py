from .darknet53 import DarkResidual, Darknet53

__all__ = ["DarkResidual", "Darknet53"]
