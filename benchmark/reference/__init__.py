"""The plain reference: float32 PyTorch and NumPy, nothing of the program.

A configuration's ``model`` names its file here, ``reference/<model>.py``,
which gives ``build(cfg)`` (the float32 model on the current default
device) and ``loss(pred, labels, cfg)``. A new model family is a new file.
"""
from harness.cells import by_model


def family(cfg: dict):
    return by_model("reference", cfg)


def build(cfg: dict):
    return family(cfg).build(cfg)
