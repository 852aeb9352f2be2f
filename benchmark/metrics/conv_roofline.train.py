"""conv_roofline.train: percent of the bfloat16 peak that the traced
steps' convolution kernels reach on the convolutions' counted FLOPs
(forward and backward). The kernels: those launched under the host
operations, or named, in benchmark/kernels/conv/. Moves train_img_s."""
from harness.readers import roofline


def read(run):
    return roofline(run, "conv", "conv")
