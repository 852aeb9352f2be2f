"""loss_targets_ms.train: device milliseconds per traced step of the
kernels launched inside the ``loss.targets`` spans (the loss's target
assignment, one a level; it runs without gradient, so it has no
backward). Moves train_img_s."""
from harness.readers import range_ms


def read(run):
    return range_ms(run, "loss.targets")
