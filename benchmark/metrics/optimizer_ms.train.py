"""optimizer_ms.train: device milliseconds per traced step of the kernels
launched inside torch's ``Optimizer.step#...`` ranges. Moves train_img_s."""
from harness.readers import range_ms


def read(run):
    return range_ms(run, "Optimizer.step#")
