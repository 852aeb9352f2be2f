"""mfu.train: percent of the card's bfloat16 peak in the training window
(the reference's counted FLOPs of a step x steps / seconds). Moves
train_img_s."""
from harness.readers import mfu


def read(run):
    return mfu(run)
