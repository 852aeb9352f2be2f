"""data_wait_ms.train: milliseconds the host's main thread spent in
``data.wait`` (``prefetch_to_device`` handing out the next batch) per
step of the host-and-card slice, an epoch's first wait (the first
batch's pin and copy) and its last (the loader done) left out. Moves
train_img_s."""
from harness.spans import wait_ms


def read(run):
    return wait_ms(run)
