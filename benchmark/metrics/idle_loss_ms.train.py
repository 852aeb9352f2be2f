"""idle_loss_ms.train: milliseconds per traced step in which the card sat
idle while the host's main thread was inside a ``step.loss`` span (the
loss's host work and the syncs in it), cut by overlap with the gaps of the
host-and-card slice. Moves train_img_s."""
from harness.spans import idle_in_span_ms


def read(run):
    return idle_in_span_ms(run, "step.loss")
