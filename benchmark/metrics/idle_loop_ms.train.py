"""idle_loop_ms.train: milliseconds the card sat idle between the end of
one ``fit.step`` span and the start of the next (the loop's own work and
the wait for the batch), over the number of such stretches in the
host-and-card slice; the slice's start and end are left out. Moves
train_img_s."""
from harness.spans import idle_loop_ms


def read(run):
    return idle_loop_ms(run)
