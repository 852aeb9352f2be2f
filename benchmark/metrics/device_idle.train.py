"""device_idle.train: percent of a traced training slice in which no
kernel, copy or set ran on the card. The slice is profiled on the card
alone (no host operations recorded), since the host's profiler slows each
launch of a launch-bound step and would read idle time the window does not
have. Moves train_img_s."""
from harness.readers import idle


def read(run):
    return idle(run)
