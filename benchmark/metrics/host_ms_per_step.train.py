"""``host_ms_per_step.train``: the host's milliseconds inside each forward_backward (staging, replay launch), over the window's steps."""
from benchmark import readers


def read(r):
    return readers.host_ms(r, "train")
