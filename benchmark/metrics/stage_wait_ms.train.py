"""``stage_wait_ms.train``: the host's milliseconds a measured step waiting
on the last copy out of the pinned staging buffers: the program's
``stage_wait`` spans (``StepGraph._load``), read from the measured window
with no profiler."""
from benchmark import host_split


def read(r):
    return host_split.train_ms(r, "stage_wait")
