"""``stage_copy_ms.train``: the host's milliseconds a measured step copying
a batch through the pinned staging buffers and queueing its copies: the
program's ``stage_copy`` spans (``StepGraph._load``), read from the
measured window with no profiler."""
from benchmark import host_split


def read(r):
    return host_split.train_ms(r, "stage_copy")
